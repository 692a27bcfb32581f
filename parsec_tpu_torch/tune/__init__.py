"""tune — closed-loop self-tuning.

The live health monitor (obs/live.py) *watches* the knobs this package
*turns*: a per-rank :class:`Controller` subscribes to the monitor's
window ticks and adapts three knob families at runtime —

- per-link quantized wire codec (lossless -> qbf16 -> qint8) within the
  ``tune_residual_budget``, escalating on bandwidth-bound links and
  de-escalating when compression shows no win, renegotiated live over
  the K_TUNE control frame toward "tn"-capable peers;
- device pipeline shape (``batch_max`` / ``prefetch_depth`` /
  ``flush_segments``), hill-climbed per device from batch occupancy,
  prefetch hit rate and the overlap fraction, with hysteresis and
  revert-on-regress against a us/task dispatch objective;
- stage-compile exclusion: a rank whose compiled stages keep
  straggling gets the dominant compiled class (from the context's live
  stage compilers, stagec/) appended to ``stage_compile_exclude``.

Everything lives behind the ``tune_auto`` MCA param: unset constructs
no controller, starts no subscription, and is bit-for-bit inert on the
wire.  Every adaptation emits a ``tune:*`` instant annotation on the
health trace stream plus the ``PARSEC::TUNE::*`` gauges.
"""
from .controller import (CODEC_COST, CODEC_LADDER, Controller,
                         register_tune_gauges)

__all__ = ["Controller", "CODEC_LADDER", "CODEC_COST",
           "register_tune_gauges"]
