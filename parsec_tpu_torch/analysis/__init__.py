"""Static analysis over the task-graph DSLs and the runtime itself.

The reference PTG compiler front-loads a battery of sanity checks over
the parsed JDF before emitting code (``jdf_sanity_checks``, jdf.c) —
mismatched flow endpoints, unused symbols, unguardable dataflow are
compile-time errors there. This package is that compile-time story, as
in the JAX package, plus two lints the reference never had:

- :mod:`.ptg_check` — the JDF dataflow verifier: endpoint existence and
  direction compatibility, arity, dependency reciprocity, unused
  globals/locals, statically-unsatisfiable guards, and CTL/data cycle
  detection by enumerating a small concrete instantiation
  (:mod:`.dagenum`) (PTG1xx).
- :mod:`.body_check` — the device-body linter: predicts, from the
  stdlib ``ast`` of ``BODY [type=cuda]`` code and DTD chore functions,
  what the device layer pays per class (``this_task`` reads withhold
  the batch spec, host syncs stall the stream and break whole-graph
  capture, nondeterminism, aliased same-tile args) (BDY2xx).
- :mod:`.lock_check` — the runtime concurrency lint: fields registered
  in a module's ``_GUARDED_BY`` map may only be touched while holding
  the declared lock, and no blocking call may run while holding an
  engine/data lock (LCK3xx).

``python -m parsec_tpu_torch.analysis`` (:mod:`.lint`) drives all three
over the port's shipped specs and the ``parsec_tpu_torch/`` tree;
``--strict`` turns any error/warn finding into a non-zero exit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

#: finding severities: ``error`` = the spec/source is wrong, ``warn`` =
#: suspicious or performance-degrading (both fail ``--strict``);
#: ``note`` = informational only (never fails a gate)
SEVERITIES = ("error", "warn", "note")


@dataclass
class Finding:
    """One analysis finding (the ``jdf_fatal``/``jdf_warn`` analog)."""

    code: str          # e.g. "PTG105"
    message: str
    where: str = ""    # "file:line task.flow" when known
    severity: str = "error"

    def __post_init__(self) -> None:
        assert self.severity in SEVERITIES, self.severity

    def __str__(self) -> str:
        loc = f"{self.where}: " if self.where else ""
        return f"{self.code} [{self.severity}] {loc}{self.message}"


def gate(findings: List["Finding"]) -> List["Finding"]:
    """The findings that fail a ``--strict`` run (errors + warnings)."""
    return [f for f in findings if f.severity in ("error", "warn")]


from .ptg_check import verify_jdf, verify_jdf_text  # noqa: E402
from .body_check import check_jdf_bodies, check_function  # noqa: E402
from .lock_check import lint_source, lint_file, lint_tree  # noqa: E402

__all__ = ["Finding", "gate", "SEVERITIES",
           "verify_jdf", "verify_jdf_text",
           "check_jdf_bodies", "check_function",
           "lint_source", "lint_file", "lint_tree"]
