"""xfer/: transfer backends of the device data plane (comm/xfer.py) and
the redistribution planner.

:mod:`.loopback` serves parked tiles over plain host sockets — the
backend of a context on the CPU (what the tests run); on the card the
plane uses CUDA IPC (comm/xfer.py). :mod:`.plan` compiles a whole-matrix
reshard into coalesced alltoall rounds instead of per-tile GET storms,
behind the ``xfer_collective_redist`` knob; unset, no code here runs.
"""
from .loopback import LoopbackTransferServer, start_transfer_server
from .plan import (PlannedRedistribution, RedistPlan, TAG_REDIST, Transfer,
                   build_plan, run_redistribution)

__all__ = ["LoopbackTransferServer", "start_transfer_server",
           "RedistPlan", "Transfer", "TAG_REDIST", "build_plan",
           "run_redistribution", "PlannedRedistribution"]
