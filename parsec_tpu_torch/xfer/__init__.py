"""xfer/: transfer backends of the device data plane (comm/xfer.py).

:mod:`.loopback` serves parked tiles over plain host sockets — the
backend of a context on the CPU (what the tests run); on the card the
plane uses CUDA IPC (comm/xfer.py).
"""
from .loopback import LoopbackTransferServer, start_transfer_server

__all__ = ["LoopbackTransferServer", "start_transfer_server"]
