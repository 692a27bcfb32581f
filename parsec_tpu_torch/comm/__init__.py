"""Communication: comm-engine abstraction, transports, remote-dep protocol
and the device data plane (SURVEY.md §2.4)."""
from .engine import (CommEngine, MemHandle, RankFailedError, TAG_ACTIVATE,
                     TAG_DTD_DATA, TAG_ELASTIC, TAG_GET_DATA, TAG_GET_REQ,
                     TAG_HEARTBEAT, TAG_SERVE, TAG_SERVE_REPLY, TAG_TERMDET,
                     TAG_USER_BASE)
from .local import LocalCommEngine, LocalFabric
from .mesh import MeshCommEngine, MeshFabric
from .tcp import TCPCommEngine, free_ports
from .remote_dep import RemoteDepEngine, bcast_children
from .xfer import DeviceDataPlane

__all__ = ["CommEngine", "MemHandle", "RankFailedError", "LocalFabric",
           "LocalCommEngine", "MeshFabric", "MeshCommEngine",
           "TCPCommEngine", "free_ports",
           "RemoteDepEngine", "bcast_children", "DeviceDataPlane",
           "TAG_ACTIVATE", "TAG_DTD_DATA", "TAG_GET_DATA", "TAG_GET_REQ",
           "TAG_ELASTIC", "TAG_HEARTBEAT", "TAG_SERVE", "TAG_SERVE_REPLY",
           "TAG_TERMDET", "TAG_USER_BASE"]
