"""Cross-worker coordination primitives (a copy of the JAX package's
``coordination/``; stdlib only).

The same contracts as Redis pub/sub, ``SET NX EX`` leases and keys, as
small interfaces with in-tree backends:

- ``memory``: one asyncio process;
- ``file``: a shared directory (sqlite message log, sqlite leases, one
  JSON file per key) for N workers on one host;
- ``tcp``: the coordination hub (``hub.py``), across hosts.

``rpc.py`` carries calls and ordered streams between workers over a bus,
and ``heartbeat.py`` holds the ``worker:<id>`` lease that its liveness
check reads.
"""

from .bus import EventBus, MemoryEventBus, FileEventBus, make_bus
from .leases import LeaseManager, MemoryLeaseManager, FileLeaseManager, LeaderElector, make_lease_manager

__all__ = [
    "EventBus", "MemoryEventBus", "FileEventBus", "make_bus",
    "LeaseManager", "MemoryLeaseManager", "FileLeaseManager", "LeaderElector",
    "make_lease_manager",
]
