"""Engine replica pool: an affinity-routed serving tier of several
engines with failover, rolling reload and the prefill -> decode split."""

from .health import HealthMonitor
from .pool import (REPLICA_ROLES, EnginePool, EngineReplica, PoolRecord,
                   partition_devices)
from .router import ReplicaRouter

__all__ = ["EnginePool", "EngineReplica", "PoolRecord", "HealthMonitor",
           "ReplicaRouter", "REPLICA_ROLES", "partition_devices"]
