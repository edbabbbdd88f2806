"""Cluster tier: N engine replicas behind the one-client API.

`ReplicaPool` owns the replicas, `PrefixAffinityRouter` places prompts
where their prefix KV already lives (least-loaded fallback), and
`HealthBoard` / `ReplicaFailure` define the failure model.  Most users
never import this package — `TurboClient.from_arch(..., replicas=N)` /
`TurboClient.simulated(..., replicas=N)` assemble a pool behind the
familiar handle API.
"""
from .health import DEAD, HEALTHY, HealthBoard, ReplicaFailure
from .pool import PooledHandle, ReplicaPool
from .router import PrefixAffinityRouter, ReplicaLoad, RouteDecision

__all__ = [
    "DEAD",
    "HEALTHY",
    "HealthBoard",
    "PooledHandle",
    "PrefixAffinityRouter",
    "ReplicaFailure",
    "ReplicaLoad",
    "ReplicaPool",
    "RouteDecision",
]
