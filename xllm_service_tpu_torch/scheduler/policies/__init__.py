"""Load-balance policies (port of
``xllm_service_tpu/scheduler/policies/``): RR (round robin) and CAR
(cache-aware). SLO_AWARE is refused by the scheduler at start (ROADMAP
queue 1 item 23)."""

from .base import LoadBalancePolicy
from .round_robin import RoundRobinPolicy
from .cache_aware import CacheAwareRoutingPolicy

__all__ = ["LoadBalancePolicy", "RoundRobinPolicy", "CacheAwareRoutingPolicy",
           "create_policy"]


def create_policy(name: str, instance_mgr, kvcache_mgr, options):
    """Reference `scheduler.cpp:84-91` policy selection."""
    name = (name or "RR").upper()
    if name == "RR":
        return RoundRobinPolicy(instance_mgr)
    if name == "CAR":
        return CacheAwareRoutingPolicy(instance_mgr, kvcache_mgr, options)
    raise ValueError(f"unknown load balance policy: {name}")
