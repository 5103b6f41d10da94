"""Load-balance policies (port of
``xllm_service_tpu/scheduler/policies/``): RR (round robin, the
default), CAR (cache-aware), SLO_AWARE (predictive with dynamic PD
flipping)."""

from .base import LoadBalancePolicy
from .round_robin import RoundRobinPolicy
from .cache_aware import CacheAwareRoutingPolicy
from .slo_aware import SloAwarePolicy

__all__ = ["LoadBalancePolicy", "RoundRobinPolicy", "CacheAwareRoutingPolicy",
           "SloAwarePolicy", "create_policy"]


def create_policy(name: str, instance_mgr, kvcache_mgr, options):
    """Reference `scheduler.cpp:84-91` policy selection."""
    name = (name or "RR").upper()
    if name == "RR":
        return RoundRobinPolicy(instance_mgr)
    if name == "CAR":
        return CacheAwareRoutingPolicy(instance_mgr, kvcache_mgr, options)
    if name == "SLO_AWARE":
        return SloAwarePolicy(instance_mgr, options)
    raise ValueError(f"unknown load balance policy: {name}")
