"""Round-robin policy (reference `round_robin.cpp:20-22` — delegates to
InstanceMgr's RR index)."""

from __future__ import annotations

from .base import LoadBalancePolicy
from ...common.request import Request
from ...common.types import Routing


class RoundRobinPolicy(LoadBalancePolicy):
    def __init__(self, instance_mgr):
        self._mgr = instance_mgr

    def select_instances_pair(self, request: Request) -> Routing:
        return self._mgr.get_next_instance_pair()
