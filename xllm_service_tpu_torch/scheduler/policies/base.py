"""Policy interface (reference `loadbalance_policy.h:24-33`)."""

from __future__ import annotations

import abc

from ...common.request import Request
from ...common.types import Routing


class LoadBalancePolicy(abc.ABC):
    @abc.abstractmethod
    def select_instances_pair(self, request: Request) -> Routing:
        """Choose the (prefill, decode) pair for a request. An empty Routing
        means no schedulable instances."""
