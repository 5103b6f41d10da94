"""Deterministic fault injection (copy of
``xllm_service_tpu/common/faults.py``), with the engine's two fault
points:

=====================  ==================================================
point                  where it is checked
=====================  ==================================================
``kv_transfer.offer``  ``engine/kv_transfer.py``, the prefill-side offer
                       (device and streamed paths)
``kv_transfer.pull``   ``engine/kv_transfer.py``, the decode-side pull
                       (device and streamed paths)
=====================  ==================================================

A :class:`FaultRule` names a point (a glob), an action, and when it fires:
``match`` narrows by the call site's context, ``after`` skips the first N
matching hits, ``max_fires`` bounds the fires, ``probability`` draws from
the plane's one seeded ``random.Random`` (seed ``XLLM_CHAOS_SEED``, default
0), so a fixed seed replays the same fault schedule. :meth:`FaultPlane.
check` sleeps on ``delay`` and raises :class:`FaultInjected` on ``error``
or ``drop``; a fired rule also lands as an event on the calling thread's
active span.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from random import Random
from typing import Any, Iterable, Optional

logger = logging.getLogger(__name__)

#: Actions understood by at least one fault point.
ACTIONS = ("error", "drop", "delay", "disconnect", "crash", "silence")

FAULT_POINTS: dict[str, str] = {
    "kv_transfer.offer": "engine/kv_transfer.py prefill-side offer",
    "kv_transfer.pull": "engine/kv_transfer.py decode-side pull",
}


class FaultInjected(RuntimeError):
    """Raised at a fault point whose matched rule demands a failure."""

    def __init__(self, point: str, rule: "FaultRule"):
        super().__init__(f"fault injected at {point}: {rule.action}")
        self.point = point
        self.rule = rule


@dataclass
class FaultRule:
    """One scripted fault. `point` may be a glob (``kv_transfer.*``);
    `match` narrows by call-site context (e.g. ``{"sid": "req-1"}``);
    `after` skips the first N matching hits; `max_fires` bounds how often
    the rule fires."""

    point: str
    action: str = "error"
    probability: float = 1.0
    delay_s: float = 0.0
    after: int = 0
    max_fires: Optional[int] = None
    match: dict[str, Any] = field(default_factory=dict)
    hits: int = 0
    fires: int = 0

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultRule":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


class FaultPlane:
    """Thread-safe registry of fault rules with a seeded RNG."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = int(os.environ.get("XLLM_CHAOS_SEED", "0"))
        self.seed = seed
        self._lock = threading.Lock()
        self._rng = Random(seed)
        self._rules: list[FaultRule] = []

    def configure(self, rules: Iterable[Any] = (),
                  seed: Optional[int] = None) -> None:
        """Replace all rules (and reseed). Takes FaultRule instances or
        plain dicts."""
        parsed = [r if isinstance(r, FaultRule) else FaultRule.from_dict(r)
                  for r in rules]
        with self._lock:
            if seed is not None:
                self.seed = seed
            self._rng = Random(self.seed)
            self._rules = parsed

    def add(self, point: str, **kw: Any) -> FaultRule:
        rule = FaultRule(point=point, **kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return list(self._rules)

    def fire(self, point: str, **ctx: Any) -> Optional[FaultRule]:
        """The first rule that fires at `point` (counters advanced), or
        None. Callers enact its action."""
        if not self._rules:   # the plane is almost always empty
            return None
        fired: Optional[FaultRule] = None
        with self._lock:
            for rule in self._rules:
                if rule.point != point and \
                        not fnmatch.fnmatchcase(point, rule.point):
                    continue
                if any(str(ctx.get(k)) != str(v)
                       for k, v in rule.match.items()):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.max_fires is not None and \
                        rule.fires >= rule.max_fires:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                rule.fires += 1
                fired = rule
                break
        if fired is not None:
            logger.info("fault fired at %s: %s (ctx=%s)",
                        point, fired.action, ctx)
            from . import tracing

            tracing.add_event("fault", point=point, action=fired.action)
        return fired

    def check(self, point: str, **ctx: Any) -> None:
        """For I/O call sites: sleep on `delay`, raise FaultInjected on
        `error`/`drop`, ignore actions the site does not model."""
        rule = self.fire(point, **ctx)
        if rule is None:
            return
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.action in ("error", "drop"):
            raise FaultInjected(point, rule)


#: The process's plane; empty by default (one attribute read a point).
FAULTS = FaultPlane()
