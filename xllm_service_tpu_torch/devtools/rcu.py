"""RCU publication discipline: registry + opt-in deep-freeze detector.

Every hot path in the orchestration plane reads RCU-published state:
writers build a fresh immutable object under their writer lock and
install it with ONE reference swap; readers grab the reference once and
never lock. The bug class this invites — in-place mutation of a
published snapshot, copy-on-write skipped on one writer path,
delete/install ordered so readers see a half-pruned intermediate — is
the one the lock-free paths invite (compaction, copy-on-write apply,
`offloaded`-delta cancellation).
This module is the machine check, one layer up from ``make_lock``/
``XLLM_LOCK_DEBUG``:

**Registries** (statically cross-checked by xlint's rcu rules — both are
bidirectional, like ``FAULT_POINTS``/``SPAN_POINTS``):

- :data:`RCU_FROZEN_TYPES` — types whose instances are IMMUTABLE once
  published. xlint's ``rcu-frozen`` rule flags any mutation reachable
  from a published value anywhere in the tree.
- :data:`RCU_PUBLICATIONS` — the publication attributes themselves
  (``"Class.attr": "Type @ writer_lock"``). xlint's ``rcu-publish`` rule
  requires every write to be a single reference swap of a freshly built
  object under the declared writer lock; ``rcu-read`` requires
  registered hot-path readers to load the attribute exactly once.

**Runtime** (``XLLM_RCU_DEBUG=1``): :func:`publish` deep-freezes the
object being published — dicts/lists/sets are swapped for
mutation-raising views, registered types get a ``__setattr__``-raising
shadow subclass, recursively — so every existing chaos drill,
multimaster kill drill and tier-transition test doubles as a
snapshot-race detector. With the env var unset :func:`publish` returns
its argument unchanged (one module-global check — same disabled-path
cost as ``make_lock``).

**Escape hatch**: entry-level RCU writers (global_kvcache_mgr swaps
immutable ``_BlockLoc`` records inside the shared ``blocks`` dict — the
slot swap is atomic under the GIL) mutate through :func:`thaw`, which
requires a reason string exactly like an ``# xlint: allow-*(reason)``
comment. ``thaw`` is also the static hatch: xlint does not track a local
bound from ``rcu.thaw(...)`` as frozen.

Violations are recorded AND raised (:class:`RcuMutationError`): raising
pinpoints the mutating stack in the failing test; recording survives
broad-except swallowing — the pytest plugin
``xllm_service_tpu_torch.testing.debug_guard`` fails any test that
recorded one while debug mode is on, mirroring the instrumented-lock
guard.
"""

from __future__ import annotations

import os
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Optional

#: Types whose instances are immutable once published (RCU read views).
#: Key = class name (matched by name: the owning modules import this
#: module, not the other way around). xlint requires each to resolve to
#: a live class in the tree.
RCU_FROZEN_TYPES: dict[str, str] = {
    "RoutingSnapshot":
        "instance_mgr's fleet view: built under _cluster_lock, read "
        "lock-free by every schedule/bind/dispatch",
    "PrefixIndex":
        "global_kvcache_mgr's published index wrapper: match() walks it "
        "with no lock (entries swap via thaw, see module doc)",
    "_BlockLoc":
        "per-block location record: writers build a replacement and swap "
        "the index slot, never edit in place",
    "InstanceLoadInfo":
        "per-instance load view handed to CAR/SLO scoring off the "
        "published _load_infos dict",
}

#: Publication attributes: ``"Class.attr" -> "Type @ writer_lock"``.
#: ``Type`` names the published value's type (a registered frozen type,
#: or a builtin container like ``dict``/``tuple``); ``writer_lock`` is
#: the declared lock attribute (cross-checked against the lock registry)
#: under which the single reference swap must occur. Writes anywhere in
#: the tree are checked by xlint's ``rcu-publish`` rule; registered
#: hot-path readers by ``rcu-read``.
RCU_PUBLICATIONS: dict[str, str] = {
    "InstanceMgr._snapshot": "RoutingSnapshot @ _cluster_lock",
    "InstanceMgr._load_infos": "dict @ _metrics_lock",
    "InstanceMgr._request_load_view": "dict @ _metrics_lock",
    "GlobalKVCacheMgr._snapshot": "PrefixIndex @ _lock",
    "OwnershipRouter._members": "tuple @ _lock",
}

_DEBUG = os.environ.get("XLLM_RCU_DEBUG", "") not in ("", "0")


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    """Test hook: toggles freezing for publications made AFTER the call
    (already-published objects keep whatever mode they were built with —
    same contract as ``locks.set_debug``)."""
    global _DEBUG
    _DEBUG = on


class RcuMutationError(RuntimeError):
    """A published (deep-frozen) RCU snapshot was mutated in place."""


@dataclass
class RcuViolation:
    kind: str            # "frozen-mutation"
    message: str
    thread: str
    stack: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        return f"[{self.kind}] {self.message} (thread {self.thread})"


# Detector bookkeeping; never held across project locks.
_viol_lock = threading.Lock()   # lock-order: 902
_violations: list[RcuViolation] = []


def violations() -> list[RcuViolation]:
    with _viol_lock:
        return list(_violations)


def reset_violations() -> None:
    with _viol_lock:
        _violations.clear()


def _mutated(what: str, op: str) -> RcuMutationError:
    """Record a violation and build the error to raise. Recording happens
    even if a broad except swallows the raise — the debug-guard plugin still
    fails the test."""
    msg = (f"in-place {op} on published {what} — RCU snapshots are "
           f"immutable after publish; build a fresh object and swap the "
           f"reference (or mutate via rcu.thaw(..., reason) if this is a "
           f"declared entry-level-RCU writer)")
    v = RcuViolation(kind="frozen-mutation", message=msg,
                     thread=threading.current_thread().name,
                     stack=traceback.format_stack(limit=16)[:-2])
    with _viol_lock:
        _violations.append(v)
    return RcuMutationError(msg)


# ------------------------------------------------------------ frozen views
class FrozenDict(dict):
    """Published dict view: reads are native dict reads, mutators raise.
    ``rcu.thaw`` is the declared-writer escape hatch (it mutates through
    the ``dict`` base methods, which this subclass cannot intercept — by
    design)."""

    __slots__ = ()

    def _no(self, *a, **k):
        raise _mutated("dict", "mutation")

    __setitem__ = __delitem__ = _no
    pop = popitem = clear = update = setdefault = _no
    __ior__ = _no


class FrozenList(list):
    __slots__ = ()

    def _no(self, *a, **k):
        raise _mutated("list", "mutation")

    __setitem__ = __delitem__ = _no
    append = extend = insert = remove = sort = reverse = clear = pop = _no
    __iadd__ = __imul__ = _no


class FrozenSet(set):
    __slots__ = ()

    def _no(self, *a, **k):
        raise _mutated("set", "mutation")

    add = discard = remove = pop = clear = update = _no
    difference_update = intersection_update = _no
    symmetric_difference_update = _no
    __ior__ = __iand__ = __isub__ = __ixor__ = _no


_FROZEN_VIEWS = (FrozenDict, FrozenList, FrozenSet)

# Generated __setattr__-raising shadow subclasses for registered types.
_frozen_classes: dict[type, type] = {}


def _frozen_subclass(cls: type) -> type:
    sub = _frozen_classes.get(cls)
    if sub is None:
        def _setattr(self, name, value):
            raise _mutated(cls.__name__, f"attribute write ({name})")

        def _delattr(self, name):
            raise _mutated(cls.__name__, f"attribute delete ({name})")

        sub = type(f"Frozen{cls.__name__}", (cls,), {
            "__slots__": (), "__setattr__": _setattr,
            "__delattr__": _delattr})
        _frozen_classes[cls] = sub
    return sub


def _slot_names(cls: type) -> Iterator[str]:
    for c in cls.__mro__:
        slots = getattr(c, "__slots__", ())
        if isinstance(slots, str):
            slots = (slots,)
        yield from slots


def _freeze_object(obj: Any) -> Any:
    """Shadow a registered-type instance with its frozen subclass:
    allocated without __init__, fields copied (deep-frozen). isinstance
    checks against the original class still pass."""
    cls = type(obj)
    if cls in _frozen_classes.values():
        return obj   # already frozen
    sub = _frozen_subclass(cls)
    out = object.__new__(sub)
    seen = set()
    for name in _slot_names(cls):
        if name in seen or name.startswith("__"):
            continue
        seen.add(name)
        try:
            object.__setattr__(out, name, freeze(getattr(obj, name)))
        except AttributeError:
            continue   # slot declared but never assigned
    d = getattr(obj, "__dict__", None)
    if d is not None:
        for name, value in d.items():
            object.__setattr__(out, name, freeze(value))
    return out


def freeze(value: Any) -> Any:
    """Deep-freeze a value: builtin containers become mutation-raising
    views, registered RCU types become ``__setattr__``-raising shadows;
    everything else (including deliberately-shared mutable leaves like
    ``_Entry``) passes through untouched. Idempotent."""
    t = type(value)
    if t in _FROZEN_VIEWS:
        return value
    # The ownership verifier's guarded views (devtools/ownership.py)
    # freeze as their base container — a drained/published guarded list
    # must still deep-freeze (the in-place delta bug class) when both detectors
    # are armed.
    guarded = getattr(t, "_xllm_guarded_kind", None)
    if t is dict or guarded == "dict":
        return FrozenDict({k: freeze(v) for k, v in value.items()})
    if t is list or guarded == "list":
        return FrozenList(freeze(v) for v in value)
    if t is set or guarded == "set":
        return FrozenSet(value)   # elements are hashable ⇒ immutable
    if t is tuple:
        frozen = tuple(freeze(v) for v in value)
        if all(a is b for a, b in zip(frozen, value)):
            return value   # no mutable children — keep the original
        return frozen
    if t.__name__ in RCU_FROZEN_TYPES or t in _frozen_classes.values():
        return _freeze_object(value)
    return value


def publish(obj: Any, label: str = "") -> Any:
    """Publication wrapper for RCU reference swaps:
    ``self._snapshot = rcu.publish(RoutingSnapshot(...))``.

    Passthrough (identity) when ``XLLM_RCU_DEBUG`` is unset; deep-frozen
    via :func:`freeze` when set. ``label`` is documentation only."""
    if not _DEBUG:
        return obj
    return freeze(obj)


# ------------------------------------------------------------ escape hatch
class _ThawedDict:
    """Mutable view over a FrozenDict for DECLARED entry-level-RCU
    writers (mutations route through the ``dict`` base methods). Reads
    delegate so writer code is oblivious to the wrapper."""

    __slots__ = ("_d",)

    def __init__(self, d: dict):
        self._d = d

    # reads
    def __getitem__(self, k):
        return self._d[k]

    def __contains__(self, k):
        return k in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def get(self, k, default=None):
        return self._d.get(k, default)

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    # writes (through the base class, bypassing the frozen overrides)
    def __setitem__(self, k, v):
        dict.__setitem__(self._d, k, v)

    def __delitem__(self, k):
        dict.__delitem__(self._d, k)

    def pop(self, k, *default):
        return dict.pop(self._d, k, *default)

    def setdefault(self, k, default=None):
        return dict.setdefault(self._d, k, default)

    def update(self, *a, **k):
        dict.update(self._d, *a, **k)

    def clear(self):
        dict.clear(self._d)


def thaw(container: Any, reason: str) -> Any:
    """Escape hatch for declared entry-level-RCU writers: a mutable view
    of a frozen container. ``reason`` is mandatory (the runtime mirror of
    ``# xlint: allow-*(reason)``); xlint's ``rcu-frozen`` rule does not
    track a local bound from ``rcu.thaw(...)`` as frozen, and flags a
    call with a missing/empty reason. Passthrough when the container is
    not frozen (i.e. always, in production mode)."""
    if not reason or not isinstance(reason, str):
        raise ValueError("rcu.thaw requires a non-empty reason string")
    if isinstance(container, FrozenDict):
        return _ThawedDict(container)
    return container
