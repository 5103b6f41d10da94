"""Counters, gauges and histograms with Prometheus text export (copy of
the instruments of ``xllm_service_tpu/common/metrics.py`` and its two
engine-agent families).

Instruments may declare ``labelnames``; a call site then takes a child
series with ``.labels(peer=...)`` (every declared label, by keyword) and
the family renders each child with escaped label pairs in declared order
(``_bucket`` lines put ``le`` first). Reads take the lock the writers
take, so a histogram's buckets, sum and count render consistently.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Any, Iterable, Optional


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(pairs: Iterable[tuple[str, str]]) -> str:
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}" if inner else ""


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        # Set on children made by labels(); () on families and plain series.
        self._labelvalues: tuple[str, ...] = ()
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _label_suffix(self,
                      extra: Optional[tuple[str, str]] = None) -> str:
        pairs: list[tuple[str, str]] = [extra] if extra else []
        pairs += list(zip(self.labelnames, self._labelvalues))
        return _render_labels(pairs)

    def _child_key(self, kw: dict[str, Any]) -> tuple[str, ...]:
        if not self.labelnames:
            raise ValueError(
                f"metric {self.name} declares no labels; call inc()/set()/"
                f"observe() directly")
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} requires exactly labels "
                f"{self.labelnames}, got {tuple(sorted(kw))}")
        return tuple(str(kw[k]) for k in self.labelnames)

    def _new_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def labels(self, **kw: Any):
        key = self._child_key(kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child.labelnames = self.labelnames
                child._labelvalues = key
                self._children[key] = child
            return child

    def remove(self, **kw: Any) -> None:
        """Drop one child series, so the exposition stops exporting a label
        set whose subject is gone (use :func:`evict_series`)."""
        key = self._child_key(kw)
        with self._lock:
            self._children.pop(key, None)

    def _check_unlabeled(self, op: str) -> None:
        if self.labelnames and not self._labelvalues:
            raise ValueError(f"metric {self.name} is labeled; use "
                             f".labels(...).{op}()")


class _Scalar(_Metric):
    def __init__(self, name: str, help_: str = "",
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_, labelnames)
        self._v = 0.0

    def inc(self, v: float = 1.0) -> None:
        self._check_unlabeled("inc")
        with self._lock:
            self._v += v

    def value(self) -> float:
        """Plain series: its value. Labeled family: the sum over children."""
        with self._lock:
            v = self._v
            children = list(self._children.values())
        return v + sum(c.value() for c in children)

    def render(self) -> str:
        with self._lock:
            v = self._v
            children = sorted(self._children.items())
        if self.labelnames and not self._labelvalues:
            return "".join(c.render() for _, c in children)
        return f"{self.name}{self._label_suffix()} {v}\n"


class Counter(_Scalar):
    kind = "counter"


class Gauge(_Scalar):
    kind = "gauge"

    def set(self, v: float) -> None:
        self._check_unlabeled("set")
        with self._lock:
            self._v = float(v)


_DEFAULT_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
                    10000, 30000)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS,
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_, labelnames)
        self.buckets = sorted(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets)

    def observe(self, v: float) -> None:
        self._check_unlabeled("observe")
        with self._lock:
            self._counts[bisect_right(self.buckets, v)] += 1
            self._sum += v
            self._n += 1

    def count(self) -> int:
        with self._lock:
            n = self._n
            children = list(self._children.values())
        return n + sum(c.count() for c in children)

    def mean(self) -> float:
        with self._lock:
            s, n = self._sum, self._n
            children = list(self._children.values())
        for c in children:
            with c._lock:
                s += c._sum
                n += c._n
        return s / n if n else 0.0

    def render(self) -> str:
        with self._lock:
            counts = list(self._counts)
            total_sum, total_n = self._sum, self._n
            children = sorted(self._children.items())
        if self.labelnames and not self._labelvalues:
            return "".join(c.render() for _, c in children)
        out = []
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f"{self.name}_bucket"
                       f"{self._label_suffix(('le', str(b)))} {cum}\n")
        cum += counts[-1]
        out.append(f"{self.name}_bucket"
                   f"{self._label_suffix(('le', '+Inf'))} {cum}\n")
        out.append(f"{self.name}_sum{self._label_suffix()} {total_sum}\n")
        out.append(f"{self.name}_count{self._label_suffix()} {total_n}\n")
        return "".join(out)


def evict_series(metric: _Metric, **labels: Any) -> None:
    """Drop one labeled child series when its subject goes away (a PD peer
    unlinked, the heartbeat master changed), so a long-lived engine's
    exposition stays bounded."""
    metric.remove(**labels)


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help_, labelnames), Counter,
            labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, help_, labelnames), Gauge, labelnames)

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS,
                  labelnames: Iterable[str] = ()) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_, buckets, labelnames),
            Histogram, labelnames)

    def _get_or_create(self, name, factory, cls, labelnames=()):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as "
                                f"{type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise TypeError(
                    f"metric {name} already registered with labels "
                    f"{m.labelnames}, not {tuple(labelnames)}")
            return m

    def render_prometheus(self) -> str:
        parts = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                parts.append(f"# HELP {m.name} {m.help}\n")
            parts.append(f"# TYPE {m.name} {m.kind}\n")
            parts.append(m.render())
        return "".join(parts)


#: The process's registry and the engine agent's labeled families (its
#: ``/metrics`` appends their render to the ``engine_*`` text). Each is
#: evicted when its subject goes: ENGINE_PEER_LINKED on a PD unlink,
#: ENGINE_HEARTBEATS_TOTAL when the heartbeat master changes.
REGISTRY = MetricsRegistry()
ENGINE_PEER_LINKED = REGISTRY.gauge(
    "engine_peer_linked",
    "PD peers currently linked to this engine agent (1 per live link)",
    labelnames=("peer",))
ENGINE_HEARTBEATS_TOTAL = REGISTRY.counter(
    "engine_heartbeats_total",
    "Heartbeats this agent pushed, by destination master",
    labelnames=("master",))
