"""Metrics core of both planes: Counter / Gauge / Histogram families
with label sets, rendered as Prometheus text.

A copy of the JAX package's ``obs/metrics.py``, with
``quantile_from_buckets`` (the JAX package keeps it in
``obs/expfmt.py``, which imports it from here in this package). The
exposition: ``# HELP`` / ``# TYPE`` headers, integers without a
trailing ``.0``, histograms as cumulative ``_bucket`` series ending in
``+Inf`` with ``_sum`` and ``_count``. Thread-safe: one lock per
registry. Each plane owns its registry (``Worker.obs``,
``HttpService.obs``); ``default_registry()`` serves single-plane
callers.

Two write paths coexist: live instrumentation (``Counter.inc``,
``Histogram.observe``) for events such as engine steps or requests, and
scrape-time mirroring (``Gauge.set``, ``Counter.set_total``) of state
another object owns (queue depths, KV usage, per-instance load),
refreshed by the ``/metrics`` handler before it renders. Unlike the JAX
package's, ``set_total`` refuses a total below the series' value.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from xllm_service_tpu_torch.utils.locks import make_rlock

# Log-spaced latency buckets (milliseconds): 1-2-5 per decade from 1 ms
# to 2 minutes.
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 20000.0, 50000.0, 120000.0)

_NAME_OK = "abcdefghijklmnopqrstuvwxyz" \
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0,
    shortest-repr floats otherwise, NaN and infinities spelled as the
    exposition format spells them."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def quantile_from_buckets(bs: List[Tuple[float, float]], q: float
                          ) -> Optional[float]:
    """The ``le``-bucket interpolation of Prometheus's
    ``histogram_quantile``: ``bs`` is ``[(le, cumulative_count)]``
    ascending, ending with the ``+Inf`` bucket. Samples past the last
    finite edge clamp to it; an empty series is None."""
    if not bs or bs[-1][1] <= 0:
        return None
    rank = q * bs[-1][1]
    prev_edge, prev_cum = 0.0, 0.0
    for le, cum in bs:
        if cum >= rank:
            in_bucket = cum - prev_cum
            if math.isinf(le):
                return prev_edge       # clamp to last finite edge
            frac = (rank - prev_cum) / in_bucket if in_bucket else 0.0
            return prev_edge + (le - prev_edge) * frac
        prev_edge, prev_cum = le, cum
    return prev_edge


class _Family:
    """One metric family: a name, a fixed labelname tuple, and a value
    per label set."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        if not name or any(c not in _NAME_OK for c in name) \
                or name[0].isdigit():
            raise ValueError(f"bad metric name {name!r}")
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = list(zip(self.labelnames, key)) + list(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
        return "{" + inner + "}"

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        for key, v in items:
            out.append(f"{self.name}{self._label_str(key)} {_fmt(v)}")

    def clear(self) -> None:
        """Drop every label set (scrape-time rebuilders: per-instance
        gauges whose members come and go with the cluster)."""
        with self._lock:
            self._series.clear()

    def remove(self, **labels: Any) -> None:
        with self._lock:
            self._series.pop(self._key(labels), None)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment {amount} < 0")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, total: float, **labels: Any) -> None:
        """Mirror a cumulative total kept elsewhere (an engine's
        lifetime count); a total below the current value is refused."""
        key = self._key(labels)
        with self._lock:
            if total < self._series.get(key, 0.0):
                raise ValueError(f"{self.name}: counter total {total} "
                                 f"below {self._series[key]}")
            self._series[key] = float(total)


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)


class _HistogramSeries:
    __slots__ = ("counts", "total", "sum")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.total = 0
        self.sum = 0.0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(registry, name, help, labelnames)
        if "le" in self.labelnames:
            raise ValueError(f"{name}: 'le' is reserved for buckets")
        bs = tuple(float(b) for b in
                   (buckets or DEFAULT_LATENCY_BUCKETS_MS))
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"{name}: buckets must strictly increase")
        self.buckets = bs

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistogramSeries(len(self.buckets))
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    s.counts[i] += 1
                    break
            s.total += 1
            s.sum += v

    def count(self, **labels: Any) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s.total if s is not None else 0

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        """Estimated q-quantile of one label set, by the same ``le``
        interpolation as the scrape side (``quantile_from_buckets``).
        None with no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        bs = self.cumulative(**labels)
        if bs is None or bs[-1][1] == 0:
            return None
        return quantile_from_buckets(bs, q)

    def set_counts(self, counts: Sequence[int], sum_value: float,
                   total: Optional[int] = None, **labels: Any) -> None:
        """Scrape-time mirror of a whole distribution another object
        owns (the profiler's books): ``counts`` per bucket
        (non-cumulative, one per edge), ``total`` with the samples past
        the last edge (default ``sum(counts)``)."""
        if len(counts) != len(self.buckets):
            raise ValueError(
                f"{self.name}: set_counts got {len(counts)} buckets, "
                f"family has {len(self.buckets)}")
        key = self._key(labels)
        n_total = int(sum(counts)) if total is None else int(total)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistogramSeries(len(self.buckets))
            s.counts = [int(c) for c in counts]
            s.total = n_total
            s.sum = float(sum_value)

    def cumulative(self, **labels: Any
                   ) -> Optional[List[Tuple[float, float]]]:
        """One label set's cumulative bucket counts as ``[(le, cum),
        ...]`` ending with the ``+Inf`` bucket (the shape
        ``quantile_from_buckets`` reads); None when never observed."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if s is None:
                return None
            counts = list(s.counts)
            total = s.total
        bs: List[Tuple[float, float]] = []
        cum = 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            bs.append((edge, float(cum)))
        bs.append((math.inf, float(total)))
        return bs

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = [(k, list(s.counts), s.total, s.sum)
                     for k, s in sorted(self._series.items())]
        for key, counts, total, ssum in items:
            cum = 0
            for edge, c in zip(self.buckets, counts):
                cum += c
                out.append(
                    f"{self.name}_bucket"
                    f"{self._label_str(key, (('le', _fmt(edge)),))} "
                    f"{cum}")
            out.append(
                f"{self.name}_bucket"
                f"{self._label_str(key, (('le', '+Inf'),))} {total}")
            out.append(f"{self.name}_sum{self._label_str(key)} "
                       f"{_fmt(ssum)}")
            out.append(f"{self.name}_count{self._label_str(key)} {total}")


class Registry:
    """A named, ordered set of metric families sharing one lock.
    Get-or-create accessors are idempotent and raise on a kind or
    labelname conflict."""

    def __init__(self) -> None:
        self._lock = make_rlock("obs.registry", 93)
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(self, name, help,
                                                 labelnames, **kwargs)
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind} "
                f"labels={tuple(labelnames)} (was {fam.kind} "
                f"labels={fam.labelnames})")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        fam = self._get_or_create(Histogram, name, help, labelnames,
                                  buckets=buckets)
        if buckets is not None and fam.buckets != tuple(
                float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} re-declared with buckets "
                f"{tuple(buckets)} (was {fam.buckets})")
        return fam

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            fams = list(self._families.values())
        out: List[str] = []
        for fam in fams:
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            fam.render(out)
        return "\n".join(out) + "\n"


_DEFAULT: Optional[Registry] = None


def default_registry() -> Registry:
    """The process-global registry of single-plane callers."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry()
    return _DEFAULT
