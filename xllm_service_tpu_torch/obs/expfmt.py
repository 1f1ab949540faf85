"""Prometheus text-exposition parsing + structural validation.

A copy of the JAX package's ``obs/expfmt.py``: the same behaviour and
names, importing only this package (and no device code).

The read side of the registry: tests point ``validate_exposition`` at
both planes' ``/metrics`` bodies (every line must parse; histograms must
be internally consistent), and bench.py scrapes its latency percentiles
out of rendered histogram text with ``histogram_quantile`` — the same
arithmetic a Prometheus server would run, so the numbers a dashboard
shows and the numbers BENCH_*.json records cannot drift apart.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

# The one copy of the ``le``-bucket interpolation (``histogram_quantile``
# and the in-memory ``Histogram.quantile`` share it).
from xllm_service_tpu_torch.obs.metrics import quantile_from_buckets  # noqa: F401

_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_NAME_RE})(?:\{{(.*)\}})?\s+(\S+)(?:\s+(-?\d+))?$")
_LABEL_RE = re.compile(
    rf'({_NAME_RE})="((?:[^"\\]|\\.)*)"\s*(,|$)')
_COMMENT_RE = re.compile(
    rf"^#\s+(HELP|TYPE)\s+({_NAME_RE})(?:\s+(.*))?$")

Sample = Tuple[str, Dict[str, str], float]


def _unescape(v: str) -> str:
    """Left-to-right scan, one escape at a time — sequential
    str.replace passes mangle a literal backslash followed by ``n``
    (``\\\\n`` would lose its backslash to the ``\\n`` pass first)."""
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_value(s: str) -> float:
    if s in ("+Inf", "Inf"):
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)       # raises ValueError on garbage


def _parse_labels(raw: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ValueError(f"bad label pair at {raw[pos:pos + 30]!r}")
        labels[m.group(1)] = _unescape(m.group(2))
        pos = m.end()
    return labels


def parse_exposition(text: str
                     ) -> Tuple[List[Sample], Dict[str, str], List[str]]:
    """→ (samples, {family: declared type}, errors). Never raises:
    unparseable lines become error strings so a validator can report all
    of them at once."""
    samples: List[Sample] = []
    types: Dict[str, str] = {}
    errors: List[str] = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _COMMENT_RE.match(line)
            if m is None:
                errors.append(f"line {i}: malformed comment {line!r}")
            elif m.group(1) == "TYPE":
                types[m.group(2)] = (m.group(3) or "").strip()
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {i}: unparseable sample {line!r}")
            continue
        name, rawlabels, rawvalue = m.group(1), m.group(2), m.group(3)
        try:
            labels = _parse_labels(rawlabels) if rawlabels else {}
        except ValueError as e:
            errors.append(f"line {i}: {e}")
            continue
        try:
            value = _parse_value(rawvalue)
        except ValueError:
            errors.append(f"line {i}: bad value {rawvalue!r}")
            continue
        samples.append((name, labels, value))
    return samples, types, errors


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, v) for k, v in labels.items() if k != "le"))


def _histogram_families(samples: List[Sample],
                        types: Dict[str, str]) -> List[str]:
    fams = {n for n, t in types.items() if t == "histogram"}
    # Untyped expositions: infer from the _bucket suffix.
    for name, labels, _v in samples:
        if name.endswith("_bucket") and "le" in labels:
            fams.add(name[:-len("_bucket")])
    return sorted(fams)


def validate_exposition(text: str) -> List[str]:
    """Structural checks beyond line grammar: for every histogram
    family+label set, buckets are cumulative-monotone in ascending
    ``le``, a ``+Inf`` bucket exists and equals ``_count``, and ``_sum``
    is present. Returns all violations (empty == valid)."""
    samples, types, errors = parse_exposition(text)
    for fam in _histogram_families(samples, types):
        buckets: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        sums: Dict[Tuple, float] = {}
        for name, labels, value in samples:
            if name == fam + "_bucket" and "le" in labels:
                try:
                    le = _parse_value(labels["le"])
                except ValueError:
                    errors.append(f"{fam}: bad le {labels['le']!r}")
                    continue
                buckets.setdefault(_series_key(labels), []) \
                    .append((le, value))
            elif name == fam + "_count":
                counts[_series_key(labels)] = value
            elif name == fam + "_sum":
                sums[_series_key(labels)] = value
        for key, bs in buckets.items():
            tag = f"{fam}{dict(key)}"
            bs.sort(key=lambda p: p[0])
            cum = [v for _le, v in bs]
            if any(b > a for a, b in zip(cum[1:], cum)):
                errors.append(f"{tag}: bucket counts not monotone: {cum}")
            if not bs or not math.isinf(bs[-1][0]):
                errors.append(f"{tag}: no +Inf bucket")
            elif key not in counts:
                errors.append(f"{tag}: missing _count")
            elif counts[key] != bs[-1][1]:
                errors.append(
                    f"{tag}: _count {counts[key]} != +Inf bucket "
                    f"{bs[-1][1]}")
            if key not in sums:
                errors.append(f"{tag}: missing _sum")
        for key in counts:
            if key not in buckets:
                errors.append(f"{fam}{dict(key)}: _count with no "
                              f"buckets")
    return errors


def fraction_le_from_buckets(bs: List[Tuple[float, float]],
                             threshold: float) -> Optional[float]:
    """Fraction of observations ≤ ``threshold`` — the inverse of
    ``quantile_from_buckets``, with the same linear interpolation inside
    the containing bucket. ``bs`` is ``[(le, cumulative_count)]`` sorted
    ascending, ending with ``+Inf``. Mass in the ``+Inf`` bucket counts
    as ABOVE any finite threshold (the conservative reading). None on an
    empty series. This is the one copy of the SLO-attainment arithmetic:
    the live engine (obs/slo.py) and bench.py's scraped
    ``slo_*_attainment`` fields both run it."""
    if not bs or bs[-1][1] <= 0:
        return None
    total = bs[-1][1]
    prev_edge, prev_cum = 0.0, 0.0
    for le, cum in bs:
        if threshold <= le:
            if math.isinf(le):
                return prev_cum / total
            in_bucket = cum - prev_cum
            width = le - prev_edge
            frac = (threshold - prev_edge) / width if width > 0 else 1.0
            return (prev_cum + in_bucket * frac) / total
        prev_edge, prev_cum = le, cum
    return 1.0


def _series_buckets(text_or_samples, family: str,
                    labels: Optional[Dict[str, str]]
                    ) -> List[Tuple[float, float]]:
    if isinstance(text_or_samples, str):
        samples, _types, _errors = parse_exposition(text_or_samples)
    else:
        samples = text_or_samples
    want = _series_key(labels or {})
    bs: List[Tuple[float, float]] = []
    for name, slabels, value in samples:
        if name == family + "_bucket" and "le" in slabels \
                and _series_key(slabels) == want:
            bs.append((_parse_value(slabels["le"]), value))
    bs.sort(key=lambda p: p[0])
    return bs


def histogram_fraction_le(text_or_samples, family: str, threshold: float,
                          labels: Optional[Dict[str, str]] = None
                          ) -> Optional[float]:
    """Fraction of one scraped histogram series' observations ≤
    ``threshold`` (SLO attainment against a latency target). Series
    selection matches ``histogram_quantile``; None when the series is
    absent or empty."""
    return fraction_le_from_buckets(
        _series_buckets(text_or_samples, family, labels), threshold)


def histogram_quantile(text_or_samples, family: str, q: float,
                       labels: Optional[Dict[str, str]] = None
                       ) -> Optional[float]:
    """Estimate the q-quantile of one scraped histogram series.
    ``labels`` selects the series (``le`` excluded); None matches only
    the unlabeled series. Returns None when the series is absent or
    empty."""
    return quantile_from_buckets(
        _series_buckets(text_or_samples, family, labels), q)
