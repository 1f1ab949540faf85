"""Device-plane step flight recorder and roofline/MFU attribution: the
JAX package's ``obs/steptrace.py`` for this package.

- **Step records**: every engine iteration appends one record of the
  closed schema ``STEP_FIELDS`` (the JAX package's tuple) into a bounded
  ring: the step kind, the per-phase ms delta of the engine's phase
  ledger, the batch token mix, the ragged/split dispatch counts, the
  speculation outcome delta, the KV page and prefix-cache deltas, the
  request ids of the step, and the roofline verdict.
- **Roofline attribution**: the engine's ``roofline`` table (program ->
  variant key -> {"flops", "bytes", "tokens"}) comes from the analytic
  count of ``models/cost.py``, taken at warmup; this module owns the
  peak table (``XLLM_PEAK_FLOPS`` / ``XLLM_PEAK_BW_GBPS``, with
  device-kind defaults) and turns (step ledger, roofline) into a step's
  achieved FLOP/s, MFU, a compute-or-memory verdict and the debt: the
  measured step ms minus the modeled roofline floor.
- **Shipping**: the worker serves the ring on ``GET /admin/steptrace``
  and ships a bounded tail on every heartbeat (the sequence baseline
  commits only on an acknowledged beat, so an undelivered tail is sent
  again); the master's ``StepBooks`` holds the last records per instance
  for the cluster-merged ``/admin/timeline`` (``obs/timeline.py``).

``XLLM_STEPTRACE`` (default on) and ``XLLM_STEPTRACE_RING`` (default
512) are read once at import; with the flag off the worker's recording
path is one ``if enabled:`` branch and no record is built.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.utils.locks import make_lock

# The closed step-record schema (the JAX package's, field for field).
STEP_FIELDS: Tuple[str, ...] = (
    "seq",              # per-worker monotone step index (recorder-assigned)
    "t_wall",           # wall-clock END of the step (seconds, time.time)
    "model",            # model the iteration served
    "kind",             # prefill | decode | mixed | fault
    "step_ms",          # host wall time of the whole iteration
    "prefill_tokens",   # prompt tokens computed this step
    "decode_tokens",    # tokens sampled this step
    "prefill_windows",  # scheduled prefill window sizes (tuple of ints)
    "decode_deferred",  # prefill-first step deferred live decodes (bool)
    "ragged",           # served by the one-dispatch ragged program (bool)
    "attn_dispatches",  # attention-bearing device dispatches this step
    "members",          # request ids in the step's batch (tuple)
    "phases",           # {phase: ms} DELTA of the engine ledger this step
    "spec",             # {dispatches,hits,rollbacks} speculation delta
    "kv_usage",         # KV page pool utilization [0,1] after the step
    "pages_delta",      # free-page delta across the step (+freed/-taken)
    "cache_hit_tokens",  # prefix-cache hit-token delta this step
    "flops",            # modeled useful FLOPs of the step (roofline)
    "bytes",            # modeled bytes moved by the step (roofline)
    "mfu",              # achieved FLOP/s over the peak, this step
    "bound",            # roofline verdict: compute | memory | unknown
    "debt_ms",          # measured step ms − modeled roofline ms
)

_FIELD_SET = frozenset(STEP_FIELDS)


def _enabled_from_env() -> bool:
    return os.environ.get("XLLM_STEPTRACE", "1").strip() not in (
        "0", "false", "no")


def _ring_from_env() -> int:
    try:
        return max(16, int(os.environ.get("XLLM_STEPTRACE_RING", "512")))
    except ValueError:
        return 512


ENABLED = _enabled_from_env()
RING = _ring_from_env()

# Peaks for the roofline model, read once at import. 0 = resolve from
# the device kind.
try:
    PEAK_FLOPS_OVERRIDE = float(os.environ.get("XLLM_PEAK_FLOPS", "0"))
except ValueError:
    PEAK_FLOPS_OVERRIDE = 0.0
try:
    PEAK_BW_GBPS_OVERRIDE = float(
        os.environ.get("XLLM_PEAK_BW_GBPS", "0"))
except ValueError:
    PEAK_BW_GBPS_OVERRIDE = 0.0

# Dense bf16 peak FLOP/s and memory GB/s by device-kind substring. The
# H100 row is the H100 SXM data sheet (989 TFLOP/s dense bf16, 3.35
# TB/s HBM3), matched by ``torch.cuda.get_device_name()`` ("NVIDIA H100
# 80GB HBM3"). The CPU row is a round placeholder, so that the CPU tests
# run the whole arithmetic on visibly modeled numbers.
_CHIP_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("h100", 989e12, 3350.0),
    ("cpu", 1e11, 50.0),
)


def peaks_for(device_kind: str) -> Tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) for a device kind: the environment
    overrides first, then the table, then the CPU placeholder row."""
    flops = PEAK_FLOPS_OVERRIDE
    bw = PEAK_BW_GBPS_OVERRIDE * 1e9
    if flops > 0 and bw > 0:
        return flops, bw
    kind = (device_kind or "").lower()
    t_flops, t_bw = _CHIP_PEAKS[-1][1], _CHIP_PEAKS[-1][2]
    for tag, f, b in _CHIP_PEAKS:
        if tag in kind:
            t_flops, t_bw = f, b
            break
    return (flops if flops > 0 else t_flops,
            bw if bw > 0 else t_bw * 1e9)


class StepTrace:
    """Bounded per-worker ring of step records.

    ``record()`` assigns the monotone ``seq`` and checks the field names
    against the closed schema; readers get copies. The engine-loop
    writer and the HTTP and heartbeat readers share one lock."""

    def __init__(self, enabled: Optional[bool] = None,
                 ring: Optional[int] = None) -> None:
        self.enabled = ENABLED if enabled is None else bool(enabled)
        self.capacity = RING if ring is None else max(16, int(ring))
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self._lock = make_lock("obs.steptrace", 85)

    def record(self, **fields: Any) -> int:
        """Append one step record; returns its ``seq``. Unknown field
        names raise: the schema is closed."""
        unknown = set(fields) - _FIELD_SET
        if unknown:
            raise ValueError(
                f"unknown step-record fields {sorted(unknown)!r} — add "
                f"them to steptrace.STEP_FIELDS first (closed schema)")
        with self._lock:
            self._seq += 1
            fields["seq"] = self._seq
            fields.setdefault("t_wall", time.time())
            self._ring.append(fields)
            return self._seq

    def tail(self, n: int = 0, since_seq: int = 0,
             window_s: float = 0.0) -> List[Dict[str, Any]]:
        """Copies of the newest records, oldest first; optionally only
        those with ``seq > since_seq`` (the heartbeat tail) and/or within
        ``window_s`` of the newest record (the timeline pull)."""
        with self._lock:
            recs = [dict(r) for r in self._ring]
        if since_seq > 0:
            recs = [r for r in recs if r.get("seq", 0) > since_seq]
        if window_s > 0 and recs:
            horizon = recs[-1].get("t_wall", 0.0) - window_s
            recs = [r for r in recs if r.get("t_wall", 0.0) >= horizon]
        if n > 0:
            recs = recs[-n:]
        return recs

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class StepBooks:
    """Master-side per-instance step-record books, fed by heartbeat
    tails (``Heartbeat.steps``) — the fallback source for the merged
    timeline when a worker's ``/admin/steptrace`` pull fails. Bounded
    per instance; an instance's book is replaced record-by-record in
    seq order (re-shipped tails dedupe on seq)."""

    def __init__(self, per_instance: int = 256) -> None:
        self._cap = per_instance
        self._books: Dict[str, Deque[Dict[str, Any]]] = {}
        self._lock = make_lock("obs.stepbooks", 86)

    def ingest(self, instance: str, records: List[Dict[str, Any]]) -> None:
        if not records:
            return
        with self._lock:
            book = self._books.get(instance)
            if book is None:
                book = self._books[instance] = collections.deque(
                    maxlen=self._cap)
            have = {r.get("seq") for r in book}
            for r in records:
                if isinstance(r, dict) and r.get("seq") not in have:
                    book.append(r)

    def tail(self, instance: str, n: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            book = self._books.get(instance)
            recs = [dict(r) for r in book] if book else []
        recs.sort(key=lambda r: r.get("seq", 0))
        return recs[-n:] if n > 0 else recs

    def instances(self) -> List[str]:
        with self._lock:
            return sorted(self._books)


# ---------------------------------------------------------------------------
# Roofline arithmetic: (engine roofline table, step ledger) -> modeled
# step cost, MFU, bound verdict and debt.
# ---------------------------------------------------------------------------

def _median_variant(variants: Dict[str, Dict[str, float]]
                    ) -> Optional[Dict[str, float]]:
    rows = [v for v in variants.values()
            if v.get("flops", 0.0) > 0.0]
    if not rows:
        return None
    rows.sort(key=lambda v: v["flops"])
    return rows[len(rows) // 2]


def _nearest_prefill_variant(variants: Dict[str, Dict[str, float]],
                             tokens: int) -> Optional[Dict[str, float]]:
    """The captured prefill/ragged variant whose batch token count (B*T)
    is nearest the step's prompt-token load; the modeled cost scales
    from it."""
    best = None
    best_d = None
    for key, v in variants.items():
        if v.get("flops", 0.0) <= 0.0:
            continue
        toks = v.get("tokens", 0.0)
        if toks <= 0:
            continue
        d = abs(toks - tokens)
        if best_d is None or d < best_d:
            best, best_d = v, d
    return best


def estimate_step(roofline: Dict[str, Dict[str, Dict[str, float]]],
                  *, kind: str, prefill_tokens: int, decode_tokens: int,
                  batch_size: int, decode_steps: int,
                  ragged: bool) -> Dict[str, float]:
    """Modeled device cost of one engine iteration from the warmup
    roofline table: prefill cost scales linearly in prompt tokens from
    the nearest variant; decode cost is per burst (a decode dispatch
    runs the whole padded batch, so dead rows are paid: that is what the
    debt shows)."""
    flops = 0.0
    bytes_ = 0.0
    if prefill_tokens > 0:
        prog = "ragged" if ragged else "prefill"
        variants = roofline.get(prog) or roofline.get("prefill") or {}
        v = _nearest_prefill_variant(variants, prefill_tokens)
        if v is not None:
            scale = prefill_tokens / max(v.get("tokens", 1.0), 1.0)
            flops += v["flops"] * scale
            bytes_ += v.get("bytes", 0.0) * scale
    if decode_tokens > 0 and not (ragged and kind == "mixed"):
        variants = (roofline.get("decode_multi")
                    or roofline.get("decode") or {})
        v = _median_variant(variants)
        if v is not None:
            per_burst = max(batch_size, 1) * max(decode_steps, 1)
            bursts = max(1, -(-decode_tokens // per_burst))
            flops += v["flops"] * bursts
            bytes_ += v.get("bytes", 0.0) * bursts
    return {"flops": flops, "bytes": bytes_}


def attribute_step(roofline: Dict[str, Dict[str, Dict[str, float]]],
                   *, kind: str, step_ms: float, prefill_tokens: int,
                   decode_tokens: int, batch_size: int,
                   decode_steps: int, ragged: bool,
                   peak_flops: float, peak_bytes_s: float
                   ) -> Dict[str, Any]:
    """The per-step roofline verdict the recorder embeds: modeled flops
    and bytes, MFU (achieved FLOP/s over peak), compute or memory bound,
    and the debt: measured wall ms minus the modeled floor
    max(flops / peak_flops, bytes / peak_bw)."""
    cost = estimate_step(
        roofline, kind=kind, prefill_tokens=prefill_tokens,
        decode_tokens=decode_tokens, batch_size=batch_size,
        decode_steps=decode_steps, ragged=ragged)
    flops, bytes_ = cost["flops"], cost["bytes"]
    step_s = max(step_ms, 1e-6) / 1000.0
    mfu = (flops / step_s / peak_flops) if peak_flops > 0 else 0.0
    t_compute = flops / peak_flops if peak_flops > 0 else 0.0
    t_memory = bytes_ / peak_bytes_s if peak_bytes_s > 0 else 0.0
    if flops <= 0.0 and bytes_ <= 0.0:
        bound = "unknown"
    elif t_compute >= t_memory:
        bound = "compute"
    else:
        bound = "memory"
    modeled_ms = 1000.0 * max(t_compute, t_memory)
    return {
        "flops": flops,
        "bytes": bytes_,
        "mfu": round(mfu, 6),
        "bound": bound,
        "debt_ms": round(step_ms - modeled_ms, 3),
    }


def roofline_table(roofline: Dict[str, Dict[str, Dict[str, float]]],
                   peak_flops: float, peak_bytes_s: float
                   ) -> List[Dict[str, Any]]:
    """Flattened per-(program, variant) roofline rows for
    ``/admin/steptrace``: arithmetic intensity against the machine's
    ridge point decides each program's bound verdict."""
    ridge = (peak_flops / peak_bytes_s) if peak_bytes_s > 0 else 0.0
    rows: List[Dict[str, Any]] = []
    for prog in sorted(roofline):
        for key in sorted(roofline[prog]):
            v = roofline[prog][key]
            fl = v.get("flops", 0.0)
            by = v.get("bytes", 0.0)
            intensity = fl / by if by > 0 else 0.0
            rows.append({
                "program": prog, "variant": key,
                "flops": fl, "bytes": by,
                "intensity": round(intensity, 3),
                "bound": ("unknown" if fl <= 0 and by <= 0 else
                          "compute" if intensity >= ridge else
                          "memory"),
            })
    return rows


def flush_metrics(registry, model: str, roofline, last_mfu: float,
                  last_debt_ms: float, device_kind: str = "") -> None:
    """Scrape-time mirror of the roofline attribution into a worker
    registry: per-program/variant FLOPs and bytes gauges (the analytic
    count of ``models/cost.py``) and the last step's MFU and debt."""
    g_mfu = registry.gauge(
        "xllm_worker_step_mfu",
        "model FLOP utilization of the last engine step (modeled "
        "roofline FLOPs over wall time over the configured peak — "
        "XLLM_PEAK_FLOPS)", labelnames=("model",))
    g_mfu.set(last_mfu, model=model)
    registry.gauge(
        "xllm_worker_step_debt_ms",
        "last step's wall ms minus its modeled roofline floor",
        labelnames=("model",)).set(last_debt_ms, model=model)
    g_fl = registry.gauge(
        "xllm_worker_program_flops",
        "modeled FLOPs per program variant (models/cost.py, taken at "
        "warmup)",
        labelnames=("model", "program", "variant"))
    g_by = registry.gauge(
        "xllm_worker_program_bytes",
        "modeled bytes moved per program variant (models/cost.py)",
        labelnames=("model", "program", "variant"))
    for prog, variants in (roofline or {}).items():
        for key, v in variants.items():
            g_fl.set(v.get("flops", 0.0), model=model, program=prog,
                     variant=key)
            g_by.set(v.get("bytes", 0.0), model=model, program=prog,
                     variant=key)
    peak_flops, _ = peaks_for(device_kind)
    registry.gauge(
        "xllm_worker_peak_flops",
        "peak FLOP/s the MFU series is normalized by "
        "(XLLM_PEAK_FLOPS or the device-kind table)").set(peak_flops)
