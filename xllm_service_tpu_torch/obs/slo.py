"""SLO engine + anomaly detector: turn raw telemetry into judgment.

A copy of the JAX package's ``obs/slo.py``: the same behaviour and
names, importing only this package (and no device code).

The metrics registry makes latency measurable; this module answers
"are we meeting the SLO right now" and "is an instance misbehaving"
from those same measurements — no new instrumentation, only judgment
over snapshots of what the registry already records.

## SLO engine

Each objective is "``objective`` fraction of requests must be good",
where good means a latency sample under ``threshold_ms`` (ttft / e2e /
queue_wait) or a request that did not error (availability). The engine
keeps a time-stamped history of cumulative (good, total) counts and
evaluates each objective over two windows — a FAST window (~5 min;
pages quickly, noisy) and a SLOW window (~1 h; pages slowly, confident)
— as error-budget BURN RATES:

    bad_fraction(window) = 1 - good/total          (over the window delta)
    burn_rate(window)    = bad_fraction / (1 - objective)

burn 1.0 = consuming budget exactly as fast as the objective allows;
a breach opens when BOTH windows burn ≥ ``burn_open`` (the standard
multi-window guard: the fast window confirms it is happening NOW, the
slow window confirms it is not a blip) and closes when the fast window
drops back under ``burn_close``. Open/close transitions land in the
event log (``slo_breach_{open,close}``); current state is exported as
``xllm_slo_{attainment,burn_rate,breach}`` gauges and served at
``GET /admin/slo``.

Thresholds/windows come from ``XLLM_SLO_*`` env knobs (docs/FLAGS.md);
snapshots are produced by an injected callable so the engine itself
stays dependency-free and clock-injectable (unit tests drive it with a
fake clock and synthetic traffic).

## Anomaly detector (the watchdog's brain)

``AnomalyDetector.observe()`` consumes per-instance signals the service
plane already has — heartbeat age vs. deadline, the worker-shipped
recent ``xllm_worker_step_ms`` p99 vs. a rolling (EWMA) per-instance
baseline, KV-pool utilization — and maintains open anomalies per
(type, instance), emitting ``anomaly_{open,close}`` events and
exporting ``xllm_anomaly_active{type,instance}``. Signal GATHERING
happens in the service watchdog thread (http_service.py) outside any
obs lock; this class only judges.

Lock ranks (utils/locks.py table): ``obs.slo`` 78, ``obs.watchdog`` 79
— both may emit events (rank 80) and touch the registry (rank 93)
while held.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.obs.events import EventLog
from xllm_service_tpu_torch.utils.locks import make_lock

# Snapshot: objective name → (good_count, total_count), both cumulative.
Snapshot = Dict[str, Tuple[float, float]]

DEFAULT_TTFT_MS = 1000.0        # mirrors ServiceOptions.target_ttft_ms
DEFAULT_E2E_MS = 30000.0
DEFAULT_QUEUE_WAIT_MS = 5000.0
DEFAULT_ENCODE_MS = 2000.0      # EPD per-call vision-encode bound
DEFAULT_OBJECTIVE = 0.99        # 99% of requests good
DEFAULT_AVAILABILITY = 0.999
DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0
DEFAULT_TICK_S = 5.0


def _env_f(raw: Optional[str], default: float) -> float:
    """Parse an env value already read at the call site (the reads stay
    literal ``os.environ.get("XLLM_...")`` calls so the flag-registry
    xlint rule sees every one of them)."""
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass
class SloObjective:
    """One SLO: ``objective`` fraction of requests must be good."""

    name: str                   # "ttft" | "e2e" | "queue_wait" | "availability"
    objective: float            # target good fraction in (0, 1)
    threshold_ms: float = 0.0   # latency bound (0 for availability)


@dataclasses.dataclass
class SloConfig:
    objectives: List[SloObjective]
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    tick_s: float = DEFAULT_TICK_S
    burn_open: float = 1.0      # breach opens at/above this burn (both windows)
    burn_close: float = 1.0     # breach closes under this (fast window)

    @classmethod
    def from_env(cls, default_ttft_ms: float = DEFAULT_TTFT_MS
                 ) -> "SloConfig":
        """Build from ``XLLM_SLO_*`` knobs (docs/FLAGS.md). The TTFT
        threshold defaults to the routing layer's ``target_ttft_ms`` so
        the SLO the scheduler routes FOR is the SLO the engine judges
        AGAINST unless an operator splits them on purpose."""
        obj = _env_f(os.environ.get("XLLM_SLO_OBJECTIVE"),
                     DEFAULT_OBJECTIVE)
        return cls(
            objectives=[
                SloObjective("ttft", obj,
                             _env_f(os.environ.get("XLLM_SLO_TTFT_MS"),
                                    default_ttft_ms)),
                SloObjective("e2e", obj,
                             _env_f(os.environ.get("XLLM_SLO_E2E_MS"),
                                    DEFAULT_E2E_MS)),
                SloObjective("queue_wait", obj,
                             _env_f(os.environ.get(
                                 "XLLM_SLO_QUEUE_WAIT_MS"),
                                 DEFAULT_QUEUE_WAIT_MS)),
                # EPD encode latency (docs/EPD.md): judged from the
                # per-call tower durations workers ship in heartbeats
                # (xllm_service_encode_ms). No encode traffic → no
                # samples → the objective is vacuously green.
                SloObjective("encode", obj,
                             _env_f(os.environ.get(
                                 "XLLM_SLO_ENCODE_MS"),
                                 DEFAULT_ENCODE_MS)),
                SloObjective("availability",
                             _env_f(os.environ.get(
                                 "XLLM_SLO_AVAILABILITY"),
                                 DEFAULT_AVAILABILITY)),
            ],
            fast_window_s=_env_f(
                os.environ.get("XLLM_SLO_FAST_WINDOW_S"),
                DEFAULT_FAST_WINDOW_S),
            slow_window_s=_env_f(
                os.environ.get("XLLM_SLO_SLOW_WINDOW_S"),
                DEFAULT_SLOW_WINDOW_S),
            tick_s=_env_f(os.environ.get("XLLM_SLO_TICK_S"),
                          DEFAULT_TICK_S),
        )


class SloEngine:
    """Multi-window burn-rate evaluation over cumulative-count snapshots."""

    def __init__(self, config: SloConfig,
                 snapshot_fn: Callable[[], Snapshot],
                 events: Optional[EventLog] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config
        self.snapshot_fn = snapshot_fn
        self.events = events
        self.clock = clock
        self._lock = make_lock("obs.slo", 78)
        # [(t_mono, snapshot)] oldest first; trimmed to one entry past
        # the slow window so every window always has a baseline.
        self._history: List[Tuple[float, Snapshot]] = []
        self._breach: Dict[str, bool] = {}
        self._breach_since: Dict[str, float] = {}
        self._last_state: Dict[str, Any] = {}
        # Baseline snapshot at construction: traffic that lands before
        # the first tick still deltas against zero, not against itself.
        self._history.append((self.clock(), snapshot_fn()))

    # ------------------------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """Take a snapshot (rate-limited to ~tick_s/2 so /admin/slo
        polls don't flood the history), re-evaluate every objective, and
        run breach open/close transitions. Returns the fresh state."""
        now = self.clock()
        snap = self.snapshot_fn()
        transitions: List[Tuple[str, str, Dict[str, Any]]] = []
        with self._lock:
            if now - self._history[-1][0] >= self.config.tick_s / 2.0:
                self._history.append((now, snap))
                # Keep exactly one snapshot older than the slow window as
                # its baseline; drop the rest.
                horizon = now - self.config.slow_window_s
                while len(self._history) >= 2 \
                        and self._history[1][0] <= horizon:
                    self._history.pop(0)
            state = self._evaluate_locked(now, snap)
            for name, obj_state in state["objectives"].items():
                fast = obj_state["windows"]["fast"]
                slow = obj_state["windows"]["slow"]
                was = self._breach.get(name, False)
                opens = (not was
                         and fast["total"] > 0
                         and fast["burn_rate"] >= self.config.burn_open
                         and slow["burn_rate"] >= self.config.burn_open)
                closes = (was
                          and fast["burn_rate"] < self.config.burn_close)
                if opens:
                    self._breach[name] = True
                    self._breach_since[name] = now
                    transitions.append(("open", name, {
                        "fast_burn": fast["burn_rate"],
                        "slow_burn": slow["burn_rate"],
                        "fast_attainment": fast["attainment"],
                        "threshold_ms": obj_state["threshold_ms"],
                        "target": obj_state["objective"]}))
                elif closes:
                    self._breach[name] = False
                    dur = now - self._breach_since.pop(name, now)
                    transitions.append(("close", name, {
                        "fast_burn": fast["burn_rate"],
                        "breach_duration_s": round(dur, 3)}))
                obj_state["breach"] = self._breach.get(name, False)
                since = self._breach_since.get(name)
                if obj_state["breach"] and since is not None:
                    obj_state["breach_age_s"] = round(now - since, 3)
            state["breached"] = sorted(
                n for n, b in self._breach.items() if b)
            self._last_state = state
        if self.events is not None:
            # Literal emit sites: the event-catalog xlint rule verifies
            # every emitted type against the closed taxonomy statically.
            for kind, name, attrs in transitions:
                if kind == "open":
                    self.events.emit("slo_breach_open", objective=name,
                                     **attrs)
                else:
                    self.events.emit("slo_breach_close", objective=name,
                                     **attrs)
        return state

    def _evaluate_locked(self, now: float, snap: Snapshot
                         ) -> Dict[str, Any]:
        windows = (("fast", self.config.fast_window_s),
                   ("slow", self.config.slow_window_s))
        objectives: Dict[str, Any] = {}
        for obj in self.config.objectives:
            cur_good, cur_total = snap.get(obj.name, (0.0, 0.0))
            win_state: Dict[str, Any] = {}
            for wname, wsecs in windows:
                base = self._baseline_locked(now - wsecs)
                b_good, b_total = base.get(obj.name, (0.0, 0.0))
                total = max(cur_total - b_total, 0.0)
                good = min(max(cur_good - b_good, 0.0), total)
                if total > 0:
                    attainment = good / total
                else:
                    attainment = 1.0        # no traffic burns no budget
                budget = max(1.0 - obj.objective, 1e-9)
                burn = (1.0 - attainment) / budget
                win_state[wname] = {
                    "window_s": wsecs,
                    "total": round(total, 3),
                    "attainment": round(attainment, 6),
                    "burn_rate": round(burn, 4),
                }
            objectives[obj.name] = {
                "objective": obj.objective,
                "threshold_ms": obj.threshold_ms,
                "total_seen": round(cur_total, 3),
                "attainment_total": round(
                    cur_good / cur_total, 6) if cur_total > 0 else 1.0,
                "windows": win_state,
            }
        return {"objectives": objectives,
                "fast_window_s": self.config.fast_window_s,
                "slow_window_s": self.config.slow_window_s,
                "tick_s": self.config.tick_s,
                "burn_open": self.config.burn_open,
                "burn_close": self.config.burn_close}

    def _baseline_locked(self, t: float) -> Snapshot:
        """Last snapshot at/before ``t`` (the window baseline); the
        oldest snapshot when history doesn't reach back that far —
        short uptimes evaluate over what exists, not over nothing."""
        base = self._history[0][1]
        for ts, snap in self._history:
            if ts <= t:
                base = snap
            else:
                break
        return base

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """Last evaluated state (tick() to refresh)."""
        with self._lock:
            if not self._last_state:
                # Never ticked: evaluate in place without mutating.
                now = self.clock()
                state = self._evaluate_locked(now, self._history[-1][1])
                for name, obj_state in state["objectives"].items():
                    obj_state["breach"] = self._breach.get(name, False)
                state["breached"] = sorted(
                    n for n, b in self._breach.items() if b)
                return state
            return dict(self._last_state)

    def export(self, registry) -> None:
        """Scrape-time mirror into ``xllm_slo_*`` gauges."""
        state = self.state()
        g_att = registry.gauge(
            "xllm_slo_attainment",
            "fast-window good-request fraction per SLO objective",
            labelnames=("objective",))
        g_burn = registry.gauge(
            "xllm_slo_burn_rate",
            "error-budget burn rate per objective and window "
            "(1.0 = burning exactly at the objective's rate)",
            labelnames=("objective", "window"))
        g_breach = registry.gauge(
            "xllm_slo_breach",
            "1 while the objective's multi-window breach is open",
            labelnames=("objective",))
        for name, obj_state in state.get("objectives", {}).items():
            g_att.set(obj_state["windows"]["fast"]["attainment"],
                      objective=name)
            for wname, w in obj_state["windows"].items():
                g_burn.set(w["burn_rate"], objective=name, window=wname)
            g_breach.set(1 if obj_state.get("breach") else 0,
                         objective=name)


# ---------------------------------------------------------------------------
# Anomaly detection (the watchdog's judgment)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InstanceSignal:
    """One instance's health signals for a single watchdog tick, gathered
    by the service plane from state it already tracks."""

    name: str
    heartbeat_age_s: float
    heartbeat_deadline_s: float
    step_ms_p99: Optional[float] = None     # recent, worker-shipped
    kv_usage: float = 0.0                   # [0, 1]
    # Heartbeat-carried LoadMetrics.engine_alive: 0 once the worker's
    # engine fault breaker let its loop die (docs/ROBUSTNESS.md).
    engine_alive: int = 1


ANOMALY_TYPES = ("heartbeat_gap", "step_ms_regression", "kv_saturation",
                 "engine_dead")


class AnomalyDetector:
    """Per-instance anomaly state machine over watchdog signals."""

    def __init__(self, events: Optional[EventLog] = None,
                 step_factor: Optional[float] = None,
                 kv_sat: Optional[float] = None,
                 ewma_alpha: float = 0.3,
                 min_baseline_samples: int = 3) -> None:
        self.events = events
        # p99 regression threshold: current > factor × rolling baseline.
        self.step_factor = step_factor if step_factor is not None else \
            _env_f(os.environ.get("XLLM_WATCHDOG_STEP_FACTOR"), 3.0)
        self.kv_sat = kv_sat if kv_sat is not None else \
            _env_f(os.environ.get("XLLM_WATCHDOG_KV_SAT"), 0.95)
        self.ewma_alpha = ewma_alpha
        self.min_baseline_samples = min_baseline_samples
        self._lock = make_lock("obs.watchdog", 79)
        # (type, instance) → {"since": t_wall, "value": ..., ...}
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # instance → (ewma_p99, n_samples)
        self._baseline: Dict[str, Tuple[float, int]] = {}

    def observe(self, signals: List[InstanceSignal]) -> None:
        transitions: List[Tuple[str, str, str, Dict[str, Any]]] = []
        with self._lock:
            seen = set()
            for sig in signals:
                seen.add(sig.name)
                self._judge_locked(sig, transitions)
            # Instances gone from the cluster close their anomalies and
            # drop their baselines (a future same-name instance is a new
            # instance, not a recovered one).
            for (atype, name) in [k for k in self._active
                                  if k[1] not in seen]:
                self._close_locked(atype, name,
                                   {"reason": "instance_removed"},
                                   transitions)
            for name in [n for n in self._baseline if n not in seen]:
                del self._baseline[name]
        if self.events is not None:
            # Literal emit sites (event-catalog xlint rule).
            for kind, atype, name, attrs in transitions:
                if kind == "open":
                    self.events.emit("anomaly_open", anomaly=atype,
                                     instance=name, **attrs)
                else:
                    self.events.emit("anomaly_close", anomaly=atype,
                                     instance=name, **attrs)

    def _judge_locked(self, sig: InstanceSignal, transitions) -> None:
        # Heartbeat gap vs. deadline.
        self._set_locked(
            "heartbeat_gap", sig.name,
            open_=sig.heartbeat_age_s > sig.heartbeat_deadline_s,
            attrs={"age_s": round(sig.heartbeat_age_s, 3),
                   "deadline_s": sig.heartbeat_deadline_s},
            transitions=transitions)
        # KV-pool saturation.
        self._set_locked(
            "kv_saturation", sig.name,
            open_=sig.kv_usage >= self.kv_sat,
            attrs={"kv_usage": round(sig.kv_usage, 4),
                   "threshold": self.kv_sat},
            transitions=transitions)
        # Dead engine loop (the fault breaker opened): the worker still
        # heartbeats — store keepalive continues — but serves nothing;
        # without this signal the gap between thread_crashed and lease
        # expiry is invisible to the service plane.
        self._set_locked(
            "engine_dead", sig.name,
            open_=sig.engine_alive == 0,
            attrs={"engine_alive": sig.engine_alive},
            transitions=transitions)
        # Step-time p99 regression vs. the rolling baseline. The
        # baseline only learns from non-anomalous samples — folding the
        # regression in would normalize it away.
        p99 = sig.step_ms_p99
        if p99 is None or p99 <= 0 or not math.isfinite(p99):
            return
        base, n = self._baseline.get(sig.name, (0.0, 0))
        warmed = n >= self.min_baseline_samples
        regressed = warmed and p99 > self.step_factor * base
        self._set_locked(
            "step_ms_regression", sig.name, open_=regressed,
            attrs={"step_ms_p99": round(p99, 3),
                   "baseline_ms": round(base, 3),
                   "factor": self.step_factor},
            transitions=transitions)
        if not regressed:
            new = p99 if n == 0 else \
                (1 - self.ewma_alpha) * base + self.ewma_alpha * p99
            self._baseline[sig.name] = (new, n + 1)

    def _set_locked(self, atype: str, name: str, open_: bool,
                    attrs: Dict[str, Any], transitions) -> None:
        key = (atype, name)
        if open_ and key not in self._active:
            self._active[key] = {"since": time.time(), **attrs}
            transitions.append(("open", atype, name, attrs))
        elif not open_ and key in self._active:
            self._close_locked(atype, name, attrs, transitions)
        elif open_:
            self._active[key].update(attrs)     # refresh live values

    def _close_locked(self, atype: str, name: str,
                      attrs: Dict[str, Any], transitions) -> None:
        rec = self._active.pop((atype, name), None)
        dur = time.time() - rec["since"] if rec else 0.0
        transitions.append(("close", atype, name,
                            dict(attrs, duration_s=round(dur, 3))))

    # ------------------------------------------------------------------
    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"type": atype, "instance": name, **dict(rec)}
                    for (atype, name), rec in sorted(self._active.items())]

    def export(self, registry) -> None:
        """Scrape-time rebuild of ``xllm_anomaly_active{type,instance}``
        (cleared each scrape so closed anomalies drop out)."""
        g = registry.gauge(
            "xllm_anomaly_active",
            "1 per open watchdog anomaly", labelnames=("type", "instance"))
        g.clear()
        for rec in self.active():
            g.set(1, type=rec["type"], instance=rec["instance"])
