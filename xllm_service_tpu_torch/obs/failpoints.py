"""Deterministic fault injection: a closed catalog of named failure
sites, the JAX package's ``obs/failpoints.py`` for this package.

Each named site calls ``failpoints.fire("<name>")`` on its path (a dict
lookup when nothing is armed); an armed failpoint fires
deterministically in the count and threshold modes, so a test that arms
``worker.fault_step=count:1`` faults exactly one engine step.

- CLOSED catalog: ``FAILPOINTS`` is the JAX package's list, whole, so
  that the reference master's fan-out of ``POST /admin/failpoint`` to
  every instance arms this worker as it arms a JAX worker (an unknown
  name would be a 400). ``arm()`` / ``fire()`` reject any other name.
- Armed through the ``XLLM_FAILPOINTS`` environment at construction
  (grammar below) and at run time through ``POST /admin/failpoint``.
- Every trip counts in ``xllm_failpoints_tripped_total{name}`` of the
  owning plane's registry, and emits ``failpoint_tripped`` into its
  event log when given one.

This package's worker fires every name of the catalog where the JAX
worker fires it, the encode sites (``worker.fail_encode``,
``worker.hang_encode``) in ``/encode``; its master fires
``service.fail_redispatch`` and the ``store.*`` sites of its own store
guard where the JAX master does.

Spec grammar (comma-separated entries)::

    name=always[:value]     fire every time (value: site-specific arg,
                            e.g. worker.slow_response_ms=always:250)
    name=count:N[:value]    fire the first N times, then auto-disarm
    name=after:N            fire ONCE when the cumulative units passed
                            to fire(..., n=...) reach N, then disarm
    name=prob:P[:value]     fire with probability P (load tests only)
    name=off                explicit no-op (override an env arming)

Thread-safe: one lock guards the arming state and never calls out.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

from xllm_service_tpu_torch.utils.locks import make_lock

# The complete catalog, as the JAX package's.
FAILPOINTS = (
    "worker.drop_heartbeats",    # skip store keepalive + master beat
    "worker.refuse_generate",    # 503 every new generate (refusal class)
    "worker.hang_rpc",           # block a generate handler (value: s)
    "worker.die_after_n_tokens",  # simulate process death mid-stream
    "worker.slow_response_ms",   # delay a generate handler (value: ms)
    "worker.fail_kv_transfer",   # PD migration transport failure
    "worker.fail_kv_fetch",      # cross-worker cached-block fetch fails
    "service.fail_redispatch",   # service refuses to pick an alternate
    "worker.crash_heartbeat",    # raise outside the heartbeat loop's try
    "store.fail_rpc",            # every coordination-store call raises
    "store.hang",                # a store call blocks (value: s)
    "store.partition",           # store calls raise, watches suppressed
    "worker.fail_encode",        # /encode raises on the encode worker
    "worker.hang_encode",        # /encode blocks (value: s)
    "worker.fault_step",         # raise inside the engine step fault
                                 # boundary (count/after/prob choose
                                 # which step)
    "worker.fault_step_req",     # raise only while a MARKED request is
                                 # in the step's batch (value: prompt
                                 # substring to mark; no value marks
                                 # all) — the poison-pill simulator
)

_MODES = ("always", "count", "after", "prob", "off")


class Failpoints:
    """Per-plane armed-failpoint registry (one per worker, so that a
    test can arm one of two in-process workers)."""

    def __init__(self, obs=None, env: Optional[str] = None,
                 events=None) -> None:
        self._lock = make_lock("obs.failpoints", 75)
        self.obs = obs
        self.events = events
        # name -> {"mode", "n", "value", "fired", "units"}
        self._armed: Dict[str, Dict[str, Any]] = {}
        self._trips: Dict[str, int] = {name: 0 for name in FAILPOINTS}
        spec = os.environ.get("XLLM_FAILPOINTS", "") if env is None \
            else env
        if spec:
            self.arm_from_spec(spec)

    # -- arming ---------------------------------------------------------
    @staticmethod
    def _check_name(name: str) -> None:
        if name not in FAILPOINTS:
            raise ValueError(
                f"failpoint {name!r} is not in the obs/failpoints.py "
                f"catalog {FAILPOINTS}")

    def arm(self, name: str, mode: str = "always", n: float = 0,
            value: Any = None) -> None:
        """Arm one failpoint. ``n`` is the count (mode=count), the unit
        threshold (mode=after), or the probability (mode=prob)."""
        self._check_name(name)
        if mode not in _MODES:
            raise ValueError(f"failpoint mode {mode!r} not in {_MODES}")
        with self._lock:
            if mode == "off":
                self._armed.pop(name, None)
                return
            self._armed[name] = {"mode": mode, "n": float(n),
                                 "value": value, "fired": 0, "units": 0.0}

    def disarm(self, name: str) -> None:
        self._check_name(name)
        with self._lock:
            self._armed.pop(name, None)

    def arm_from_spec(self, spec: str) -> None:
        """Parse the ``XLLM_FAILPOINTS`` grammar (module docstring), also
        the ``{"spec"}`` body of ``POST /admin/failpoint``."""
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, sep, rest = entry.partition("=")
            if not sep:
                raise ValueError(
                    f"failpoint spec entry {entry!r}: expected "
                    f"name=mode[:arg[:value]]")
            parts = rest.split(":")
            mode = parts[0] or "always"
            n = 0.0
            value: Any = None
            if mode in ("count", "after", "prob"):
                if len(parts) < 2:
                    raise ValueError(
                        f"failpoint {name}: mode {mode!r} needs an "
                        f"argument (e.g. {mode}:3)")
                n = float(parts[1])
                if len(parts) > 2:
                    value = float(parts[2])
            elif len(parts) > 1:
                value = float(parts[1])
            self.arm(name.strip(), mode=mode, n=n, value=value)

    def arm_from_body(self, body: Dict[str, Any]) -> None:
        """The ``POST /admin/failpoint`` body (``{"spec": "<grammar>"}``
        or ``{"name", "mode", "n", "value"}``). Raises ValueError or
        TypeError on bad input; the handler answers 400."""
        if body.get("spec"):
            self.arm_from_spec(str(body["spec"]))
        else:
            self.arm(str(body.get("name", "")),
                     mode=str(body.get("mode", "always")),
                     n=float(body.get("n", 0) or 0),
                     value=body.get("value"))

    # -- firing ---------------------------------------------------------
    def fire(self, name: str, n: float = 1) -> Optional[Any]:
        """One pass through a failure site. Returns the armed value (or
        ``True`` when none was set) when the failpoint trips, else
        ``None``. ``n`` is the unit weight of this pass (``after``
        mode)."""
        self._check_name(name)
        if name not in self._armed:
            # Unlocked fast path: a disarmed site costs one dict probe. A
            # point armed concurrently fires on the next pass.
            return None
        with self._lock:
            spec = self._armed.get(name)
            if spec is None:
                return None
            mode = spec["mode"]
            if mode == "count":
                if spec["fired"] >= spec["n"]:
                    self._armed.pop(name, None)
                    return None
            elif mode == "after":
                spec["units"] += n
                if spec["units"] < spec["n"]:
                    return None
                self._armed.pop(name, None)   # fires exactly once
            elif mode == "prob":
                if random.random() >= spec["n"]:
                    return None
            spec["fired"] += 1
            self._trips[name] += 1
            value = spec["value"]
        if self.obs is not None:
            self.obs.counter(
                "xllm_failpoints_tripped_total",
                "armed failure-injection sites tripped, by name "
                "(obs/failpoints.py catalog)",
                labelnames=("name",)).inc(name=name)
        if self.events is not None:
            self.events.emit("failpoint_tripped", name=name)
        return value if value is not None else True

    def armed_value(self, name: str) -> Optional[Any]:
        """Non-firing peek: the armed value (``True`` when none was set),
        ``None`` when disarmed. ``worker.fault_step_req`` marks requests
        at admission with it without spending the fire budget."""
        self._check_name(name)
        if name not in self._armed:
            return None
        with self._lock:
            spec = self._armed.get(name)
            if spec is None:
                return None
            value = spec["value"]
        return value if value is not None else True

    # -- querying -------------------------------------------------------
    def trips(self, name: str) -> int:
        self._check_name(name)
        with self._lock:
            return self._trips[name]

    def state(self) -> Dict[str, Any]:
        """The ``GET /admin/failpoints`` body: what is armed (mode,
        remaining budget, value) and the lifetime trips by name."""
        with self._lock:
            armed = {name: dict(spec)
                     for name, spec in self._armed.items()}
            trips = {name: count for name, count in self._trips.items()
                     if count}
        return {"catalog": list(FAILPOINTS), "armed": armed,
                "trips": trips}
