"""OpenAI-compatible HTTP front door of the service.

A copy of the JAX package's ``service/http_service.py``: the same
behaviour and names, importing only this package (and no device code).

Rebuild of ``http_service/service.{h,cpp}`` (SURVEY.md §2 #2): parses the
OpenAI request, schedules it, rewrites the body with ``service_request_id``
+ ``token_ids`` + ``routing`` (so the worker never re-tokenizes,
service.cpp:457-463), forwards to the chosen prefill worker, and returns
the response through one of the reference's two topologies
(rpc_service/service.h:67-79):

  relay mode  — the worker's SSE/JSON response is relayed byte-for-byte
                through a progressive reader (service.cpp:113-143, 206-222);
  rpc mode    — (``enable_decode_response_to_service``) tokens arrive at
                the RPC plane's ``/rpc/generations`` fan-in; this layer
                assembles OpenAI chunks from the per-request callback.

``/v1/models`` and ``/metrics`` are served from service-local state (the
reference reverse-proxies them to a worker, service.cpp:283-336 — an
improvement called out in SURVEY.md §5.5). ``/model/triggers`` implements
the manual sleep/wakeup surface (service.cpp:510-550).
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import os
import queue
import threading
import time

from typing import Any, Dict, Iterator, List, Optional

from xllm_service_tpu_torch.config import ServiceOptions
from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.obs.events import EventLog
from xllm_service_tpu_torch.obs.failpoints import Failpoints
from xllm_service_tpu_torch.obs.metrics import Registry
from xllm_service_tpu_torch.obs.slo import (
    AnomalyDetector, InstanceSignal, SloConfig, SloEngine)
from xllm_service_tpu_torch.obs.spans import REQUEST_ID_HEADER, SpanStore
from xllm_service_tpu_torch.obs import steptrace, timeline
from xllm_service_tpu_torch.obs.expfmt import fraction_le_from_buckets
from xllm_service_tpu_torch.service.httpd import (
    Request, Response, Router, http_json, http_stream_status,
    iter_sse_events)
from xllm_service_tpu_torch.service.instance_types import RequestPhase
from xllm_service_tpu_torch.service.recovery import RecoveryManager, RelayLedger
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.threads import spawn
from xllm_service_tpu_torch.service.response_handler import (
    SSE_DONE, ChatStreamAssembler, CompletionStreamAssembler,
    ResponseCollector)
from xllm_service_tpu_torch.service.scheduler import Scheduler
from xllm_service_tpu_torch.service.tracer import RequestTracer
from xllm_service_tpu_torch.utils.misc import short_uuid
from xllm_service_tpu_torch.utils.retry import RetryPolicy
from xllm_service_tpu_torch.utils.types import (
    FinishReason, Request as SchedRequest, RequestOutput, StatusCode,
    parse_openai_sampling, validate_sampling)

logger = logging.getLogger(__name__)

# Pre-header transport deaths on a forwarded STREAM: the worker's
# process (or socket) died before it answered. Safe to re-dispatch in
# the relay-stream topology even though the worker may have started —
# its only delivery path is this broken socket, so its eventual write
# fails and the response cleanup cancels the engine request; the client
# can never see duplicate work. Timeouts stay excluded: a slow worker's
# socket is alive and still deliverable.
_DEAD_TRANSPORT_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                          BrokenPipeError, http.client.RemoteDisconnected)


class _EngineFaultResume(Exception):
    """Internal relay control flow: a worker's in-stream engine-fault
    frame (device-plane fault boundary, docs/ROBUSTNESS.md) below the
    poison threshold — routed into the mid-stream resume machinery
    WITHOUT forwarding the fault frame to the client."""

    def __init__(self, verdict: str) -> None:
        super().__init__(verdict)
        self.verdict = verdict


def _engine_fault_error(obj: Any) -> Optional[str]:
    """The verdict string when ``obj`` is a worker engine-fault error
    envelope (``{"error": {"type": "engine_fault", ...}}``), else
    None."""
    if not isinstance(obj, dict):
        return None
    err = obj.get("error")
    if isinstance(err, dict) and err.get("type") == "engine_fault":
        return str(err.get("message") or "engine_fault")
    return None


def _engine_fault_status(out: RequestOutput) -> Optional[str]:
    """The verdict string when ``out`` is the worker's typed
    engine-fault terminal output (INTERNAL status whose message names
    the blame verdict), else None."""
    st = out.status
    if st is not None and st.code == StatusCode.INTERNAL \
            and (st.message or "").startswith("engine_fault"):
        return st.message
    return None


def _engine_fault_frame(verdict: str) -> bytes:
    """The typed in-stream error frame a client sees when its request
    is failed as a poison pill mid-stream (the non-stream paths return
    a clean 500 with the same envelope)."""
    return (b"data: " + json.dumps(
        {"error": {"message": verdict, "type": "engine_fault",
                   "code": 500}}).encode("utf-8") + b"\n\n")


class _RequestObs:
    """Per-request latency/span bookkeeping on the front door.

    One instance rides each completion request through its response
    path; every method is idempotent (retry paths and on_close backstops
    may reach the same milestone twice) and the FIRST occurrence is the
    truthful timestamp. TPOT in the relay-stream topology is a
    frame-interval approximation (the relay never parses tokens out of
    the proxied bytes — see docs/OBSERVABILITY.md)."""

    __slots__ = ("svc", "srid", "t0", "t_first", "tokens", "_done",
                 "_dispatched")

    def __init__(self, svc: "HttpService", srid: str, kind: str,
                 model: str) -> None:
        self.svc = svc
        self.srid = srid
        self.t0 = time.monotonic()
        self.t_first = 0.0
        self.tokens = 0
        self._done = False
        self._dispatched = False
        svc.spans.annotate(srid, kind=kind, model=model)
        svc.spans.record(srid, "received", t_mono=self.t0)

    def stage(self, stage: str, **attrs: Any) -> None:
        self.svc.spans.record(self.srid, stage, **attrs)

    def dispatched(self, target: str) -> None:
        now = time.monotonic()
        if self._dispatched:
            # Redispatch attempt: the first dispatch keeps the
            # queue-wait truth, but the instance that actually serves
            # the request must be visible in the trace (at most one
            # redispatch per request by design).
            self.svc.spans.record(self.srid, "redispatched", t_mono=now,
                                  target=target)
            return
        self._dispatched = True
        self.svc.spans.record(self.srid, "dispatched", t_mono=now,
                              target=target)
        self.svc.h_queue_wait.observe(1000.0 * (now - self.t0))

    def first_token(self) -> None:
        if self.t_first:
            return
        self.t_first = time.monotonic()
        self.svc.spans.record(self.srid, "first_token",
                              t_mono=self.t_first)
        self.svc.h_ttft.observe(1000.0 * (self.t_first - self.t0))

    def add_tokens(self, n: int) -> None:
        self.tokens += max(int(n), 0)

    def finished(self, error: bool = False) -> None:
        if self._done:
            return
        self._done = True
        now = time.monotonic()
        self.svc.spans.record(self.srid, "finished", t_mono=now,
                              error=bool(error))
        if error:
            return          # a refused/timed-out request is not a latency
        self.svc.h_e2e.observe(1000.0 * (now - self.t0))
        if self.t_first and self.tokens > 1:
            self.svc.h_tpot.observe(
                1000.0 * (now - self.t_first) / (self.tokens - 1))


class HttpService:
    def __init__(self, opts: ServiceOptions, scheduler: Scheduler,
                 events: Optional[EventLog] = None,
                 failpoints: Optional[Failpoints] = None) -> None:
        self.opts = opts
        self.scheduler = scheduler
        self.tracer = RequestTracer(opts.trace_path,
                                    opts.enable_request_trace)
        # {"http": Admission, "rpc": Admission} — injected by Master once
        # the servers exist; /metrics reports their pressure.
        self.admissions = None
        # The service plane's metrics registry + span ring. One
        # HttpService per process in production, so this IS the
        # process-global registry there; the co-located test harness
        # gets per-plane attribution for free (obs/metrics.py docstring).
        self.obs = Registry()
        self.spans = SpanStore(capacity=int(os.environ.get(
            "XLLM_SPAN_RING", "2048")))
        # Heartbeat-shipped worker step flight-recorder tails
        # (obs/steptrace.py): the /admin/timeline fallback source when
        # a live worker pull fails mid-incident.
        self.step_books = steptrace.StepBooks()
        # Default /admin/timeline merge window; read ONCE here (the
        # handler is serving-reachable — flag-registry discipline).
        try:
            self._timeline_window_s = float(os.environ.get(
                "XLLM_TIMELINE_WINDOW_S", "60") or 60)
        except ValueError:
            self._timeline_window_s = 60.0
        self._timeline_exports = 0
        self._m_requests = self.obs.counter(
            "xllm_service_requests_total",
            "completion/chat requests accepted by the front door")
        self._m_errors = self.obs.counter(
            "xllm_service_errors_total",
            "requests that ended in a scheduling/worker/timeout error")
        self._m_requests.inc(0.0)       # render 0 from boot, like the
        self._m_errors.inc(0.0)         # f-string exporter always did
        self.h_ttft = self.obs.histogram(
            "xllm_service_ttft_ms",
            "received -> first streamed token (stream/RPC topologies)")
        self.h_tpot = self.obs.histogram(
            "xllm_service_tpot_ms",
            "mean inter-token gap per request (frame-interval "
            "approximation in the relay-stream topology)")
        self.h_e2e = self.obs.histogram(
            "xllm_service_e2e_ms", "received -> finished")
        self.h_queue_wait = self.obs.histogram(
            "xllm_service_queue_wait_ms",
            "received -> dispatched to a worker (schedule + rewrite + "
            "redispatch time)")
        # EPD encode stage (docs/EPD.md): per-call vision-encode
        # durations shipped in worker heartbeats
        # (LatencyMetrics.encode_ms_samples) — observed by the
        # scheduler's heartbeat path into this same registry, judged
        # here by the "encode" SLO objective.
        self.h_encode = self.obs.histogram(
            "xllm_service_encode_ms",
            "per-call vision-encode duration across the worker fleet "
            "(heartbeat-shipped samples)")

        # --- the judgment layer (SLO engine + event log + watchdog) ----
        # Shared event log (Master passes the cluster-wide one so the
        # scheduler's election and instance events land in the same
        # ring); a standalone HttpService owns its own.
        self.events = events if events is not None else EventLog(
            capacity=int(os.environ.get("XLLM_EVENT_RING", "1024")))
        self.slo_cfg = SloConfig.from_env(
            default_ttft_ms=opts.target_ttft_ms)
        self.slo = SloEngine(self.slo_cfg, self._slo_snapshot,
                             events=self.events)
        self.watch = AnomalyDetector(events=self.events)
        self._wd_stop = threading.Event()
        self._wd_thread: Optional[threading.Thread] = None

        # --- robustness layer: failpoints + retry + mid-stream recovery
        # Service-plane fault injection (the "service.*" and "store.*"
        # catalog names; each worker owns its own set) — POST
        # /admin/failpoint also proxies worker arming through the
        # instance registry. Master passes ITS registry (created before
        # the store guard so `store.*` covers even boot-time election);
        # we late-bind our registry for the trip counters. A standalone
        # HttpService owns its own.
        if failpoints is not None:
            self.failpoints = failpoints
            self.failpoints.obs = self.obs
        else:
            self.failpoints = Failpoints(events=self.events, obs=self.obs)
        # Bounded service-plane admission (docs/ROBUSTNESS.md): beyond
        # XLLM_MAX_INFLIGHT tracked requests (0 = unbounded) — or
        # XLLM_MAX_INFLIGHT_PER_MODEL for one model — new work is SHED
        # with 429 + Retry-After instead of queueing unboundedly, so
        # goodput-under-SLO stays honest at overload. Literal env reads
        # for the flag-registry xlint rule.
        self.max_inflight = int(os.environ.get(
            "XLLM_MAX_INFLIGHT", "0") or 0)
        self.max_inflight_per_model = int(os.environ.get(
            "XLLM_MAX_INFLIGHT_PER_MODEL", "0") or 0)
        self._m_shed = self.obs.counter(
            "xllm_requests_shed_total",
            "requests shed by bounded admission, by reason",
            labelnames=("reason",))
        # The one retry/backoff policy every forward/redispatch loop
        # shares (utils/retry.py; XLLM_RETRY_* knobs) — replaced the
        # ad-hoc two-attempt loops that used to live here.
        self.retry = RetryPolicy.from_env()
        # Mid-stream failover (service/recovery.py): worker death
        # becomes a resume, not a client-visible error. Wired onto the
        # scheduler like spans/obs so fail_requests_on_instance can
        # hand recoverable requests over instead of cancelling.
        self.recovery = RecoveryManager(opts, scheduler, self.spans,
                                        self.events, self.obs,
                                        self.failpoints)
        scheduler.recovery = self.recovery

    # ------------------------------------------------------------------
    # Watchdog: periodic SLO evaluation + anomaly detection
    # ------------------------------------------------------------------
    def _slo_snapshot(self) -> Dict[str, Any]:
        """Cumulative (good, total) per SLO objective, read from the
        SAME histogram/counter families /metrics exports — the SLO
        engine judges exactly what the dashboards see. Latency "good"
        counts interpolate the threshold inside its bucket (one copy of
        the arithmetic: expfmt.fraction_le_from_buckets, shared with
        bench.py's slo_*_attainment fields)."""
        thresholds = {o.name: o.threshold_ms
                      for o in self.slo_cfg.objectives}
        out: Dict[str, Any] = {}
        for name, hist in (("ttft", self.h_ttft), ("e2e", self.h_e2e),
                           ("queue_wait", self.h_queue_wait),
                           ("encode", self.h_encode)):
            bs = hist.cumulative()
            if bs is None:
                out[name] = (0.0, 0.0)
                continue
            total = bs[-1][1]
            frac = fraction_le_from_buckets(
                bs, thresholds.get(name, 0.0)) or 0.0
            out[name] = (frac * total, total)
        requests = self._m_requests.value()
        errors = self._m_errors.value()
        out["availability"] = (max(requests - errors, 0.0), requests)
        return out

    def watchdog_tick(self) -> None:
        """One judgment pass: evaluate the SLO windows, then judge every
        instance's health signals. Signal gathering happens here (no obs
        lock held) so the detector itself never calls into the instance
        books."""
        self.slo.tick()
        mgr = self.scheduler.instance_mgr
        deadline = max(self.opts.detect_disconnected_instance_interval_s,
                       3.0 * self.opts.heartbeat_interval_s)
        signals = [
            InstanceSignal(
                name=row["name"],
                heartbeat_age_s=row["heartbeat_age_s"],
                heartbeat_deadline_s=deadline,
                step_ms_p99=row["latency"].get("step_ms_p99") or None,
                kv_usage=row["load"].get("kv_cache_usage", 0.0),
                engine_alive=int(row["load"].get("engine_alive", 1)))
            for row in mgr.instance_table()]
        self.watch.observe(signals)

    def _watchdog_loop(self) -> None:
        while not self._wd_stop.wait(self.slo_cfg.tick_s):
            try:
                self.watchdog_tick()
            except Exception:  # noqa: BLE001 — judgment must not die; next
                logger.exception("watchdog tick failed")  # tick retries

    def start_watchdog(self) -> None:
        if self._wd_thread is not None:
            return
        # Supervised + restarted: the watchdog is the judgment layer's
        # pulse — its per-tick try/except already survives a bad tick,
        # and the supervised restart survives a crash in the wait
        # machinery itself.
        self._wd_thread = spawn(
            "obs.watchdog_loop", self._watchdog_loop,
            thread_name="obs-watchdog",
            restart=threads.RESTART_POLICY,
            events=self.events, stop=self._wd_stop)
        self._wd_thread.start()

    def close(self) -> None:
        self._wd_stop.set()
        if self._wd_thread is not None:
            self._wd_thread.join(timeout=5)
            self._wd_thread = None
        self.tracer.close()

    def install(self, router: Router) -> None:
        router.route("GET", "/hello",
                     lambda r: Response.json({"ok": True}))
        router.route("POST", "/v1/chat/completions",
                     lambda r: self._completions(r, is_chat=True))
        router.route("POST", "/v1/completions",
                     lambda r: self._completions(r, is_chat=False))
        router.route("POST", "/v1/embeddings", self._embeddings)
        router.route("GET", "/v1/models", self._models)
        router.route("GET", "/metrics", self._metrics)
        router.route("POST", "/model/triggers", self._model_triggers)
        router.route("POST", "/admin/flags", self._admin_flags)
        router.route("GET", "/admin/flags", self._admin_flags_get)
        router.route_prefix("GET", "/admin/trace/", self._admin_trace)
        router.route("GET", "/admin/slo", self._admin_slo)
        router.route("GET", "/admin/events", self._admin_events)
        router.route("GET", "/admin/debug_bundle", self._admin_debug_bundle)
        router.route("GET", "/admin/timeline", self._admin_timeline)
        router.route("GET", "/admin/profile", self._admin_profile)
        router.route("POST", "/admin/failpoint", self._admin_failpoint)
        router.route("GET", "/admin/failpoints",
                     self._admin_failpoints_get)

    # ------------------------------------------------------------------
    # Request building (generate_request, service.cpp:239-267)
    # ------------------------------------------------------------------
    def _build_request(self, body: Dict[str, Any], is_chat: bool,
                       headers: Dict[str, str]) -> SchedRequest:
        srid = (headers.get("x-request-id")
                or f"{'chatcmpl' if is_chat else 'cmpl'}-{short_uuid()}")
        # Client-stamped send time (reference call_data.h:41-59 captures
        # x-request-id AND x-request-time); carried on the request and
        # surfaced in the ingress trace record.
        try:
            arrival = float(headers.get("x-request-time", ""))
        except ValueError:
            arrival = 0.0
        sampling = parse_openai_sampling(body, is_chat)
        req = SchedRequest(
            model=body.get("model", ""),
            service_request_id=srid,
            stream=bool(body.get("stream", False)),
            include_usage=bool((body.get("stream_options") or {})
                               .get("include_usage", False)),
            offline=bool(body.get("offline", False)),
            priority=int(body.get("priority", 0)),
            prompt=body.get("prompt", "") if not is_chat else "",
            messages=body.get("messages", []) if is_chat else [],
            token_ids=list(body.get("token_ids") or []),
            sampling=sampling,
            arrival_time=arrival)
        req.trace_callback = self.tracer.callback_for(srid)
        return req

    # ------------------------------------------------------------------
    # Completions / ChatCompletions (service.cpp:338-475)
    # ------------------------------------------------------------------
    def _admission_shed(self, model: str) -> Optional[Response]:
        """Bounded admission (docs/ROBUSTNESS.md): 429 + ``Retry-After``
        when the tracked in-flight population (global or per-model) is
        at its cap — shed BEFORE tokenization/scheduling, so an
        overloaded plane never pays preprocess cost for work it
        refuses. Counted by reason in xllm_requests_shed_total."""
        if self.max_inflight > 0 and \
                self.scheduler.num_tracked_requests() >= self.max_inflight:
            reason = "inflight"
        elif self.max_inflight_per_model > 0 and model \
                and self.scheduler.num_tracked_requests(model) >= \
                self.max_inflight_per_model:
            reason = "model_inflight"
        else:
            return None
        self._m_shed.inc(reason=reason)
        resp = Response.error(
            429, f"overloaded: in-flight cap reached ({reason}) — "
                 f"retry after the interval in Retry-After",
            err_type="overloaded_error")
        resp.headers["Retry-After"] = "1"
        return resp

    def _completions(self, http_req: Request, is_chat: bool) -> Response:
        self._m_requests.inc()
        try:
            body = http_req.json()
        except (ValueError, json.JSONDecodeError):
            return Response.error(400, "invalid JSON body")
        kind = "chat" if is_chat else "completion"
        if is_chat and not body.get("messages"):
            return Response.error(400, "messages is required")
        if not is_chat and not (body.get("prompt")
                                or body.get("token_ids")):
            return Response.error(400, "prompt is required")
        shed = self._admission_shed(body.get("model", ""))
        if shed is not None:
            return shed

        try:
            # Both the body parse (e.g. a non-numeric best_of/n) and the
            # cross-field rules map to 400, never a 500.
            req = self._build_request(body, is_chat, http_req.headers)
            validate_sampling(req.sampling, req.stream)
        except (TypeError, ValueError) as e:
            return Response.error(400, f"invalid request: {e}")
        robs = _RequestObs(self, req.service_request_id, kind,
                           body.get("model", ""))
        robs.stage("admitted", stream=req.stream)
        self.tracer.trace(req.service_request_id,
                          {"stage": "ingress", "kind": kind, "body": body,
                           "x_request_time": req.arrival_time or None})
        status, routing = self.scheduler.schedule(req)
        if not status.ok:
            self._m_errors.inc()
            if status.code == StatusCode.INTERNAL and \
                    status.message.startswith("request quarantined"):
                # The scheduler's poison-pill quarantine gate
                # (docs/ROBUSTNESS.md): surfaced as the same typed
                # engine_fault 500 the poisoning itself returned.
                self.scheduler.count_failed("quarantined")
                robs.finished(error=True)
                return Response.error(500, status.message,
                                      "engine_fault")
            if status.code.name == "UNAVAILABLE":
                self.scheduler.count_failed("no_instance")
            robs.finished(error=True)
            code = 503 if status.code.name == "UNAVAILABLE" else 400
            return Response.error(code, status.message)
        robs.stage("scheduled", prefill=routing.prefill_name,
                   decode=routing.decode_name)

        # Rewrite the forwarded body (service.cpp:457-463). The parsed
        # SamplingParams travel with it so the worker honors exactly what
        # the service normalized (max_completion_tokens, stop strings,
        # penalties, logprobs) instead of re-deriving a subset.
        fwd = dict(body)
        fwd["service_request_id"] = req.service_request_id
        fwd["token_ids"] = req.token_ids
        fwd["routing"] = routing.to_json()
        fwd["sampling"] = req.sampling.to_json()
        if req.mm_inputs:
            fwd["mm_inputs"] = req.mm_inputs
        path = "/v1/chat/completions" if is_chat else "/v1/completions"
        target = self.scheduler.instance_mgr.address_of(
            routing.prefill_name)
        if target is None:
            self._m_errors.inc()
            robs.finished(error=True)
            return Response.error(503, "routed instance vanished")

        if self.opts.enable_decode_response_to_service:
            return self._rpc_mode_response(req, fwd, target, path,
                                           is_chat, robs)
        return self._relay_mode_response(req, fwd, target, path, robs)

    def _fwd_headers(self, req: SchedRequest) -> Dict[str, str]:
        """Correlation header for every forward of this request — the
        worker stamps its span stages with the same id, so the merged
        timeline at /admin/trace/<id> crosses the plane boundary."""
        return {REQUEST_ID_HEADER: req.service_request_id}

    # -- re-dispatch ------------------------------------------------------
    def _redispatch(self, req: SchedRequest, fwd: Dict[str, Any],
                    exclude=()) -> Optional[str]:
        """Pick a new instance for a request its worker PROVABLY never
        worked on — an HTTP 503 refusal (draining/asleep) or a refused
        connection; never timeouts or mid-response failures, which could
        double-generate (mid-STREAM failures go through the recovery
        path instead — service/recovery.py). The reference README
        claims this rescheduling; its code never implements it
        (SURVEY.md §5.3). Walks up to K alternates, excluding every
        already-failed instance (``exclude``); the candidate walk and
        schedule bookkeeping live in RecoveryManager.reroute (one copy
        for redispatch and recovery). Returns the new target address,
        or None."""
        old = req.routing.prefill_name if req.routing else ""
        self.spans.record(req.service_request_id, "redispatch",
                          from_instance=old)
        name, addr = self.recovery.reroute(req, fwd, exclude)
        if name is None:
            return None
        self.events.emit("redispatch",
                         service_request_id=req.service_request_id,
                         from_instance=old, to=name)
        self.tracer.trace(req.service_request_id,
                          {"stage": "redispatch", "from": old,
                           "to": name})
        return addr

    @staticmethod
    def _routed_name(fwd: Dict[str, Any]) -> str:
        return (fwd.get("routing") or {}).get("prefill_name", "")

    def _send_with_redispatch(self, req: SchedRequest,
                              fwd: Dict[str, Any], target: str,
                              path: str):
        """One JSON forward with redispatch on refusal-class outcomes
        ONLY (503 status / refused connection) — shared by the
        non-stream relay and the RPC ack so their retry policies cannot
        drift apart. Walks alternates under the shared retry budget,
        excluding every instance that already refused; when everything
        refused, the answer is a CLEAN 503 (a ConnectionRefusedError on
        a redispatched target no longer escapes raw)."""
        failed: set = set()
        last_exc: Optional[Exception] = None
        attempts = max(self.retry.max_attempts, 1)
        for attempt in range(attempts):
            try:
                status, resp = http_json(
                    "POST", target, path, fwd,
                    timeout=self.opts.request_timeout_s,
                    headers=self._fwd_headers(req))
            except ConnectionRefusedError as e:
                last_exc = e
                failed.add(self._routed_name(fwd))
                new = self._redispatch(req, fwd, exclude=failed) \
                    if attempt + 1 < attempts else None
                if new:
                    target = new
                    continue
                break
            if status == 503 and attempt + 1 < attempts:
                failed.add(self._routed_name(fwd))
                new = self._redispatch(req, fwd, exclude=failed)
                if new:
                    target = new
                    continue
            verdict = _engine_fault_error(resp) if status == 500 \
                else None
            if verdict is not None:
                # Device-plane fault blamed on this request. The worker
                # already evicted it (fault boundary), so a re-dispatch
                # cannot double-generate — below the poison threshold
                # it hops to a survivor; at the threshold the typed 500
                # goes to the client as-is.
                name = self._routed_name(fwd)
                poisoned = self.scheduler.note_engine_fault(
                    req.service_request_id, req.token_ids, name,
                    verdict)
                if not poisoned and attempt + 1 < attempts:
                    failed.add(name)
                    new = self._redispatch(req, fwd, exclude=failed)
                    if new:
                        target = new
                        continue
            return status, resp
        detail = f": {last_exc}" if last_exc else ""
        return 503, {"error": {
            "message": f"no reachable instance{detail}",
            "type": "unavailable"}}

    # -- topology 1: HTTP relay (service.cpp:168-236) ---------------------
    def _relay_mode_response(self, req: SchedRequest, fwd: Dict[str, Any],
                             target: str, path: str,
                             robs: _RequestObs) -> Response:
        self.scheduler.record_new_request(req, lambda out: True)
        if req.stream:
            # Recoverable streams (service/recovery.py policy) forward
            # with the ledger extension armed: the worker emits token
            # ids per frame, the relay keeps the delivered ledger, and
            # a mid-stream worker death becomes a resume on a survivor
            # instead of a broken stream.
            recover = self.recovery.recoverable(req)
            if recover:
                self.recovery.arm(req, fwd, path, owner="relay")
            # Eager open: the worker's status is known BEFORE any bytes
            # reach the client, so a 503 can be re-dispatched and other
            # errors surface with their real status code instead of
            # error JSON inside a 200 SSE stream. Refusals walk
            # alternates under the shared retry budget, excluding every
            # instance that already refused.
            failed: set = set()
            attempts = max(self.retry.max_attempts, 1)
            for attempt in range(attempts):
                robs.dispatched(target)
                try:
                    status, body = http_stream_status(
                        "POST", target, path, fwd,
                        timeout=self.opts.request_timeout_s,
                        headers=self._fwd_headers(req))
                except Exception as e:  # noqa: BLE001
                    # Refusal-class failures (see _redispatch) — plus,
                    # for recoverable streams, any pre-header transport
                    # death (_DEAD_TRANSPORT_ERRORS): a timeout may
                    # mean the worker already started AND can still
                    # deliver, so it never re-dispatches.
                    retryable = isinstance(e, ConnectionRefusedError) \
                        or (recover and
                            isinstance(e, _DEAD_TRANSPORT_ERRORS))
                    new = None
                    if retryable and attempt + 1 < attempts:
                        failed.add(self._routed_name(fwd))
                        new = self._redispatch(req, fwd, exclude=failed)
                    if new:
                        target = new
                        continue
                    self.scheduler.finish_request(req.service_request_id,
                                                  cancelled=True)
                    self._m_errors.inc()
                    self.scheduler.count_failed("worker_error")
                    robs.finished(error=True)
                    return Response.error(503, f"worker error: {e}")
                if status == 200:
                    break
                err = b"".join(body)        # drain + close the conn
                if status == 503 and attempt + 1 < attempts:
                    failed.add(self._routed_name(fwd))
                    new = self._redispatch(req, fwd, exclude=failed)
                    if new:
                        target = new
                        continue
                self.scheduler.finish_request(req.service_request_id,
                                              cancelled=True)
                self._m_errors.inc()
                self.scheduler.count_failed("worker_refused")
                robs.finished(error=True)
                return Response(status=status, body=err)

            trace_egress = self.tracer.egress_for(req.service_request_id)

            if recover:
                ledger = RelayLedger(
                    self.recovery, req,
                    is_chat=path.endswith("/chat/completions"))
                resp_obj = Response.sse(self._recoverable_relay(
                    req, fwd, path, body, ledger, robs, trace_egress,
                    failed))
                done = [False]
                first_body = body

                def on_close_rec() -> None:
                    # Never-started body backstop (see relay on_close
                    # below): drop the worker-side connection and drain
                    # the registry entry.
                    if done[0]:
                        return
                    done[0] = True
                    try:
                        first_body.close()
                    except Exception:  # noqa: BLE001 — worker socket
                        pass            # may already be dead
                    robs.finished(error=True)
                    self.scheduler.finish_request(req.service_request_id)
                resp_obj.on_close = on_close_rec
                return resp_obj

            def relay() -> Iterator[bytes]:
                try:
                    for chunk in body:
                        robs.first_token()
                        # Frame-count approximation of the token count:
                        # the relay proxies bytes without parsing, and
                        # one worker StepOutput is one SSE data frame.
                        # [DONE] is a terminator, not a StepOutput.
                        robs.add_tokens(chunk.count(b"data: ")
                                        - chunk.count(b"data: [DONE]"))
                        if trace_egress is not None:
                            trace_egress(chunk)
                        yield chunk
                except GeneratorExit:
                    # Client went away mid-stream: a truncated request
                    # must not pollute the latency histograms.
                    robs.finished(error=True)
                    raise
                except Exception:
                    # Worker died mid-relay (non-recoverable request):
                    # an aborted stream is an error, not an e2e/tpot
                    # sample.
                    self._m_errors.inc()
                    self.scheduler.count_failed("worker_error")
                    robs.finished(error=True)
                    raise
                finally:
                    robs.finished()
                    self.scheduler.finish_request(req.service_request_id)
            resp_obj = Response.sse(relay())
            done = [False]

            def on_close() -> None:
                # Backstop for a never-started body (client died during
                # header write): the generator finallies cannot run, but
                # the registry entry must drain and the worker-side
                # connection must drop or the worker generates the full
                # completion into a dead socket.
                if done[0]:
                    return
                done[0] = True
                try:
                    body.close()
                except Exception:  # noqa: BLE001 — the worker socket may
                    pass            # already be dead; drop is the intent
                # A never-started body means the client died during the
                # header write — not a completed request.
                robs.finished(error=True)
                self.scheduler.finish_request(req.service_request_id)
            resp_obj.on_close = on_close
            return resp_obj
        robs.dispatched(target)
        try:
            status, resp = self._send_with_redispatch(req, fwd, target,
                                                      path)
        except Exception as e:  # noqa: BLE001 — worker unreachable
            self.scheduler.finish_request(req.service_request_id,
                                          cancelled=True)
            self._m_errors.inc()
            self.scheduler.count_failed("worker_error")
            robs.finished(error=True)
            return Response.error(503, f"worker error: {e}")
        if isinstance(resp, dict):
            # Non-stream relay: the worker's first token is invisible
            # here (one response body); TTFT for this request merges in
            # from the worker-side span. Usage gives the exact count.
            robs.add_tokens((resp.get("usage") or {})
                            .get("completion_tokens", 0))
        robs.finished(error=status != 200)
        if status != 200:
            self._m_errors.inc()
            self.scheduler.count_failed(
                "engine_fault" if _engine_fault_error(resp) is not None
                else "worker_refused")
        self.scheduler.finish_request(req.service_request_id)
        self.tracer.trace(req.service_request_id,
                          {"stage": "egress", "body": resp})
        return Response.json(resp, status=status)

    # -- mid-stream recovery: the ledger-aware relay ----------------------
    def _recoverable_relay(self, req: SchedRequest, fwd: Dict[str, Any],
                           path: str, body, ledger: RelayLedger,
                           robs: _RequestObs, trace_egress,
                           failed: set) -> Iterator[bytes]:
        """Relay one recoverable SSE stream frame-by-frame. Every frame
        runs through the RelayLedger (token ids → the scheduler's
        delivered ledger; the ``"xllm"`` extension stripped before the
        client sees bytes). A mid-stream worker failure — broken socket
        or stream ending without its terminator — re-schedules onto a
        survivor, re-prefills prompt + delivered tokens as forced
        context, and splices the continuation into this SAME open
        stream. Exactly-once: the survivor never re-generates delivered
        tokens (they are its prompt), and the ledger is contiguous by
        frame order (docs/ROBUSTNESS.md)."""
        srid = req.service_request_id
        ctx = self.scheduler.recovery_ctx(srid) or {
            "budget": 0, "resumes": 0}
        try:
            while True:
                err: Optional[BaseException] = None
                try:
                    for payload in iter_sse_events(body):
                        if '"engine_fault"' in payload:
                            # Worker fault boundary blamed THIS request
                            # (typed in-stream error frame). Strike the
                            # poison ledger; below the threshold the
                            # frame is withheld and the request resumes
                            # on a survivor like any mid-stream death —
                            # at the threshold the client sees the
                            # typed fault.
                            try:
                                obj = json.loads(payload)
                            except ValueError:
                                obj = None
                            verdict = _engine_fault_error(obj)
                            if verdict is not None:
                                poisoned = \
                                    self.scheduler.note_engine_fault(
                                        srid, req.token_ids,
                                        self._routed_name(fwd), verdict)
                                if poisoned:
                                    self._m_errors.inc()
                                    self.scheduler.count_failed(
                                        "engine_fault")
                                    robs.finished(error=True)
                                    frame = _engine_fault_frame(verdict)
                                    if trace_egress is not None:
                                        trace_egress(frame)
                                    yield frame
                                    return
                                raise _EngineFaultResume(verdict)
                        # The yield stays OUTSIDE the section: a
                        # suspended generator would bill downstream
                        # socket writes to the relay.
                        with profiler.section("relay.frame"):
                            frame, n_new = ledger.on_payload(payload)
                        if frame is None:
                            # Suppressed (dup role chunk / held-back-only
                            # ledger frame) — its token ids still count.
                            robs.add_tokens(n_new)
                            continue
                        robs.first_token()
                        robs.add_tokens(n_new)
                        if trace_egress is not None:
                            trace_egress(frame)
                        yield frame
                except GeneratorExit:
                    # Client went away mid-stream: a truncated request
                    # must not pollute the latency histograms (and is
                    # not a recovery trigger).
                    robs.finished(error=True)
                    raise
                except Exception as e:  # noqa: BLE001 — the worker died
                    err = e             # mid-relay: the recovery trigger
                if ledger.done:
                    return
                if ledger.finished:
                    # Finish delta delivered but [DONE] died with the
                    # worker: the completion is whole — terminate
                    # cleanly instead of re-prefilling for nothing
                    # (synthesizing the usage chunk this death window
                    # may have swallowed from an include_usage client).
                    for frame in ledger.close_finished(
                            req.include_usage):
                        if trace_egress is not None:
                            trace_egress(frame)
                        yield frame
                    return
                # --- mid-stream failure → resume -----------------------
                try:
                    body.close()
                except Exception:  # noqa: BLE001 — dead worker socket
                    pass
                dead = self._routed_name(fwd)
                if dead:
                    failed.add(dead)
                delivered_n = len(self.scheduler.delivered_snapshot(srid))
                logger.warning(
                    "stream %s broke mid-relay on %s after %d tokens "
                    "(%s); attempting recovery", srid, dead, delivered_n,
                    err)
                if ledger.content_frames and not ledger.tokens_seen:
                    # Content reached the client but no frame carried the
                    # "xllm" token-id extension (version skew: a worker
                    # that ignores the additive ledger_tokens field) —
                    # the ledger is blind to what was delivered, so a
                    # resume would replay the whole completion into the
                    # open stream. Fail clean instead.
                    self._m_errors.inc()
                    self.scheduler.count_failed("recovery_unledgered")
                    self.recovery.note_failure(
                        req, dead, "unledgered_stream", mode="relay")
                    robs.finished(error=True)
                    raise RuntimeError(
                        f"worker died mid-stream and the stream carried "
                        f"no token ledger; not recoverable "
                        f"(last error: {err})")
                if delivered_n >= req.sampling.max_tokens:
                    # Died between the last token and the finish delta.
                    for frame in ledger.synthesize_finish(
                            req.include_usage):
                        if trace_egress is not None:
                            trace_egress(frame)
                        yield frame
                    self.recovery.note_success(
                        req, ctx, dead, "(synthesized)", delivered_n,
                        mode="relay")
                    return
                # Deadline anchored at THIS failure (not stream start:
                # a healthy stream may outlive request_timeout_s, and
                # recovery matters most for exactly those).
                reopened = self._reopen_stream(
                    req, fwd, path, ctx, failed, dead, robs,
                    time.monotonic() + self.opts.request_timeout_s)
                if reopened is None:
                    self._m_errors.inc()
                    self.scheduler.count_failed("recovery_exhausted")
                    self.recovery.note_failure(
                        req, dead, "no_surviving_instance", mode="relay")
                    robs.finished(error=True)
                    if isinstance(err, _EngineFaultResume):
                        # The withheld fault frame was pending a resume
                        # that never came — surface the typed error
                        # instead of an opaque broken stream.
                        frame = _engine_fault_frame(err.verdict)
                        if trace_egress is not None:
                            trace_egress(frame)
                        yield frame
                        return
                    raise RuntimeError(
                        f"worker died mid-stream and recovery was "
                        f"exhausted (last error: {err})")
                body, fwd = reopened
                ledger.resumed = True
        finally:
            try:
                body.close()    # deterministic worker-conn release
            except Exception:  # noqa: BLE001 — may already be dead/closed
                pass
            robs.finished()
            self.scheduler.finish_request(srid)

    def _reopen_stream(self, req: SchedRequest, fwd: Dict[str, Any],
                       path: str, ctx: Dict[str, Any], failed: set,
                       dead: str, robs: _RequestObs,
                       deadline: float):
        """One-or-more resume attempts for a broken recoverable relay:
        re-schedule excluding every failed instance, forward the
        forced-context resume body, and eagerly open the continuation
        stream. Returns ``(body_iterator, resume_fwd)`` or None when
        the per-request budget / surviving instances / deadline are
        exhausted."""
        if ctx["resumes"] >= ctx["budget"]:
            return None
        # One budget unit per FAILOVER EVENT (mirrors begin_rpc_resume);
        # the reroute/dispatch walk below runs under the retry policy's
        # own attempt budget without burning resume budget — a reroute
        # that finds no candidate while a replacement boots must not
        # exhaust the failover allowance.
        ctx["resumes"] += 1
        for attempt in range(self.retry.max_attempts):
            if time.monotonic() > deadline:
                return None
            delivered = self.scheduler.resume_ledger(
                req.service_request_id)
            fwd2 = self.recovery.resume_fwd(fwd, req, delivered)
            name, addr = self.recovery.reroute(req, fwd2, failed)
            if name is None:
                if not self.retry.sleep(attempt, deadline=deadline):
                    return None
                continue
            robs.dispatched(addr)           # records "redispatched"
            try:
                status, new_body = http_stream_status(
                    "POST", addr, path, fwd2,
                    timeout=self.opts.request_timeout_s,
                    headers=self._fwd_headers(req))
            except Exception as e:  # noqa: BLE001 — survivor gone too:
                failed.add(name)    # exclude it and walk the next one
                logger.warning("resume of %s on %s failed: %s",
                               req.service_request_id, name, e)
                if not self.retry.sleep(attempt, deadline=deadline):
                    return None
                continue
            if status != 200:
                b"".join(new_body)          # drain + close
                failed.add(name)
                logger.warning("resume of %s on %s refused: %d",
                               req.service_request_id, name, status)
                if not self.retry.sleep(attempt, deadline=deadline):
                    return None
                continue
            ctx["fwd"] = fwd2
            self.recovery.note_success(req, ctx, dead, name,
                                       len(delivered), mode="relay")
            self.tracer.trace(req.service_request_id,
                              {"stage": "recovered", "from": dead,
                               "to": name,
                               "delivered": len(delivered)})
            logger.info("recovered %s: %s -> %s (%d tokens delivered)",
                        req.service_request_id, dead, name,
                        len(delivered))
            return new_body, fwd2
        return None

    # -- topology 2: decode → service RPC fan-in --------------------------
    def _rpc_mode_response(self, req: SchedRequest, fwd: Dict[str, Any],
                           target: str, path: str, is_chat: bool,
                           robs: _RequestObs) -> Response:
        out_q: "queue.Queue[Optional[RequestOutput]]" = queue.Queue()

        def on_output(out: RequestOutput) -> bool:
            out_q.put(out)
            if out.finished or out.cancelled:
                out_q.put(None)
            return True

        self.scheduler.record_new_request(req, on_output)
        # RPC-mode requests are recoverable out of the box: token ids
        # arrive at the fan-in, so the scheduler's ledger is authoritative
        # and fail_requests_on_instance resumes instead of cancelling.
        if self.recovery.recoverable(req):
            self.recovery.arm(req, fwd, path, owner="rpc")
        robs.dispatched(target)
        try:
            status, ack = self._send_with_redispatch(req, fwd, target,
                                                     path)
            if status != 200:
                raise RuntimeError(f"worker returned {status}: {ack}")
        except Exception as e:  # noqa: BLE001
            self.scheduler.finish_request(req.service_request_id,
                                          cancelled=True)
            self._m_errors.inc()
            self.scheduler.count_failed("worker_error")
            robs.finished(error=True)
            return Response.error(503, f"worker error: {e}")

        timeout = self.opts.request_timeout_s

        def next_output() -> Optional[RequestOutput]:
            """None = finished sentinel; raises queue.Empty on timeout —
            a worker that acked then died must not hang the client."""
            out = out_q.get(timeout=timeout)
            if out is not None:
                robs.first_token()
                robs.add_tokens(sum(len(s.token_ids)
                                    for s in out.outputs))
            return out

        if req.stream:
            asm = (ChatStreamAssembler if is_chat
                   else CompletionStreamAssembler)(
                req.service_request_id, req.model, req.include_usage)

            trace_egress = self.tracer.egress_for(req.service_request_id)

            def gen() -> Iterator[bytes]:
                try:
                    while True:
                        try:
                            out = next_output()
                        except queue.Empty:
                            self.scheduler.finish_request(
                                req.service_request_id, cancelled=True)
                            self.scheduler.count_failed("timeout")
                            robs.finished(error=True)
                            frame = (b'data: {"error": {"message": '
                                     b'"generation timed out", '
                                     b'"type": "timeout"}}\n\n')
                            if trace_egress is not None:
                                trace_egress(frame)
                            yield frame
                            return
                        if out is None:
                            return
                        verdict = _engine_fault_status(out)
                        if verdict is not None:
                            # Poisoned at the fan-in (the scheduler
                            # swallows below-threshold faults into RPC
                            # resumes; only terminal verdicts reach
                            # this queue).
                            self._m_errors.inc()
                            robs.finished(error=True)
                            frame = _engine_fault_frame(verdict)
                            if trace_egress is not None:
                                trace_egress(frame)
                            yield frame
                            return
                        for frame in asm.on_output(out):
                            if trace_egress is not None:
                                trace_egress(frame)
                            yield frame
                except GeneratorExit:
                    robs.finished(error=True)   # truncated by the client
                    raise
                finally:
                    robs.finished()
            resp_obj = Response.sse(gen())

            def on_close() -> None:
                # Never-started body (client died during header write):
                # close the span as an error, not a latency sample; a
                # normally-finished stream already sealed it (no-op).
                robs.finished(error=True)
            resp_obj.on_close = on_close
            return resp_obj

        coll = ResponseCollector(req.service_request_id, req.model, is_chat,
                                 target_n=max(1, req.sampling.n))
        while True:
            try:
                out = next_output()
            except queue.Empty:
                self.scheduler.finish_request(req.service_request_id,
                                              cancelled=True)
                self._m_errors.inc()
                self.scheduler.count_failed("timeout")
                robs.finished(error=True)
                self.tracer.trace(req.service_request_id,
                                  {"stage": "egress", "status": 504,
                                   "error": "generation timed out"})
                return Response.error(504, "generation timed out",
                                      "timeout")
            if out is None:
                break
            verdict = _engine_fault_status(out)
            if verdict is not None:
                self._m_errors.inc()
                robs.finished(error=True)
                self.tracer.trace(req.service_request_id,
                                  {"stage": "egress", "status": 500,
                                   "error": verdict})
                return Response.error(500, verdict, "engine_fault")
            coll.add(out)
        final = coll.body()
        robs.finished()
        self.tracer.trace(req.service_request_id,
                          {"stage": "egress", "body": final})
        return Response.json(final)

    # ------------------------------------------------------------------
    # Embeddings — implemented for real (the reference returns
    # "not support", service.cpp:492): routed to a least-loaded worker.
    # ------------------------------------------------------------------
    def _embeddings(self, http_req: Request) -> Response:
        try:
            body = http_req.json()
        except (ValueError, json.JSONDecodeError):
            return Response.error(400, "invalid JSON body")
        if not body.get("input"):
            return Response.error(400, "input is required")
        name = self.scheduler.pick_serving_instance()
        target = self.scheduler.instance_mgr.address_of(name) if name \
            else None
        if target is None:
            return Response.error(503, "no instance available")
        try:
            status, resp = http_json("POST", target, "/v1/embeddings",
                                     body, timeout=300.0)
        except Exception as e:  # noqa: BLE001 — the 503 carries the
            # error straight back to the client
            return Response.error(503, f"worker error: {e}")
        return Response.json(resp, status=status)

    # ------------------------------------------------------------------
    # Models / metrics — service-local (improves on the reference proxy)
    # ------------------------------------------------------------------
    def _models(self, http_req: Request) -> Response:
        mgr = self.scheduler.instance_mgr
        models: Dict[str, str] = {}
        for name in mgr.names():
            inst = mgr.get(name)
            if inst is None:
                continue
            for m, state in inst.model_states.items():
                if m not in models or state == "awake":
                    models[m] = state
        return Response.json({
            "object": "list",
            "data": [{"id": m, "object": "model",
                      "owned_by": "xllm-service-tpu", "state": st}
                     for m, st in sorted(models.items())]})

    def _metrics(self, http_req: Request) -> Response:
        return Response(body=self._render_metrics().encode(),
                        content_type="text/plain; version=0.0.4")

    def _render_metrics(self) -> str:
        """Refresh scrape-time mirrors from live state, then render the
        whole registry (series names unchanged from the hand-assembled
        exporter this replaced; the metrics-registry xlint rule keeps it
        that way). Shared by /metrics and the debug bundle so both show
        the same picture."""
        obs = self.obs
        mgr = self.scheduler.instance_mgr
        obs.gauge("xllm_service_tracked_requests").set(
            self.scheduler.num_tracked_requests())
        obs.gauge("xllm_service_instances").set(len(mgr.names()))
        obs.gauge("xllm_service_prefill_instances").set(
            len(mgr.prefill_instances()))
        obs.gauge("xllm_service_decode_instances").set(
            len(mgr.decode_instances()))
        obs.gauge("xllm_service_cache_blocks").set(
            self.scheduler.kvcache_mgr.num_blocks())
        obs.gauge("xllm_service_is_master").set(
            1 if self.scheduler.is_master else 0)
        # Control-plane outage visibility (service/store_guard.py +
        # fenced epochs, docs/ROBUSTNESS.md): store health 2/1/0
        # (healthy/flaky/down), whether this plane is serving from the
        # frozen last-known-good table, and the current master epoch.
        obs.gauge("xllm_store_health",
                  "coordination-store health as seen by this plane "
                  "(2 healthy / 1 flaky / 0 down)").set(
            self.scheduler.store_health())
        obs.gauge("xllm_service_degraded",
                  "1 while serving from the frozen instance table "
                  "during a store outage").set(
            1 if self.scheduler.degraded else 0)
        obs.gauge("xllm_service_epoch",
                  "fenced master epoch this replica carries").set(
            self.scheduler.current_epoch())
        # Keep-alive reuse pool: regressions show here as hit:miss
        # decay / overflow growth before they show as service_bench
        # latency. The pool is PROCESS-global (httpd._POOL), so the
        # plane label marks the exporting process — in the normal
        # separate-process deployment this is the service→worker
        # transport; co-located planes (the test harness) export the
        # same series under distinct labels instead of colliding.
        from xllm_service_tpu_torch.service.httpd import flush_conn_pool_metrics
        flush_conn_pool_metrics(obs, plane="service")
        # Supervised-thread crash / swallowed-callback books
        # (utils/threads.py — process-global, root-labeled).
        threads.flush_metrics(obs)
        # Admission pressure (set by Master after server construction):
        # active slots + total 503-rejected per server.
        for srv_name, adm in (self.admissions or {}).items():
            obs.gauge("xllm_service_admission_active",
                      labelnames=("server",)).set(adm.active,
                                                  server=srv_name)
            obs.counter("xllm_service_admission_rejected_total",
                        labelnames=("server",)).set_total(
                adm.rejected_total, server=srv_name)
        # Per-instance load: rebuilt from scratch each scrape so gauges
        # for departed instances don't linger forever.
        g_wait = obs.gauge("xllm_instance_waiting_requests",
                           labelnames=("instance",))
        g_run = obs.gauge("xllm_instance_running_requests",
                          labelnames=("instance",))
        g_kv = obs.gauge("xllm_instance_kv_cache_usage",
                         labelnames=("instance",))
        for g in (g_wait, g_run, g_kv):
            g.clear()
        for name in mgr.names():
            inst = mgr.get(name)
            if inst is None:
                continue
            g_wait.set(inst.load.waiting_requests, instance=name)
            g_run.set(inst.load.running_requests, instance=name)
            g_kv.set(inst.load.kv_cache_usage, instance=name)
        # The judgment layer: SLO gauges, event totals, open anomalies,
        # and span-ring eviction visibility (all scrape-time mirrors of
        # state the slo/events/watchdog objects own).
        self.slo.export(obs)
        c_events = obs.counter("xllm_events_total",
                               "cluster events emitted, by type",
                               labelnames=("type",))
        for ev_type, n in self.events.counts().items():
            c_events.set_total(n, type=ev_type)
        self.watch.export(obs)
        obs.counter(
            "xllm_span_evictions_total",
            "request spans dropped by ring overflow "
            "(size the ring with XLLM_SPAN_RING)").set_total(
            self.spans.eviction_count())
        obs.counter(
            "xllm_service_timeline_exports_total",
            "cluster-merged /admin/timeline documents served").set_total(
            self._timeline_exports)
        # The master watching itself: hot-path section books, sampled
        # lock contention, per-root thread CPU, and self-gauges
        # (obs/profiler.py — scrape-time mirrors, same pattern as above).
        profiler.flush_metrics(obs)
        return obs.render()

    # ------------------------------------------------------------------
    # Cross-plane request spans: GET /admin/trace/<service_request_id>
    # ------------------------------------------------------------------
    def _admin_trace(self, http_req: Request) -> Response:
        rid = http_req.path[len("/admin/trace/"):]
        if not rid:
            return Response.error(400, "missing request id")
        span = self.spans.get(rid)
        if span is None:
            if self.spans.was_evicted(rid):
                # 410 Gone: the ring HELD this id and evicted it — a
                # different answer than "never seen" (404), so an
                # operator knows to grow XLLM_SPAN_RING rather than
                # doubt the request ever existed.
                return Response.json(
                    {"evicted": True, "request_id": rid,
                     "detail": "span evicted from the ring — size it "
                               "with XLLM_SPAN_RING"}, status=410)
            return Response.error(
                404, f"no span for {rid!r} (never seen, or evicted "
                     f"from the ring — size it with XLLM_SPAN_RING)")
        return Response.json(span)

    # ------------------------------------------------------------------
    # The judgment layer's query surface: SLO state, cluster events,
    # and the one-shot flight-recorder snapshot
    # ------------------------------------------------------------------
    def _admin_slo(self, http_req: Request) -> Response:
        """Current SLO state. Reads run a (rate-limited) tick first so
        the answer reflects NOW, not the last watchdog cadence."""
        return Response.json(self.slo.tick())

    def _admin_events(self, http_req: Request) -> Response:
        try:
            since = int(http_req.param("since", "0") or 0)
            limit = int(http_req.param("limit", "256") or 256)
        except ValueError:
            return Response.error(400, "since/limit must be integers")
        events = self.events.since(since, limit=max(1, limit))
        return Response.json({
            "events": events,
            "latest_seq": self.events.latest_seq,
            "dropped_total": self.events.dropped,
            # A reader that polls with since=<last seen> detects ring
            # truncation by the seq gap; next_since makes the resume
            # cursor explicit.
            "next_since": events[-1]["seq"] if events else since})

    def _admin_debug_bundle(self, http_req: Request) -> Response:
        """One-shot post-mortem flight recorder: everything an engineer
        pages through after an incident, as a single JSON document —
        cluster membership, in-flight requests, recent events, open
        anomalies, SLO state, recent finished spans, live flags, and the
        full rendered metrics exposition."""
        scheduler = self.scheduler
        bundle = {
            "captured_at": time.time(),
            "service_id": scheduler.service_id,
            "is_master": scheduler.is_master,
            "flags": {k: getattr(self.opts, k)
                      for k in self._RELOADABLE},
            "instances": scheduler.instance_mgr.instance_table(),
            "tracked_requests": scheduler.tracked_requests_info(),
            # The NEWEST ≤256 events (since() pages oldest-first; a
            # post-mortem wants the most recent history).
            "events": self.events.since(
                max(0, self.events.latest_seq - 256)),
            "anomalies": self.watch.active(),
            "slo": self.slo.tick(),
            "spans": {
                "size": len(self.spans),
                "evictions_total": self.spans.eviction_count(),
                "recent_finished": self.spans.tail(
                    32, finished_only=True)},
            # The self-profile snapshot (sections/locks/thread-CPU/GC)
            # WITHOUT a stack-sampling pass — the bundle must stay
            # cheap; hit /admin/profile?seconds=N for stacks.
            "profile": profiler.snapshot(),
            # Device-plane step flight recorder, as heartbeats shipped
            # it (no live worker pulls — the bundle must stay cheap and
            # answer even when the fleet doesn't): per-instance step-
            # record tails for the incident's last minutes.
            "steptrace": {
                name: self.step_books.tail(name, n=64)
                for name in self.step_books.instances()},
            "metrics": self._render_metrics(),
        }
        return Response.json(bundle)

    def _admin_timeline(self, http_req: Request) -> Response:
        """Cluster-merged Perfetto/chrome-trace export
        (obs/timeline.py): service-plane request spans + hot-path
        section slices + every worker's step flight recorder, one
        chrome://tracing-loadable JSON document. Workers are pulled
        live from ``GET /admin/steptrace`` (bounded timeout); a worker
        that doesn't answer degrades to its heartbeat-shipped StepBooks
        tail instead of failing the whole export."""
        try:
            window_s = float(http_req.param(
                "seconds", str(self._timeline_window_s))
                or self._timeline_window_s)
        except ValueError:
            window_s = self._timeline_window_s
        scheduler = self.scheduler
        workers: Dict[str, Dict[str, Any]] = {}
        for name in scheduler.instance_mgr.names():
            addr = scheduler.instance_mgr.address_of(name)
            pulled = None
            if addr is not None:
                try:
                    status, resp = http_json(
                        "GET", addr,
                        f"/admin/steptrace?seconds={window_s:g}",
                        timeout=5.0)
                    if status == 200 and isinstance(resp, dict):
                        pulled = resp
                except Exception:  # noqa: BLE001 — degrade to books
                    pulled = None
            if pulled is not None:
                workers[name] = {
                    "steps": pulled.get("steps", []),
                    "sections": pulled.get("sections", [])}
            else:
                workers[name] = {
                    "steps": self.step_books.tail(name),
                    "sections": []}
        trace = timeline.build_timeline(
            service_id=scheduler.service_id,
            spans=self.spans.tail(256),
            sections=profiler.recent_events(window_s=window_s),
            workers=workers,
            window_s=window_s,
            master_counters={
                "instances": float(len(workers)),
                "tracked_requests": float(
                    len(scheduler.tracked_requests_info()))})
        self._timeline_exports += 1
        return Response(body=timeline.render(trace).encode("utf-8"),
                        content_type="application/json")

    def _admin_profile(self, http_req: Request) -> Response:
        """Self-profile on demand: the live section/lock-contention/
        thread-CPU tables plus (with ``?seconds=N``, default 1) a
        ``sys._current_frames`` stack-sampling pass over that window —
        collapsed stacks and top functions, JSON. ``seconds=0`` skips
        sampling and returns the tables alone. The admission gate
        exempts /admin/, so this answers even at saturation — which is
        exactly when it's needed."""
        try:
            seconds = float(http_req.param("seconds", "1") or 1.0)
            hz = float(http_req.param("hz", "50") or 50.0)
        except ValueError:
            return Response.error(400, "seconds/hz must be numbers")
        out = profiler.snapshot()
        if seconds > 0:
            out["stacks"] = profiler.sample_stacks(seconds, hz=hz)
        return Response.json(out)

    # ------------------------------------------------------------------
    # Fault injection surface: arm failpoints on this plane or (with
    # {"instance": <name>}) proxy the arming to a worker's own endpoint
    # — the chaos tests' runtime lever (docs/ROBUSTNESS.md).
    # ------------------------------------------------------------------
    def _admin_failpoint(self, http_req: Request) -> Response:
        try:
            body = http_req.json()
        except (ValueError, json.JSONDecodeError):
            return Response.error(400, "invalid JSON body")
        if not isinstance(body, dict):
            return Response.error(400, "body must be a JSON object")
        instance = body.pop("instance", None)
        if instance == "*":
            # Broadcast arming (chaos harness): every registered worker
            # gets the same spec; per-instance results ride the payload
            # so a partially reachable fleet is visible to the caller.
            results: Dict[str, Any] = {}
            for name in self.scheduler.instance_mgr.names():
                addr = self.scheduler.instance_mgr.address_of(name)
                if addr is None:
                    results[name] = "unknown address"
                    continue
                try:
                    status, resp = http_json("POST", addr,
                                             "/admin/failpoint",
                                             dict(body), timeout=10.0)
                    results[name] = status
                except Exception as e:  # noqa: BLE001 — worker
                    results[name] = str(e)   # unreachable: report it
            return Response.json({"ok": True, "results": results})
        if instance:
            addr = self.scheduler.instance_mgr.address_of(instance)
            if addr is None:
                return Response.error(
                    404, f"unknown instance {instance}")
            try:
                status, resp = http_json("POST", addr,
                                         "/admin/failpoint", body,
                                         timeout=10.0)
            except Exception as e:  # noqa: BLE001 — worker unreachable
                return Response.error(503, f"worker error: {e}")
            return Response.json(resp, status=status)
        try:
            self.failpoints.arm_from_body(body)
        except (TypeError, ValueError) as e:
            return Response.error(400, str(e))
        return Response.json({"ok": True,
                              "state": self.failpoints.state()})

    def _admin_failpoints_get(self, http_req: Request) -> Response:
        return Response.json(self.failpoints.state())

    # ------------------------------------------------------------------
    # Manual sleep/wakeup (service.cpp:510-550)
    # ------------------------------------------------------------------
    def _model_triggers(self, http_req: Request) -> Response:
        body = http_req.json()
        model = body.get("model", "")
        action = body.get("action", "")
        if action not in ("sleep", "wakeup"):
            return Response.error(400, "action must be sleep|wakeup")
        mgr = self.scheduler.instance_mgr
        targets = ([body["instance"]] if body.get("instance")
                   else mgr.names())
        results: Dict[str, Any] = {}
        for name in targets:
            inst = mgr.get(name)
            if inst is None or model not in inst.model_states:
                continue
            try:
                status, resp = mgr.control(
                    inst.meta.rpc_address, f"/{action}", {"model": model})
                if status == 200:
                    inst.model_states[model] = (
                        "asleep" if action == "sleep" else "awake")
                results[name] = status
            except Exception as e:  # noqa: BLE001 — the error rides the
                results[name] = str(e)  # per-instance results payload
        if not results:
            return Response.error(404,
                                  f"model {model} not found on any instance")
        return Response.json({"ok": True, "results": results})

    # ------------------------------------------------------------------
    # Hot-reloadable SLO flags (the reference marks target_ttft /
    # target_tpot brpc-reloadable, global_gflags.cpp:95-104; here any
    # field in _RELOADABLE flips at runtime — ServiceOptions is shared by
    # reference with the scheduler and InstanceMgr, so routing sees the
    # new thresholds on the next request)
    # ------------------------------------------------------------------
    # max_concurrency reloads live because the servers' Admission reads
    # opts through a callable (master.py) — 0 disables the limit.
    _RELOADABLE = ("target_ttft_ms", "target_tpot_ms", "max_concurrency")
    _INT_FLAGS = ("max_concurrency",)
    _ZERO_OK = ("max_concurrency",)

    def _admin_flags_get(self, http_req: Request) -> Response:
        return Response.json(
            {k: getattr(self.opts, k) for k in self._RELOADABLE})

    def _admin_flags(self, http_req: Request) -> Response:
        try:
            body = http_req.json()
        except ValueError:
            return Response.error(400, "invalid JSON body")
        if not isinstance(body, dict):
            return Response.error(400, "body must be a JSON object")
        unknown = [k for k in body if k not in self._RELOADABLE]
        if unknown:
            return Response.error(
                400, f"not reloadable: {unknown}; "
                     f"reloadable flags: {list(self._RELOADABLE)}")
        # Validate everything BEFORE mutating anything: a 400 must leave
        # the service exactly as it was, never half-reconfigured.
        validated = {}
        for k, v in body.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                return Response.error(400, f"{k} must be a number")
            floor_ok = val >= 0 if k in self._ZERO_OK else val > 0
            if not (math.isfinite(val) and floor_ok):
                return Response.error(
                    400, f"{k} must be a positive finite number")
            validated[k] = int(val) if k in self._INT_FLAGS else val
        for k, val in validated.items():
            setattr(self.opts, k, val)
        logger.info("admin flag reload: %s", validated)
        return Response.json({"ok": True, "updated": validated})
