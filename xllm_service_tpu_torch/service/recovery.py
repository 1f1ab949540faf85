"""Mid-stream request recovery: worker death becomes a resume, not an
error.

A copy of the JAX package's ``service/recovery.py``: the same behaviour
and names, importing only this package (and no device code).

The reference claims "fast detection of instance error and automatic
rescheduling" but never implements re-dispatch (SURVEY.md §5.3); this
service used to redispatch only refusal-class failures (503 / refused
connection) *before* any work started — a worker dying mid-generation
cancelled every in-flight request. This module closes that gap
(docs/ROBUSTNESS.md) for both response topologies:

- **relay streaming**: the front door forwards the stream through a
  ledger-aware relay (the worker's ``"xllm"`` frame extension carries
  token ids, stripped before bytes reach the client). When the worker
  socket breaks mid-stream, the relay re-schedules onto a survivor,
  re-prefills prompt + delivered tokens as forced context, and splices
  the continuation into the still-open SSE stream.
- **RPC fan-in**: the scheduler's delivered-token ledger is fed by
  ``handle_generation``; when ``fail_requests_on_instance`` fires for
  a recoverable request, ``begin_rpc_resume`` re-dispatches the same
  forced-context resume to a survivor, whose pushes continue into the
  same per-request fan-in queue.

Exactly-once is by construction: the resume prompt IS the delivered
ledger, so the survivor only ever generates tokens the client has not
seen (no gap — the ledger is contiguous by frame order; no repeat —
forced tokens are prompt, never re-emitted), and a straggler push from
the deposed instance is dropped by the scheduler's source guard. At
``temperature=0`` the continuation is byte-identical to an unfailed
run (greedy decoding depends only on the forced context).

Recoverable = streaming relay or RPC topology, single choice (``n==1``,
no ``best_of`` pool), no ``echo``/``logprobs`` (their offsets/prompt
scores don't survive a re-prefill), no stop strings (a stop spanning
the failure boundary could over-generate), no multimodal inputs —
within a per-request resume budget (``XLLM_RECOVERY_RETRIES``).
Everything else keeps today's behavior: a prompt, countable error.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.config import ServiceOptions
from xllm_service_tpu_torch.obs.spans import REQUEST_ID_HEADER
from xllm_service_tpu_torch.service.instance_types import RequestPhase
from xllm_service_tpu_torch.service.response_handler import SSE_DONE, sse_frame
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy
from xllm_service_tpu_torch.utils.threads import spawn
from xllm_service_tpu_torch.utils.types import (
    Request as SchedRequest, Routing, Usage)

logger = logging.getLogger(__name__)

# Zero-copy relay scan (the saturation sweep's spent finding,
# docs/PERF_NOTES.md service-plane round): when on, RelayLedger
# forwards plain mid-stream delta frames VERBATIM after a pure
# substring scan instead of json.loads + re-serialization per frame.
# Read once at import — hot-path flag discipline (docs/FLAGS.md).
RELAY_ZEROCOPY = os.environ.get(
    "XLLM_RELAY_ZEROCOPY", "").strip() in ("1", "true", "yes")


class RecoveryManager:
    """Per-service recovery policy + mechanics. Wired onto the
    scheduler by HttpService (``scheduler.recovery``), like
    spans/obs."""

    def __init__(self, opts: ServiceOptions, scheduler, spans, events,
                 obs, failpoints) -> None:
        self.opts = opts
        self.scheduler = scheduler
        self.spans = spans
        self.events = events
        self.obs = obs
        self.failpoints = failpoints
        self.enabled = os.environ.get("XLLM_RECOVERY", "1") != "0"
        # Per-request resume budget: how many times one request may be
        # failed over before it becomes a client-visible error.
        try:
            self.budget = int(
                os.environ.get("XLLM_RECOVERY_RETRIES", "") or 2)
        except ValueError:
            self.budget = 2
        self.retry = RetryPolicy.from_env()
        # Render both outcomes from boot so dashboards (and the chaos
        # tests' scrapes) see the series before the first failover.
        c = self._recoveries()
        c.inc(0.0, result="success")
        c.inc(0.0, result="failed")

    def _recoveries(self):
        return self.obs.counter(
            "xllm_request_recoveries_total",
            "mid-stream failovers by outcome (success = the stream "
            "resumed on a survivor; failed = budget/alternates "
            "exhausted and the client saw an error)",
            labelnames=("result",))

    # ------------------------------------------------------------------
    # Policy
    # ------------------------------------------------------------------
    def recoverable(self, req: SchedRequest) -> bool:
        """Whether this request's contract survives a forced-context
        re-prefill (module docstring). Callers additionally gate on
        topology (relay requires ``req.stream``)."""
        if not self.enabled or self.budget <= 0:
            return False
        sp = req.sampling
        return (sp.n == 1 and (sp.best_of or 1) <= 1 and not sp.echo
                and not sp.logprobs and not sp.stop
                and not req.mm_inputs)

    def arm(self, req: SchedRequest, fwd: Dict[str, Any], path: str,
            owner: str) -> Dict[str, Any]:
        """Attach a recovery context to the tracked request. For the
        relay topology this also switches the forward to the ledger
        extension (the worker emits token ids per frame; the relay
        strips them)."""
        if owner == "relay":
            fwd["ledger_tokens"] = True
        ctx: Dict[str, Any] = {
            "owner": owner, "fwd": fwd, "path": path,
            "budget": self.budget, "resumes": 0, "recovered": False,
            "resuming": False, "failed": set()}
        self.scheduler.arm_recovery(req.service_request_id, ctx)
        return ctx

    # ------------------------------------------------------------------
    # Shared mechanics
    # ------------------------------------------------------------------
    def resume_fwd(self, fwd: Dict[str, Any], req: SchedRequest,
                   delivered: List[int]) -> Dict[str, Any]:
        """The resume forward body: prompt + delivered ledger as forced
        context, completion budget reduced by what the client already
        has. The worker sees an ordinary request — the resume-accept
        path is its normal prefill."""
        fwd2 = dict(fwd)
        fwd2["token_ids"] = list(req.token_ids) + list(delivered)
        sp = dict(fwd.get("sampling") or req.sampling.to_json())
        sp["max_tokens"] = max(
            int(req.sampling.max_tokens) - len(delivered), 1)
        fwd2["sampling"] = sp
        return fwd2

    def reroute(self, req: SchedRequest, fwd: Dict[str, Any],
                exclude=()) -> Tuple[Optional[str], Optional[str]]:
        """Pick a surviving instance for ``req``, excluding every
        already-failed one, reversing the schedule bookkeeping of
        rejected candidates and of the instance the request is leaving.
        Rewrites ``fwd["routing"]`` and retargets the request registry.
        Returns ``(instance_name, address)`` or ``(None, None)``."""
        sched = self.scheduler
        mgr = sched.instance_mgr
        orig_routing = req.routing
        old = req.routing.prefill_name if req.routing else ""
        exclude = set(exclude)
        if old:
            exclude.add(old)
        if self.failpoints is not None and \
                self.failpoints.fire(
                    "service.fail_redispatch") is not None:
            return None, None
        n_prompt = len(req.token_ids)
        tries = min(8, max(2, len(mgr.names())))
        last_rejected = None
        for _ in range(tries):
            status, routing = sched.schedule(req)
            if not status.ok:
                # The scheduler's refusal (admission, model placement)
                # is authoritative — the pool fallback below is
                # model-blind and must not route around it.
                req.routing = orig_routing
                return None, None
            name = routing.prefill_name
            addr = mgr.address_of(name)
            if name in exclude or addr is None:
                # Rejected candidate (already failed, or gone between
                # schedule and address lookup): undo its SCHEDULE
                # increment and try the next alternate.
                mgr.update_request_metrics(
                    name, RequestPhase.UNSCHEDULE, n_prompt)
                exclude.add(name)
                if name == last_rejected:
                    # A deterministic policy (cache-aware / SLO-aware)
                    # returns the same winner every call — looping the
                    # remaining tries cannot help.
                    break
                last_rejected = name
                continue
            if routing.kv_fetch and \
                    routing.kv_fetch.get("holder") in exclude:
                # The freshly planned fetch elects an instance this
                # walk already failed AWAY from (typically the dead
                # worker, whose published prefix digests outlive it
                # until lease expiry): executing it would stall the
                # survivor's recovery TTFT on the fetch timeout before
                # the recompute fallback. Drop the plan, keep the
                # placement.
                routing.kv_fetch = None
            return self._adopt_routing(req, fwd, routing, old, n_prompt)
        # Policy fallback: a deterministic policy can keep electing an
        # excluded instance (e.g. the dead one still prefix-matches the
        # forced context best until its lease expires). Recovery must
        # not exhaust its budget on that — pick the least-loaded
        # survivor directly from the pool.
        pool = [n for n in mgr.prefill_instances()
                if n not in exclude and mgr.address_of(n) is not None]
        pool = mgr.filter_model_awake(pool, req.model)
        name = mgr.least_loaded_instance(pool) if pool else None
        if name is None:
            # Failed walk: schedule() left req.routing on the last
            # REJECTED candidate (whose SCHEDULE increment was already
            # undone). Restore the departing routing, or the caller's
            # next reroute attempt would compute old = that rejected
            # candidate and UNSCHEDULE it a second time (negative
            # ledger) while the real old instance's increment leaks.
            req.routing = orig_routing
            return None, None
        mgr.update_request_metrics(name, RequestPhase.SCHEDULE, n_prompt)
        routing = Routing(prefill_name=name, decode_name=name)
        req.routing = routing
        return self._adopt_routing(req, fwd, routing, old, n_prompt)

    def _adopt_routing(self, req: SchedRequest, fwd: Dict[str, Any],
                       routing, old: str, n_prompt: int
                       ) -> Tuple[str, str]:
        """Commit an accepted reroute: release the departed instance's
        schedule bookkeeping, retarget the registry, rewrite the
        forward body."""
        mgr = self.scheduler.instance_mgr
        if old:
            mgr.update_request_metrics(
                old, RequestPhase.UNSCHEDULE, n_prompt)
        self.scheduler.retarget_request(req.service_request_id, routing)
        fwd["routing"] = routing.to_json()
        return routing.prefill_name, mgr.address_of(routing.prefill_name)

    def note_success(self, req: SchedRequest, ctx: Dict[str, Any],
                     dead: str, to: str, delivered: int,
                     mode: str) -> None:
        ctx["recovered"] = True
        self._recoveries().inc(result="success")
        self.spans.record(req.service_request_id, "recovered",
                          from_instance=dead, to=to,
                          delivered_tokens=delivered)
        self.events.emit("request_recovered",
                         service_request_id=req.service_request_id,
                         from_instance=dead, to=to,
                         delivered=delivered, mode=mode)

    def note_failure(self, req: SchedRequest, dead: str, reason: str,
                     mode: str) -> None:
        self._recoveries().inc(result="failed")
        self.events.emit("recovery_failed",
                         service_request_id=req.service_request_id,
                         from_instance=dead, reason=reason, mode=mode)

    # ------------------------------------------------------------------
    # RPC-topology resume (driven by fail_requests_on_instance)
    # ------------------------------------------------------------------
    def begin_rpc_resume(self, tracked, dead: str) -> bool:
        """Claim one resume attempt for a tracked RPC-mode request and
        run it off-thread (the caller is the store's lease-expiry sweep
        — it must never block on worker HTTP). Returns False when the
        budget is exhausted (caller falls back to cancel)."""
        ctx = tracked.recovery
        if ctx is None or not self.enabled:
            return False
        with self.scheduler._req_lock:
            if ctx["resuming"]:
                return True         # a concurrent failure already claimed it
            if ctx["resumes"] >= ctx["budget"]:
                return False
            ctx["resuming"] = True
            ctx["resumes"] += 1
        spawn("recovery.resume_rpc", self._resume_rpc,
              args=(tracked, dead),
              thread_name=(f"recovery-"
                           f"{tracked.request.service_request_id}")
              ).start()
        return True

    def _resume_rpc(self, tracked, dead: str) -> None:
        req = tracked.request
        ctx = tracked.recovery
        srid = req.service_request_id
        ctx["failed"].add(dead)
        try:
            delivered = self.scheduler.resume_ledger(srid)
            if len(delivered) >= req.sampling.max_tokens:
                # Died between the last token and the finish delta:
                # the completion is already whole — close it out
                # locally instead of re-prefilling for zero tokens.
                self._synthesize_rpc_finish(tracked, delivered)
                self.note_success(req, ctx, dead, "(synthesized)",
                                  len(delivered), mode="rpc")
                return
            fwd2 = self.resume_fwd(ctx["fwd"], req, delivered)
            deadline = time.monotonic() + self.opts.request_timeout_s
            for attempt in range(self.retry.max_attempts):
                name, addr = self.reroute(req, fwd2, ctx["failed"])
                if name is None:
                    if not self.retry.sleep(attempt, deadline=deadline):
                        break
                    continue
                try:
                    from xllm_service_tpu_torch.service.httpd import http_json
                    status, ack = http_json(
                        "POST", addr, ctx["path"], fwd2,
                        timeout=self.opts.request_timeout_s,
                        headers={REQUEST_ID_HEADER: srid})
                except Exception as e:  # noqa: BLE001 — survivor
                    # unreachable too: exclude it and try the next one
                    logger.warning("resume of %s on %s failed: %s",
                                   srid, name, e)
                    ctx["failed"].add(name)
                    if not self.retry.sleep(attempt, deadline=deadline):
                        break
                    continue
                if status != 200:
                    logger.warning("resume of %s on %s refused: %d %r",
                                   srid, name, status, ack)
                    ctx["failed"].add(name)
                    if not self.retry.sleep(attempt, deadline=deadline):
                        break
                    continue
                ctx["fwd"] = fwd2
                self.note_success(req, ctx, dead, name,
                                  len(delivered), mode="rpc")
                logger.info("recovered %s: %s -> %s (%d tokens "
                            "delivered)", srid, dead, name,
                            len(delivered))
                return
            # Exhausted: the client gets today's definite error.
            self.note_failure(req, dead, "no_surviving_instance",
                              mode="rpc")
            self.scheduler.count_failed("recovery_exhausted")
            self.scheduler.cancel_request(
                srid, f"instance {dead} died; recovery exhausted")
        except Exception:  # noqa: BLE001 — a resume bug must fail the
            # request cleanly, never strand the client without an answer
            logger.exception("rpc resume of %s crashed", srid)
            self.note_failure(req, dead, "resume_error", mode="rpc")
            self.scheduler.cancel_request(
                srid, f"instance {dead} died; recovery errored")
        finally:
            ctx["resuming"] = False

    def _synthesize_rpc_finish(self, tracked, delivered: List[int]
                               ) -> None:
        from xllm_service_tpu_torch.utils.types import (
            FinishReason, RequestOutput, SequenceOutput)
        req = tracked.request
        out = RequestOutput(
            request_id=req.service_request_id,
            service_request_id=req.service_request_id,
            outputs=[SequenceOutput(index=0,
                                    finish_reason=FinishReason.LENGTH)],
            usage=Usage(prompt_tokens=len(req.token_ids),
                        completion_tokens=len(delivered)),
            finished=True)
        self.scheduler.handle_generation(out)


class RelayLedger:
    """Frame processor for one ledger-aware relay stream: parses each
    SSE payload, feeds token ids into the scheduler's delivered ledger,
    strips the ``"xllm"`` extension, and — after a resume — suppresses
    the survivor's duplicate role chunk, pins ``created`` to the
    original stream's value, and rewrites the usage chunk to the
    client-truthful counts."""

    def __init__(self, manager: RecoveryManager,
                 req: SchedRequest, is_chat: bool) -> None:
        self.manager = manager
        self.req = req
        self.is_chat = is_chat
        self.tokens_seen = 0     # every id that rode a frame (usage)
        self.content_frames = 0  # frames that delivered text/content
        self.usage_sent = False  # a usage chunk reached the client
        self.role_sent = False   # a role chunk reached the client
        self.done = False        # saw [DONE]
        self.finished = False    # saw a finish_reason chunk
        self.resumed = False
        self.created: Optional[int] = None
        self.template: Dict[str, Any] = {}

    def _zerocopy_ok(self, payload: str) -> bool:
        """True when ``payload`` is provably a plain mid-stream delta
        the ledger needs nothing from — every check is a substring scan
        against the deterministic ``sse_frame`` wire format
        (``json.dumps(obj, separators=(",", ":"))``), and ANY ambiguity
        answers False (the parsed path is always correct, just slower):

        - not resumed, and the first frame already captured the
          template/created (the first frame always parses);
        - no ``"xllm"`` ledger extension (nothing to strip or feed to
          ``note_delivered``);
        - no ``"usage"`` key (usage_sent tracking and the resumed-mode
          rewrite both need the parse);
        - exactly one ``"finish_reason"`` and it is ``null`` — every
          assembler delta carries ``"finish_reason":null`` (single
          choice: recoverable requires n==1), so a finish chunk never
          takes this path and ``finished`` stays truthful;
        - chat only: no ``"role"`` key (role chunks and ``role_sent``
          need the parse)."""
        return (not self.resumed
                and bool(self.template)
                and '"xllm"' not in payload
                and '"usage"' not in payload
                and payload.count('"finish_reason"') == 1
                and '"finish_reason":null' in payload
                and (not self.is_chat or '"role"' not in payload))

    def on_payload(self, payload: str) -> Tuple[Optional[bytes], int]:
        """One SSE payload in → (frame bytes to forward | None to
        suppress, number of NEW tokens it delivered)."""
        if payload.strip() == "[DONE]":
            self.done = True
            return SSE_DONE, 0
        if RELAY_ZEROCOPY and self._zerocopy_ok(payload):
            # Pure-delta frame: forward the worker's bytes verbatim
            # (the worker built them with the same sse_frame renderer,
            # so the client-visible shape is identical to the parsed
            # path). No ledger ext ⇒ no note_delivered; content-frame
            # detection below may only OVER-count, which fails a blind
            # resume clean instead of ever replaying content.
            if ('"content":""' if self.is_chat else '"text":""') \
                    not in payload:
                self.content_frames += 1
            return (b"data: " + payload.encode("utf-8") + b"\n\n"), 0
        try:
            obj = json.loads(payload)
        except ValueError:
            # Not a JSON chunk (defensive): forward verbatim.
            return (b"data: " + payload.encode("utf-8") + b"\n\n"), 0
        ext = obj.pop("xllm", None)
        n_new = 0
        has_text = False
        if isinstance(ext, dict) and ext.get("token_ids"):
            ids = [int(t) for t in ext["token_ids"]]
            n_new = len(ids)
            self.tokens_seen += n_new
            # Ledger semantics: only ids whose text this frame actually
            # DELIVERS are resumable-over; ids the detokenizer is still
            # holding back (empty delta) park as pending and are
            # regenerated by a resume (scheduler._ledger_append_locked).
            has_text = any(
                ((ch.get("delta") or {}).get("content") if self.is_chat
                 else ch.get("text"))
                for ch in obj.get("choices") or [])
            self.manager.scheduler.note_delivered(
                self.req.service_request_id, ids, has_text=has_text)
        if not self.template:
            self.template = {k: obj.get(k) for k in
                             ("id", "object", "model")}
            self.created = obj.get("created")
        choices = obj.get("choices") or []
        if any(((ch.get("delta") or {}).get("content") if self.is_chat
                else ch.get("text")) for ch in choices):
            self.content_frames += 1
        if not choices and isinstance(obj.get("usage"), dict):
            self.usage_sent = True
        if n_new and not has_text and \
                not isinstance(obj.get("usage"), dict) and not any(
                    ch.get("finish_reason") or
                    (self.is_chat and "role" in (ch.get("delta") or {}))
                    for ch in choices):
            # Held-back token(s) only: this frame existed to carry the
            # ledger extension just stripped (the assembler emits empty
            # deltas for UTF-8/stop holdbacks ONLY under emit_token_ids)
            # — forwarding its husk would give recoverable streams a
            # different client-visible shape than plain ones.
            return None, n_new
        if self.resumed:
            if self.created is not None and "created" in obj:
                obj["created"] = self.created
            if self.role_sent and self.is_chat and choices and \
                    not n_new and \
                    choices[0].get("delta") == {"role": "assistant"} \
                    and not choices[0].get("finish_reason"):
                # The survivor opens with a fresh role chunk; the
                # client already has one. (If the original worker died
                # before its role chunk ever reached the client, the
                # survivor's must pass through — a chat stream without
                # one is malformed.)
                return None, 0
            if not choices and isinstance(obj.get("usage"), dict):
                obj["usage"] = Usage(
                    prompt_tokens=len(self.req.token_ids),
                    completion_tokens=self.manager.scheduler
                    .delivered_total(
                        self.req.service_request_id)).to_json()
        for ch in choices:
            if ch.get("finish_reason"):
                self.finished = True
        if self.is_chat and any(
                "role" in (ch.get("delta") or {}) for ch in choices):
            self.role_sent = True
        return sse_frame(obj), n_new

    def _chunk_base(self) -> Dict[str, Any]:
        created = self.created if self.created is not None else \
            int(time.time())
        return {"id": self.template.get(
                    "id", self.req.service_request_id),
                "object": self.template.get(
                    "object", "chat.completion.chunk" if self.is_chat
                    else "text_completion"),
                "created": created,
                "model": self.template.get("model", self.req.model)}

    def _usage_frame(self, base: Dict[str, Any]) -> bytes:
        return sse_frame(dict(base, choices=[], usage=Usage(
            prompt_tokens=len(self.req.token_ids),
            completion_tokens=self.manager.scheduler.delivered_total(
                self.req.service_request_id)).to_json()))

    def close_finished(self, include_usage: bool) -> List[bytes]:
        """Close a stream whose worker died after the finish delta but
        before [DONE]: the completion is whole, but an include_usage
        client may still be owed its usage chunk — same death window
        as synthesize_finish, same client contract."""
        frames: List[bytes] = []
        if include_usage and not self.usage_sent:
            frames.append(self._usage_frame(self._chunk_base()))
        frames.append(SSE_DONE)
        self.done = True
        return frames

    def synthesize_finish(self, include_usage: bool) -> List[bytes]:
        """Close a stream whose worker died after the last token but
        before the finish delta: finish chunk (+ usage) + [DONE] from
        the captured template — no re-prefill for zero tokens."""
        base = self._chunk_base()
        if self.is_chat:
            finish = dict(base, choices=[{
                "index": 0, "delta": {}, "finish_reason": "length"}])
        else:
            finish = dict(base, choices=[{
                "index": 0, "text": "", "logprobs": None,
                "finish_reason": "length"}])
        frames = [sse_frame(finish)]
        if include_usage:
            frames.append(self._usage_frame(base))
        frames.append(SSE_DONE)
        self.finished = True
        self.done = True
        return frames


class PoisonLedger:
    """Cluster-wide strike ledger bounding a poison request's blast
    radius (docs/ROBUSTNESS.md, device-plane fault contract).

    Keyed by BOTH the service request id and the whole-prompt digest
    (``utils/hashing.prompt_digest``): each engine-fault blame from a
    worker's step fault boundary is one strike; at
    ``XLLM_POISON_STRIKES`` the request is failed to the client with
    the typed ``engine_fault`` error instead of re-scheduled, and the
    digest is quarantined for ``XLLM_POISON_TTL_S`` so an immediately
    retried identical prompt doesn't restart the rampage worker by
    worker. Pure state — events/metrics are emitted by the scheduler's
    ``note_engine_fault``, outside this lock."""

    MAX_ENTRIES = 4096      # strike-book bound; oldest entries drop

    def __init__(self, strikes: Optional[int] = None,
                 ttl_s: Optional[float] = None) -> None:
        self._lock = make_lock("service.poison", 11)
        if strikes is None:
            try:
                strikes = int(
                    os.environ.get("XLLM_POISON_STRIKES", "") or 2)
            except ValueError:
                strikes = 2
        if ttl_s is None:
            try:
                ttl_s = float(
                    os.environ.get("XLLM_POISON_TTL_S", "") or 300.0)
            except ValueError:
                ttl_s = 300.0
        self.max_strikes = max(1, strikes)
        self.ttl_s = ttl_s
        # srid-or-digest -> strikes (insertion-ordered for the bound).
        self._strikes: Dict[str, int] = {}
        self._quarantine: Dict[str, float] = {}   # digest -> expiry

    def strike(self, srid: str, digest: str) -> Tuple[int, bool]:
        """One engine-fault blame against a request. Returns
        ``(strikes, poisoned)``; when poisoned the digest enters
        quarantine."""
        now = time.monotonic()
        with self._lock:
            n = max(self._strikes.get(srid, 0),
                    self._strikes.get(digest, 0)) + 1
            for key in (srid, digest):
                self._strikes.pop(key, None)    # re-insert at the tail
                self._strikes[key] = n
            while len(self._strikes) > self.MAX_ENTRIES:
                self._strikes.pop(next(iter(self._strikes)))
            poisoned = n >= self.max_strikes
            if poisoned:
                self._quarantine[digest] = now + self.ttl_s
        return n, poisoned

    def quarantined(self, digest: str) -> bool:
        """Admission gate: True while ``digest`` is inside its
        quarantine TTL (expired entries clean up lazily, strikes
        included — a post-TTL retry starts from a clean slate)."""
        now = time.monotonic()
        with self._lock:
            expiry = self._quarantine.get(digest)
            if expiry is None:
                return False
            if now >= expiry:
                self._quarantine.pop(digest, None)
                self._strikes.pop(digest, None)
                return False
            return True

    def state(self) -> Dict[str, Any]:
        """Debug-bundle snapshot: live strike counts and quarantined
        digests with remaining TTL."""
        now = time.monotonic()
        with self._lock:
            return {
                "strikes": dict(self._strikes),
                "quarantined": {
                    d: round(exp - now, 3)
                    for d, exp in self._quarantine.items()
                    if exp > now},
                "max_strikes": self.max_strikes,
                "ttl_s": self.ttl_s}
