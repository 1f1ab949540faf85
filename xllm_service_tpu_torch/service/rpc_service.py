"""Worker-facing RPC plane of the service.

A copy of the JAX package's ``service/rpc_service.py``: the same
behaviour and names, importing only this package (and no device code).

Rebuild of ``rpc_service/service.{h,cpp}`` (SURVEY.md §2 #3): heartbeat
ingestion, instance metainfo queries, static PD lists, the ``Generations``
token fan-in (decode worker → service, response topology 2), and
``GetConfig`` exposing ``enable_decode_response_to_service``
(rpc_service/service.cpp:215-223). Carried over HTTP/JSON instead of brpc
baidu_std; the method surface is the same.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from xllm_service_tpu_torch.utils.wire import check_version
from xllm_service_tpu_torch.config import ServiceOptions
from xllm_service_tpu_torch.service.httpd import Request, Response, Router
from xllm_service_tpu_torch.service.instance_types import Heartbeat
from xllm_service_tpu_torch.service.scheduler import Scheduler
from xllm_service_tpu_torch.utils.types import RequestOutput

logger = logging.getLogger(__name__)


class RpcService:
    def __init__(self, opts: ServiceOptions, scheduler: Scheduler) -> None:
        self.opts = opts
        self.scheduler = scheduler
        # SpanStore of the co-resident HttpService (wired by Master):
        # heartbeat-shipped worker span stages merge here so the
        # /admin/trace/<id> timeline crosses the plane boundary.
        self.spans = None
        # StepBooks of the co-resident HttpService (wired by Master):
        # heartbeat-shipped step flight-recorder tails land here — the
        # /admin/timeline fallback when a live worker pull fails.
        self.step_books = None

    def install(self, router: Router) -> None:
        router.route("GET", "/rpc/hello",
                     lambda r: Response.json({"ok": True}))
        router.route("POST", "/rpc/heartbeat", self.heartbeat)
        router.route("POST", "/rpc/generations", self.generations)
        router.route("GET", "/rpc/instance_info", self.instance_info)
        router.route("GET", "/rpc/static_prefill_list",
                     self.static_prefill_list)
        router.route("GET", "/rpc/static_decode_list",
                     self.static_decode_list)
        router.route("GET", "/rpc/config", self.get_config)

    # -- Heartbeat (rpc_service/service.cpp:114-121) ----------------------
    def heartbeat(self, req: Request) -> Response:
        body = req.json()
        check_version(body, "Heartbeat")
        hb = Heartbeat.from_json(body)
        if not hb.name:
            return Response.error(400, "heartbeat missing name")
        registered = self.scheduler.handle_instance_heartbeat(hb)
        if self.spans is not None:
            for rec in hb.spans:
                rid = rec.get("request_id")
                if rid:
                    self.spans.merge_remote(
                        rid, plane="worker",
                        events=rec.get("events", []), source=hb.name,
                        attrs=rec.get("attrs") or None)
        if self.step_books is not None and hb.steps:
            self.step_books.ingest(hb.name, hb.steps)
        # The ack carries the master epoch (fenced elections) — workers
        # reject an ack whose epoch regresses below one they've already
        # acked (a deposed master still answering) — and the degraded
        # flag so a worker knows its lease-keepalive failures are a
        # store outage, not its own death (docs/ROBUSTNESS.md).
        return Response.json({"ok": True, "registered": registered,
                              "epoch": self.scheduler.current_epoch(),
                              "degraded": self.scheduler.degraded})

    # -- Generations fan-in (rpc_service/service.cpp:149-213) -------------
    def generations(self, req: Request) -> Response:
        body = req.json()
        check_version(body, "generations")
        # Sender identity (additive wire field): the scheduler's
        # exactly-once guard for recovered requests — a straggler push
        # from a deposed instance must not duplicate tokens. Absent
        # from old workers' pushes → accepted (pre-recovery behavior).
        source = body.get("from", "")
        for d in body.get("outputs", []):
            out = RequestOutput.from_json(d)
            self.scheduler.handle_generation(out, source=source)
        return Response.json({"ok": True})

    # -- Instance queries (rpc_service/service.cpp:81-147) ----------------
    def instance_info(self, req: Request) -> Response:
        name = req.param("name")
        info = self.scheduler.instance_mgr.instance_info(name)
        if info is None:
            return Response.error(404, f"unknown instance {name}")
        return Response.json(info)

    def static_prefill_list(self, req: Request) -> Response:
        return Response.json(
            {"instances": self.scheduler.instance_mgr.prefill_instances()})

    def static_decode_list(self, req: Request) -> Response:
        return Response.json(
            {"instances": self.scheduler.instance_mgr.decode_instances()})

    # -- GetConfig (rpc_service/service.cpp:215-223) ----------------------
    def get_config(self, req: Request) -> Response:
        return Response.json({
            "enable_decode_response_to_service":
                self.opts.enable_decode_response_to_service,
            "block_size": self.opts.block_size,
            "murmur_hash3_seed": self.opts.murmur_hash3_seed,
            "epoch": self.scheduler.current_epoch(),
        })
