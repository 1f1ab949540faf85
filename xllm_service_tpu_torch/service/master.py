"""Master: service process entry — builds the scheduler and runs both
servers.

A copy of the JAX package's ``service/master.py``: the same behaviour
and names, importing only this package (and no device code).

Rebuild of ``master.{h,cpp}`` (SURVEY.md §2 #1): constructs the Scheduler,
installs the HTTP (OpenAI) and RPC (worker) services on two servers, and
runs until asked to stop. The reference starts two brpc servers on separate
threads (master.cpp:60-140); here each ``HttpServer`` owns its own accept
thread, and ``main()`` mirrors the reference's gflags surface
(common/global_gflags.cpp) with argparse.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
from typing import Dict, List, Optional

from xllm_service_tpu_torch.config import (
    LoadBalancePolicyType, ServiceOptions, options_from_env)
from xllm_service_tpu_torch.obs.events import EventLog
from xllm_service_tpu_torch.obs.failpoints import Failpoints
from xllm_service_tpu_torch.service.coordination import CoordinationStore
from xllm_service_tpu_torch.service.coordination_net import connect_store
from xllm_service_tpu_torch.service.http_service import HttpService
from xllm_service_tpu_torch.service.httpd import HttpServer, Router
from xllm_service_tpu_torch.service.rpc_service import RpcService
from xllm_service_tpu_torch.service.scheduler import Scheduler
from xllm_service_tpu_torch.service.store_guard import StoreGuard

logger = logging.getLogger(__name__)


class Master:
    def __init__(self, opts: ServiceOptions,
                 store: Optional[CoordinationStore] = None,
                 control=None,
                 model_memory_gb: Optional[Dict[str, float]] = None,
                 serverless_models: Optional[List[str]] = None) -> None:
        self.opts = opts
        self.store = store if store is not None \
            else connect_store(opts.etcd_addr)
        # One cluster event log for the whole service process, created
        # BEFORE the scheduler so the initial master election is the
        # first thing it records (ring size: XLLM_EVENT_RING).
        self.events = EventLog(
            capacity=int(os.environ.get("XLLM_EVENT_RING", "1024")))
        # One failpoint registry for the service plane, created before
        # the store guard so the `store.*` sites can black out even the
        # scheduler's boot-time election; HttpService adopts it (and
        # late-binds its registry for trip counters).
        self.failpoints = Failpoints(events=self.events)
        # Every coordination call routes through the guard
        # (service/store_guard.py): health state machine, store.*
        # failpoints, epoch write fence, heal-triggered resync.
        if not isinstance(self.store, StoreGuard):
            self.store = StoreGuard(self.store,
                                    failpoints=self.failpoints,
                                    events=self.events)
        self.scheduler = Scheduler(
            opts, self.store, control=control,
            model_memory_gb=model_memory_gb,
            serverless_models=serverless_models, events=self.events)
        self.http_service = HttpService(opts, self.scheduler,
                                        events=self.events,
                                        failpoints=self.failpoints)
        self.rpc_service = RpcService(opts, self.scheduler)
        # Worker span stages arrive on the RPC plane (heartbeats) but
        # are queried on the HTTP plane (/admin/trace/<id>): one store.
        self.rpc_service.spans = self.http_service.spans
        # Step flight-recorder tails arrive the same way and feed the
        # HTTP plane's /admin/timeline merge: one set of books.
        self.rpc_service.step_books = self.http_service.step_books
        # Routing audits land on the request's span and in
        # xllm_schedule_decisions_total — the scheduler is built first,
        # so it learns the HTTP plane's span ring/registry here.
        self.scheduler.spans = self.http_service.spans
        self.scheduler.obs = self.http_service.obs

        # Both servers enforce opts.max_concurrency as live admission
        # control (the reference's brpc max_concurrency backpressure,
        # global_gflags.cpp:33-48) — the callable reads the shared opts
        # so /admin/flags reloads apply immediately.
        limit = lambda: self.opts.max_concurrency  # noqa: E731
        http_router = Router()
        self.http_service.install(http_router)
        self._http_srv = HttpServer(opts.host, opts.http_port, http_router,
                                    max_concurrency=limit)

        rpc_router = Router()
        self.rpc_service.install(rpc_router)
        self._rpc_srv = HttpServer(opts.host, opts.rpc_port, rpc_router,
                                   max_concurrency=limit)
        self.http_service.admissions = {
            "http": self._http_srv.admission,
            "rpc": self._rpc_srv.admission}

        self._stopped = threading.Event()

    @property
    def http_address(self) -> str:
        return self._http_srv.address

    @property
    def rpc_address(self) -> str:
        return self._rpc_srv.address

    def start(self) -> "Master":
        self._http_srv.start()
        self._rpc_srv.start()
        # SLO burn-rate evaluation + per-instance anomaly watchdog
        # (obs/slo.py; cadence XLLM_SLO_TICK_S).
        self.http_service.start_watchdog()
        # Advertise reachable addresses through the store (current master
        # publishes them; replicas re-publish on takeover) so workers can
        # follow a failover without a fronting VIP.
        self.scheduler.announce(self.rpc_address, self.http_address)
        logger.info("service up: http=%s rpc=%s master=%s",
                    self.http_address, self.rpc_address,
                    self.scheduler.is_master)
        return self

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._http_srv.stop()
        self._rpc_srv.stop()
        # After the servers: in-flight requests drain first, so the
        # watchdog/tracer shutdown can't drop their last writes.
        self.http_service.close()
        self.scheduler.stop()

    def wait(self) -> None:
        self._stopped.wait()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="xllm-service-tpu master (service process)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--http-port", type=int, default=9888)
    parser.add_argument("--rpc-port", type=int, default=9889)
    parser.add_argument("--etcd-addr", default="",
                        help="coordination store host:port "
                             "('' = in-process store)")
    parser.add_argument("--load-balance-policy", default="CAR",
                        choices=[p.value for p in LoadBalancePolicyType])
    parser.add_argument("--block-size", type=int, default=128)
    parser.add_argument("--murmur-hash3-seed", type=int, default=0)
    parser.add_argument("--tokenizer-path", default="")
    parser.add_argument("--enable-request-trace", action="store_true")
    parser.add_argument("--enable-decode-response-to-service",
                        action="store_true")
    parser.add_argument("--target-ttft-ms", type=float, default=1000.0)
    parser.add_argument("--target-tpot-ms", type=float, default=50.0)
    parser.add_argument("--heartbeat-interval", type=float, default=3.0,
                        help="election lease scale + instance liveness (s)")
    parser.add_argument("--master-upload-interval", type=float, default=3.0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    opts = options_from_env(
        host=args.host, http_port=args.http_port, rpc_port=args.rpc_port,
        etcd_addr=args.etcd_addr,
        load_balance_policy=LoadBalancePolicyType(args.load_balance_policy),
        block_size=args.block_size,
        murmur_hash3_seed=args.murmur_hash3_seed,
        tokenizer_path=args.tokenizer_path,
        enable_request_trace=args.enable_request_trace,
        target_ttft_ms=args.target_ttft_ms,
        target_tpot_ms=args.target_tpot_ms,
        heartbeat_interval_s=args.heartbeat_interval,
        master_upload_interval_s=args.master_upload_interval)
    if args.enable_decode_response_to_service:
        opts.enable_decode_response_to_service = True

    master = Master(opts).start()
    # Machine-parseable liveness line (HA test harness + ops scripts read
    # this to learn the bound ports when started with --http-port 0).
    print(f"XLLM_SERVICE_UP http={master.http_address} "
          f"rpc={master.rpc_address} "
          f"master={int(master.scheduler.is_master)}", flush=True)

    def on_signal(signum, frame) -> None:
        logger.info("signal %d: shutting down", signum)
        master.stop()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    master.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
