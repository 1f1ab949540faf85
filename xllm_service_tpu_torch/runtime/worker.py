"""Worker process: an OpenAI HTTP front over one engine on one device.

The counterpart of the JAX package's ``runtime/worker.py`` serving
requests sent straight to the worker (no master in front):

- ``GET /hello``, ``GET /v1/models``;
- ``POST /v1/completions`` and ``POST /v1/chat/completions``, with
  ``stream`` true (SSE, ending in ``data: [DONE]``) or false. Prompts
  are tokenized here (chat messages joined by newlines, as the JAX
  worker does), and the response and SSE chunk JSON come from the same
  assemblers.

One engine-loop thread owns the device and runs ``Engine.step()``; HTTP
handler threads queue requests to it under the engine lock and read
their outputs from a per-request queue.

Not in this package yet: registration and heartbeats with the master,
``/metrics``, ``/admin/*``, PD/EPD traffic, and the sampling options
the engine lacks (``n``/``best_of`` > 1, ``echo``, ``top_logprobs``,
``logit_bias``, presence/frequency penalties), which are refused with a
400 rather than ignored.

Run: ``python -m xllm_service_tpu_torch.runtime.worker --model llama3-1b``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import queue
import secrets
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, List, Optional

from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.transformer import Params
from xllm_service_tpu_torch.nlp.tokenizer import (IncrementalDecoder,
                                                  Tokenizer,
                                                  TokenizerFactory)
from xllm_service_tpu_torch.runtime.engine import (Engine, EngineRequest,
                                                   StepOutput)
from xllm_service_tpu_torch.service.response_handler import (
    ChatStreamAssembler, CompletionStreamAssembler, ResponseCollector,
    sse_frame)
from xllm_service_tpu_torch.utils.types import (
    FinishReason, LogProb, RequestOutput, SamplingParams, SequenceOutput,
    Usage, parse_openai_sampling, validate_sampling)

logger = logging.getLogger(__name__)

_MODEL_REGISTRY = {
    # vocab 512 >= the byte tokenizer's id range (256 bytes + specials).
    "tiny": lambda: ModelConfig.tiny(vocab_size=512),
    "llama3-1b": ModelConfig.llama3_1b,
}


def resolve_model_config(name: str) -> ModelConfig:
    factory = _MODEL_REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(_MODEL_REGISTRY)}")
    return factory()


@dataclasses.dataclass
class WorkerOptions:
    host: str = "127.0.0.1"
    port: int = 0
    model: str = "tiny"
    device: str = "cuda"
    # Bound on the wait for one engine output of a request.
    request_timeout_s: float = 600.0


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error") -> None:
        super().__init__(message)
        self.status = status
        self.err_type = err_type


class _StopWatcher:
    """OpenAI ``stop`` string matching with holdback: ``feed`` returns
    only text that cannot be the start of a stop string and flags
    ``stopped`` when one appears (the stop text is never emitted)."""

    __slots__ = ("stops", "pending", "stopped")

    def __init__(self, stops: Optional[List[str]]) -> None:
        self.stops = [s for s in (stops or []) if s]
        self.pending = ""
        self.stopped = False

    def feed(self, text: str) -> str:
        if not self.stops or self.stopped:
            return text
        self.pending += text
        idx = -1
        for s in self.stops:
            i = self.pending.find(s)
            if i >= 0 and (idx < 0 or i < idx):
                idx = i
        if idx >= 0:
            self.stopped = True
            out, self.pending = self.pending[:idx], ""
            return out
        hold = 0
        for s in self.stops:
            m = min(len(s) - 1, len(self.pending))
            for h in range(m, 0, -1):
                if s.startswith(self.pending[len(self.pending) - h:]):
                    hold = max(hold, h)
                    break
        if hold:
            out = self.pending[:-hold]
            self.pending = self.pending[-hold:]
        else:
            out, self.pending = self.pending, ""
        return out

    def flush(self) -> str:
        out, self.pending = self.pending, ""
        return out


class _EngineDied:
    """Queued to every live request when the engine loop dies."""

    def __init__(self, message: str) -> None:
        self.message = message


class _LiveRequest:
    """Host-side streaming state of one in-flight request."""

    def __init__(self, req: EngineRequest, tokenizer: Tokenizer, model: str,
                 is_chat: bool, stream: bool, include_usage: bool,
                 sampling: SamplingParams) -> None:
        self.req = req
        self.q: "queue.Queue[Any]" = queue.Queue()
        self.tokenizer = tokenizer
        self.model = model
        self.is_chat = is_chat
        self.stream = stream
        self.include_usage = include_usage
        self.sampling = sampling
        self.decoder = IncrementalDecoder(tokenizer)
        self.stopper = _StopWatcher(sampling.stop)
        self.completion_tokens = 0
        self.finished = False

    @property
    def request_id(self) -> str:
        return self.req.request_id


_UNSUPPORTED = (
    ("n", lambda sp: sp.n > 1),
    ("best_of", lambda sp: (sp.best_of or 1) > 1),
    ("echo", lambda sp: sp.echo),
    ("top_logprobs", lambda sp: sp.top_logprobs > 0),
    ("logit_bias", lambda sp: bool(sp.logit_bias)),
    ("presence_penalty", lambda sp: sp.presence_penalty != 0.0),
    ("frequency_penalty", lambda sp: sp.frequency_penalty != 0.0),
)


class Worker:
    def __init__(self, opts: WorkerOptions,
                 engine_cfg: Optional[EngineConfig] = None,
                 model_cfg: Optional[ModelConfig] = None,
                 params: Optional[Params] = None) -> None:
        self.opts = opts
        # No checkpoint loader yet, so no model directory: the byte
        # tokenizer, as the JAX worker uses without --model-dir.
        self.tokenizer = TokenizerFactory.create_tokenizer()
        self.model_cfg = model_cfg or resolve_model_config(opts.model)
        # The engine first: without the device it raises before any
        # socket is bound.
        self.engine = Engine(self.model_cfg, engine_cfg or EngineConfig(),
                             params=params, device=opts.device)
        self._live: Dict[str, _LiveRequest] = {}
        self._live_lock = threading.Lock()
        self._engine_lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self.engine_error: Optional[str] = None
        self._srv = ThreadingHTTPServer((opts.host, opts.port),
                                        _handler_class(self))
        self._srv.daemon_threads = True
        host, port = self._srv.server_address[:2]
        self.name = f"{host}:{port}"
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "Worker":
        for target, name in ((self._engine_loop, "engine-loop"),
                             (self._srv.serve_forever, "http")):
            t = threading.Thread(target=target, name=f"worker-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._threads:
            self._srv.shutdown()
        self._srv.server_close()
        for t in self._threads:
            t.join(timeout=30.0)

    def serve_forever(self) -> None:
        """Block until ``stop`` (from another thread or a signal)."""
        self._stop.wait()

    # ------------------------------------------------------------------
    # Engine loop
    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            with self._engine_lock:
                busy = self.engine.has_work()
                if busy:
                    try:
                        outs = self.engine.step()
                    except Exception as exc:  # noqa: BLE001 — the loop
                        # dies visibly: every waiting request gets a 500
                        logger.exception("engine step failed")
                        self._fail_all(f"engine step failed: {exc!r}")
                        return
            if not busy:
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            for out in outs:
                with self._live_lock:
                    live = self._live.get(out.request_id)
                    if live is not None and out.finished:
                        self._live.pop(out.request_id, None)
                if live is not None:
                    live.q.put(out)

    def _fail_all(self, message: str) -> None:
        self.engine_error = message
        with self._live_lock:
            lives, self._live = list(self._live.values()), {}
        for live in lives:
            live.q.put(_EngineDied(message))

    # ------------------------------------------------------------------
    # Requests
    # ------------------------------------------------------------------
    def _parse_generate(self, body: Dict[str, Any],
                        is_chat: bool) -> _LiveRequest:
        if self.engine_error is not None:
            raise HttpError(500, self.engine_error, "engine_fault")
        model = body.get("model", self.opts.model)
        rid = body.get("service_request_id") or \
            f"req-{secrets.token_urlsafe(16)}"
        token_ids = body.get("token_ids") or []
        if not token_ids:
            if is_chat:
                prompt = "\n".join(str(m.get("content", ""))
                                   for m in body.get("messages", []))
            else:
                prompt = body.get("prompt", "")
            token_ids = self.tokenizer.encode(prompt)
        try:
            sampling = parse_openai_sampling(body, is_chat)
            stream = bool(body.get("stream", False))
            validate_sampling(sampling, stream)
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e)) from e
        for name, used in _UNSUPPORTED:
            if used(sampling):
                raise HttpError(400, f"{name} is not supported by this "
                                     f"worker yet")
        req = EngineRequest(request_id=rid, token_ids=list(token_ids),
                            sampling=sampling,
                            eos_token_ids=self.tokenizer.eos_token_ids)
        live = _LiveRequest(
            req, self.tokenizer, model, is_chat, stream,
            bool((body.get("stream_options") or {}).get("include_usage")),
            sampling)
        with self._engine_lock:
            try:
                self.engine.add_request(req)
            except ValueError as e:
                raise HttpError(400, str(e)) from e
            with self._live_lock:
                self._live[rid] = live
        self._work.set()
        return live

    def _to_request_output(self, live: _LiveRequest,
                           out: StepOutput) -> Optional[RequestOutput]:
        """One engine StepOutput as the wire RequestOutput: incremental
        detokenization, stop strings (the engine request is cancelled
        once one fires) and chosen-token logprobs. None once the request
        has finished."""
        if live.finished:
            return None
        finish = out.finish_reason
        text = live.decoder.feed(out.new_token_ids)
        if finish != FinishReason.NONE:
            text += live.decoder.flush()
        if live.stopper.stops:
            text = live.stopper.feed(text)
            if live.stopper.stopped:
                finish = FinishReason.STOP
                self._cancel(live)
            elif finish != FinishReason.NONE:
                text += live.stopper.flush()
        live.completion_tokens += len(out.new_token_ids)
        logprobs: List[LogProb] = []
        if live.sampling.logprobs:
            logprobs = [LogProb(token=live.tokenizer.decode([tid]),
                                token_id=tid, logprob=lp, top_logprobs=[])
                        for tid, lp in zip(out.new_token_ids, out.logprobs)]
        live.finished = finish != FinishReason.NONE
        seq = SequenceOutput(index=0, text=text,
                             token_ids=list(out.new_token_ids),
                             finish_reason=finish, logprobs=logprobs)
        usage = None
        if live.finished:
            usage = Usage(prompt_tokens=len(live.req.token_ids),
                          completion_tokens=live.completion_tokens)
        return RequestOutput(
            request_id=live.request_id, service_request_id=live.request_id,
            outputs=[seq], usage=usage, finished=live.finished,
            cancelled=finish == FinishReason.CANCELLED)

    def _cancel(self, live: _LiveRequest) -> None:
        with self._engine_lock:
            self.engine.cancel(live.request_id)
        self._work.set()

    def _finalize(self, live: _LiveRequest) -> None:
        """Consumer-side cleanup: unfinished engine work whose consumer
        is gone (client disconnect, timeout) is cancelled."""
        with self._live_lock:
            self._live.pop(live.request_id, None)
        if not live.finished:
            self._cancel(live)

    def _next_output(self, live: _LiveRequest) -> StepOutput:
        try:
            out = live.q.get(timeout=self.opts.request_timeout_s)
        except queue.Empty:
            raise HttpError(504, f"no engine output within "
                                 f"{self.opts.request_timeout_s:g}s",
                            "timeout") from None
        if isinstance(out, _EngineDied):
            raise HttpError(500, out.message, "engine_fault")
        return out

    def stream_sse(self, live: _LiveRequest) -> Iterator[bytes]:
        asm = (ChatStreamAssembler if live.is_chat
               else CompletionStreamAssembler)(
            live.request_id, live.model, live.include_usage)
        try:
            while not live.finished:
                try:
                    out = self._next_output(live)
                except HttpError as e:
                    # Headers are sent: a typed error frame, then the end.
                    yield sse_frame({"error": {"message": str(e),
                                               "type": e.err_type,
                                               "code": e.status}})
                    return
                ro = self._to_request_output(live, out)
                if ro is not None:
                    yield from asm.on_output(ro)
        finally:
            self._finalize(live)

    def collect_full(self, live: _LiveRequest) -> Dict[str, Any]:
        coll = ResponseCollector(live.request_id, live.model, live.is_chat)
        try:
            while not live.finished:
                ro = self._to_request_output(live, self._next_output(live))
                if ro is not None:
                    coll.add(ro)
        finally:
            self._finalize(live)
        return coll.body()

    def models_body(self) -> Dict[str, Any]:
        return {"object": "list",
                "data": [{"id": self.opts.model, "object": "model",
                          "owned_by": "xllm-service-tpu",
                          "state": "awake"}]}


def _handler_class(worker: Worker):
    class Handler(BaseHTTPRequestHandler):
        server_version = "xllm-torch-worker"

        def log_message(self, fmt, *args) -> None:   # quiet by default
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, status: int, obj: Dict[str, Any]) -> None:
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, e: HttpError) -> None:
            self._json(e.status, {"error": {"message": str(e),
                                            "type": e.err_type,
                                            "code": e.status}})

        def do_GET(self) -> None:
            if self.path == "/hello":
                self._json(200, {"ok": True})
            elif self.path == "/v1/models":
                self._json(200, worker.models_body())
            else:
                self._error(HttpError(404, f"no route {self.path}"))

        def do_POST(self) -> None:
            routes = {"/v1/completions": False,
                      "/v1/chat/completions": True}
            if self.path not in routes:
                self._error(HttpError(404, f"no route {self.path}"))
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise HttpError(400, "request body must be an object")
                live = worker._parse_generate(body, routes[self.path])
            except json.JSONDecodeError:
                self._error(HttpError(400, "invalid JSON body"))
                return
            except HttpError as e:
                self._error(e)
                return
            if not live.stream:
                try:
                    self._json(200, worker.collect_full(live))
                except HttpError as e:
                    self._error(e)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            frames = worker.stream_sse(live)
            try:
                for frame in frames:
                    self.wfile.write(frame)
                    self.wfile.flush()
            except OSError:
                pass        # client went away; the finally cancels
            finally:
                frames.close()

    return Handler


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="OpenAI worker on the PyTorch/CUDA engine")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--model", default="tiny", choices=sorted(_MODEL_REGISTRY))
    p.add_argument("--device", default="cuda")
    d = EngineConfig()
    p.add_argument("--page-size", type=int, default=d.page_size)
    p.add_argument("--num-pages", type=int, default=d.num_pages)
    p.add_argument("--max-model-len", type=int, default=d.max_model_len)
    p.add_argument("--max-batch-size", type=int, default=d.max_batch_size)
    p.add_argument("--max-prefill-tokens", type=int,
                   default=d.max_prefill_tokens)
    p.add_argument("--prefill-buckets",
                   default=",".join(map(str, d.prefill_buckets)),
                   help="comma-separated prefill window buckets")
    return p.parse_args(argv)


def build_worker(args: argparse.Namespace) -> Worker:
    """The Worker the CLI serves, from parsed arguments."""
    ecfg = EngineConfig(
        page_size=args.page_size, num_pages=args.num_pages,
        max_model_len=args.max_model_len,
        max_batch_size=args.max_batch_size,
        max_prefill_tokens=args.max_prefill_tokens,
        prefill_buckets=tuple(int(b) for b in
                              args.prefill_buckets.split(",") if b))
    opts = WorkerOptions(host=args.host, port=args.port, model=args.model,
                         device=args.device)
    return Worker(opts, engine_cfg=ecfg)


def main(argv: Optional[List[str]] = None) -> int:
    w = build_worker(parse_args(argv))
    logging.basicConfig(level=logging.INFO)
    w.start()
    print(f"XLLM_TORCH_WORKER_UP http={w.name}", flush=True)

    def on_signal(signum, frame) -> None:
        w._stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    w.serve_forever()
    w.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
