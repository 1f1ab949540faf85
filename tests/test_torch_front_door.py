"""The port worker's front door against the JAX worker's, on the CPU.

- **F9, load shedding.** A port worker and a JAX worker, each at
  ``max_concurrency`` 2 with both slots held by streams the
  ``worker.slow_response_ms`` failpoint keeps in their handlers: the
  next ``/v1/chat/completions`` gets the same 503, JSON body,
  ``Retry-After`` and ``Connection`` from both, the exempt routes still
  answer on both, and through the reference master a chat that finds
  the port worker full is served by the other worker. On the native
  epoll server and on the Python one (``XLLM_NATIVE_HTTPD=0``), in both
  packages.
- **F10.** The same ``XLLM_HB_BACKOFF_CAP_S`` gives both workers'
  ``_hb_backoff`` the same cap.
- **The server.** Chunked SSE frames and keep-alive reuse read the same
  through the reference master's client as the JAX worker's; a stream's
  ``close()`` runs when its client leaves; a raising route is a 500; a
  simulated death (``worker.die_after_n_tokens``) ends a non-streamed
  request's connection with no complete answer.
- **The staged embeddings**, with a stand-in wire (the CUDA IPC stage
  itself is held on the card by ``chip_smoke.py``): a JAX requester's
  ``"wire": true`` gets bytes; an ask marked ``"cuda_ipc"`` gets a
  ticket that ``/encode_done`` releases; a ticket left unacknowledged
  is swept after its TTL; a port requester that cannot pull
  acknowledges ``nopull`` and gets the bytes from the same target, bit
  for bit.
"""

import http.client
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import InstanceType as JaxInstanceType
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service import httpd as jax_httpd
from xllm_service_tpu.service import native_httpd as jax_native
from xllm_service_tpu_torch.config import EngineConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import kv_wire
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.service import httpd
from xllm_service_tpu_torch.service import native_httpd

from tests.test_torch_cluster import (  # noqa: F401 — fixtures
    ENGINE, HB_S, MODEL, Cluster, jax_compile_cache, models, wait_until)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

CAP = 2
HOLD_MS = 2500
CHAT = {"model": MODEL, "max_tokens": 3, "temperature": 0.0,
        "ignore_eos": True,
        "messages": [{"role": "user", "content": "shed me"}]}


def _raw(addr, method, path, obj=None):
    """One request on a fresh connection: (status, headers, body)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        body = None if obj is None else json.dumps(obj).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            resp.read()
    finally:
        conn.close()


def _server_kind(mp, kind):
    """Both packages' front doors on ``kind``: their native libraries are
    looked up again under XLLM_NATIVE_HTTPD."""
    mp.setenv("XLLM_NATIVE_HTTPD", "1" if kind == "native" else "0")
    for mod in (native_httpd, jax_native):
        mp.setattr(mod, "_native_tried", False)
        mp.setattr(mod, "_native_lib", None)


@pytest.fixture(scope="module", params=["native", "python"])
def shed_cluster(request, models):
    """A master, a port worker and a JAX worker, both at max_concurrency
    2, on the param's server; XLLM_HB_BACKOFF_CAP_S 1.5 for both."""
    mp = pytest.MonkeyPatch()
    _server_kind(mp, request.param)
    mp.setenv("XLLM_HB_BACKOFF_CAP_S", "1.5")
    c = Cluster()
    try:
        tw = c.add_torch_worker(models, max_concurrency=CAP)
        jw = jax_worker.Worker(
            jax_worker.WorkerOptions(
                port=0, instance_type=JaxInstanceType.DEFAULT,
                service_addr=c.master.rpc_address, model=MODEL,
                heartbeat_interval_s=HB_S, lease_ttl_s=3 * HB_S,
                max_concurrency=CAP),
            c.server.store, engine_cfg=JaxEngineConfig(**ENGINE)).start()
        c.workers.append(jw)
        assert wait_until(lambda: jw.name in c.listed())
        yield request.param, c, tw, jw
    finally:
        c.close()
        mp.undo()


def _hold(*workers):
    """Fill each worker's two slots with streams held in their handlers
    by the slow-response failpoint; waits for them to end."""
    ts = []
    for w in workers:
        w.failpoints.arm("worker.slow_response_ms", mode="count", n=CAP,
                         value=HOLD_MS)
        ts += [threading.Thread(target=_raw, args=(
            w.name, "POST", "/v1/chat/completions", dict(CHAT, stream=True)))
            for _ in range(CAP)]
    for t in ts:
        t.start()
    for w in workers:
        assert wait_until(lambda: w._srv.admission.active == CAP, 10.0)

    def release():
        for t in ts:
            t.join(30)
        # A handler leaves its slot just after its last byte is sent.
        assert wait_until(lambda: all(
            w._srv.admission.active == 0 for w in workers), 10.0)
    return release


EXEMPT = (("GET", "/hello", None), ("GET", "/metrics", None),
          ("GET", "/admin/steptrace", None),
          ("POST", "/sleep", {"model": "absent"}),
          ("POST", "/kv/blocks_done", {"uuid": 7}))


def test_f9_a_full_worker_sheds_as_jax_and_the_master_redispatches(
        shed_cluster):
    kind, c, tw, jw = shed_cluster
    assert tw._srv.kind == kind and jw._srv.__class__.__name__ == (
        "NativeHttpServer" if kind == "native" else "PyHttpServer")
    # Through the master: the port worker full, two chats in turn (round
    # robin offers it one of them): both served, by the JAX worker.
    release = _hold(tw)
    shed0 = tw._srv.admission.rejected_total
    for _ in range(2):
        st, resp = jax_httpd.http_json("POST", c.master.http_address,
                                       "/v1/chat/completions", CHAT)
        assert st == 200 and resp["usage"]["completion_tokens"] == 3, resp
    assert tw._srv.admission.rejected_total > shed0
    release()
    # Both full: the same shed answer, and the exempt routes answer.
    release = _hold(tw, jw)
    mine = _raw(tw.name, "POST", "/v1/chat/completions", CHAT)
    ref = _raw(jw.name, "POST", "/v1/chat/completions", CHAT)
    assert mine[0] == ref[0] == 503
    assert json.loads(mine[2]) == json.loads(ref[2]) == {"error": {
        "message": "server at max_concurrency", "type": "overloaded_error",
        "code": 503}}
    for h in ("retry-after", "connection", "content-type"):
        assert mine[1][h] == ref[1][h], h
    assert mine[1]["retry-after"] == "1" and mine[1]["connection"] == "close"
    for method, path, obj in EXEMPT:
        got = _raw(tw.name, method, path, obj)[0]
        want = _raw(jw.name, method, path, obj)[0]
        assert got == want and got != 503, (path, got, want)
    text = _raw(tw.name, "GET", "/metrics")[2].decode()
    assert f'xllm_worker_http_server{{kind="{kind}"}} 1' in text
    assert "xllm_worker_http_rejected_total" in text
    release()


def test_f10_backoff_cap_read_as_jax(shed_cluster):
    _, _, tw, jw = shed_cluster
    assert tw._hb_backoff.max_delay_s == jw._hb_backoff.max_delay_s == 1.5
    assert [tw._hb_backoff.delay(i) <= 1.5 for i in range(8)] == [True] * 8


def test_sse_frames_and_keepalive_read_as_jax(shed_cluster):
    """The master's client (the JAX ``httpd``) reads a streamed chat as
    chunked SSE from both, ending in [DONE], and reuses its keep-alive
    connection to both."""
    _, _, tw, jw = shed_cluster
    out = []
    for w in (tw, jw):
        st, body = jax_httpd.http_stream_status(
            "POST", w.name, "/v1/chat/completions", dict(CHAT, stream=True))
        assert st == 200
        assert body._resp.getheader("Transfer-Encoding") == "chunked"
        events = list(jax_httpd.iter_sse_events(body))
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        out.append(([(c["object"], [sorted(ch) for ch in c["choices"]])
                     for c in chunks],
                    "".join(ch["delta"].get("content", "") for c in chunks
                            for ch in c["choices"])))
        before = jax_httpd.conn_pool_stats()["hits_total"]
        for _ in range(3):
            assert jax_httpd.http_json("GET", w.name, "/hello")[0] == 200
        assert jax_httpd.conn_pool_stats()["hits_total"] >= before + 2
    assert out[0] == out[1] and out[0][0]


@pytest.mark.parametrize("kind", ["native", "python"])
def test_stream_close_on_client_leave_and_500(kind, monkeypatch):
    _server_kind(monkeypatch, kind)
    closed = threading.Event()

    def stream(req):
        def frames():
            try:
                while True:
                    yield b"data: x\n\n"
                    time.sleep(0.01)
            finally:
                closed.set()
        return httpd.Response.sse(frames())

    def boom(req):
        raise ValueError("boom")

    r = httpd.Router()
    r.route("GET", "/s", stream)
    r.route("GET", "/boom", boom)
    srv = httpd.HttpServer("127.0.0.1", 0, r, max_concurrency=4).start()
    try:
        assert srv.kind == kind
        st, body = httpd.http_json("GET", srv.address, "/boom")
        assert st == 500 and body["error"] == {
            "message": "internal error: boom", "type": "internal_error",
            "code": 500}
        sock = socket.create_connection(("127.0.0.1", srv.port))
        sock.sendall(b"GET /s HTTP/1.1\r\nHost: x\r\n\r\n")
        assert b"chunked" in sock.recv(4096).lower()
        sock.close()
        assert closed.wait(10.0)
        assert wait_until(lambda: srv.admission.active == 0, 10.0)
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def encoders(models):
    """Two standalone port workers that encode (the synthetic ViT)."""
    _, tcfg, jparams = models
    ws = [torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
        for _ in range(2)]
    yield ws
    for w in ws:
        w.stop()


def test_worker_died_drops_a_non_streamed_request(models):
    _, tcfg, jparams = models
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
    try:
        w.failpoints.arm("worker.die_after_n_tokens", mode="after", n=2)
        with pytest.raises((http.client.HTTPException, ConnectionError)):
            _raw(w.name, "POST", "/v1/completions",
                 {"model": MODEL, "prompt": "bye", "max_tokens": 8,
                  "temperature": 0.0, "ignore_eos": True})
        assert w._dead
    finally:
        w.stop()


class _StandInWire:
    """The surface of ``kv_wire.DeviceWire`` the embeddings use, on host
    tensors. ``pid`` is what its tickets name: this process's (a pull
    then refuses, as CUDA IPC does) or another."""

    def __init__(self, pid):
        self.device = torch.device("cpu")
        self.pid = pid
        self.staged, self.released = {}, []
        self.next = 1

    def stage_one(self, t):
        uuid, self.next = self.next, self.next + 1
        self.staged[uuid] = t.clone()
        return uuid

    def ticket(self, uuid):
        t = self.staged[uuid]
        return {"addr": "stand-in", "uuid": uuid, "pid": self.pid,
                "handle": "00", "event": "00", "offset": 0,
                "nbytes": t.numel() * 4, "shape": list(t.shape),
                "dtype": "float32"}

    def release(self, uuid, leaked=False):
        self.staged.pop(uuid, None)
        self.released.append((uuid, leaked))

    def pull_one(self, tr):
        if tr["pid"] == os.getpid():
            raise kv_wire.WireUnsupported("own process")
        return self.staged[tr["uuid"]].clone()


def test_staged_embeddings_ticket_release_and_sweep(encoders, monkeypatch):
    target = encoders[0]
    wire = _StandInWire(pid=os.getpid())
    monkeypatch.setattr(kv_wire, "get_device_wire", lambda: wire)
    ask = {"images": ["random:3"], "raw": True}
    # A JAX requester's "wire": true: bytes.
    st, headers, raw = _raw(target.name, "POST", "/encode",
                            dict(ask, wire=True))
    assert st == 200 and headers["content-type"] == \
        "application/octet-stream" and not wire.staged
    # Marked cuda_ipc: a ticket, released by /encode_done.
    st, head = httpd.http_json("POST", target.name, "/encode",
                               dict(ask, wire=torch_worker.FETCH_WIRE))
    assert st == 200 and head["status"] == "staged"
    uuid = head["transfer"]["uuid"]
    assert target.encode_staged_count() == 1
    assert httpd.http_json("POST", target.name, "/encode_done",
                           {"uuid": uuid, "outcome": "pulled"})[1] == {
        "ok": True, "known": True}
    assert target.encode_staged_count() == 0
    assert wire.released[-1] == (uuid, False)
    # Left unacknowledged: swept as leaked after the TTL.
    st, head = httpd.http_json("POST", target.name, "/encode",
                               dict(ask, wire=torch_worker.FETCH_WIRE))
    target._sweep_encode_staged(ttl=60.0)
    assert target.encode_staged_count() == 1
    target._sweep_encode_staged(ttl=0.0)
    assert target.encode_staged_count() == 0
    assert wire.released[-1] == (head["transfer"]["uuid"], True)
    text = _raw(target.name, "GET", "/metrics")[2].decode()
    assert "xllm_worker_encode_staged 0" in text


def test_requester_pulls_or_asks_again_for_bytes(encoders, monkeypatch):
    target, requester = encoders
    images = ["random:4"]
    want, _ = target.encode_via_queue(images)
    monkeypatch.setattr(torch_worker, "_LOCAL_WORKERS", {})
    # A ticket it can pull: the embeddings bit-equal to the bytes'.
    wire = _StandInWire(pid=-1)
    monkeypatch.setattr(kv_wire, "get_device_wire", lambda: wire)
    got, _ = requester._fetch_remote_embeds(target.name, images, 30.0)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert wire.released[-1][1] is False and not wire.staged
    # One it cannot: acknowledged nopull, then bytes from the same target,
    # which is offered the wire no more.
    wire = _StandInWire(pid=os.getpid())
    monkeypatch.setattr(kv_wire, "get_device_wire", lambda: wire)
    got, _ = requester._fetch_remote_embeds(target.name, images, 30.0)
    assert np.array_equal(got, want)
    assert len(wire.released) == 1 and wire.released[0][1] is False
    assert target.name in requester._fetch_wire_refused
    assert target.encode_staged_count() == 0
    requester._fetch_remote_embeds(target.name, images, 30.0)
    assert len(wire.released) == 1
