"""The port's worker in the JAX package's cluster, on the CPU.

A JAX ``StoreServer`` and JAX ``Master`` (round robin, block size 16 =
the workers' page size) front the port's worker, which reaches the
store through its own ``RemoteStore``; a JAX worker behind its own
master is the reference. Both serve the same tiny float32 weights (the
JAX engine's ``init_params(cfg, PRNGKey(0))``, carried across by
``params_from_jax``) with the byte tokenizer, so at temperature 0 the
texts through the master must be equal, in the relay and the RPC
topology and in a cluster that holds one worker of each package. The
registration record and the heartbeat must validate against the wire
contract ``tests/wire_contract_v1.json``.
"""

import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest

from xllm_service_tpu.config import (
    EngineConfig as JaxEngineConfig, InstanceType as JaxInstanceType,
    LoadBalancePolicyType, ModelConfig as JaxModelConfig, ServiceOptions)
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.obs import validate_exposition
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service.coordination_net import StoreServer
from xllm_service_tpu.service.httpd import (
    http_json, http_stream, iter_sse_events)
from xllm_service_tpu.service.master import Master
from xllm_service_tpu.utils import wire as jax_wire
from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig)
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.service import coordination, coordination_net
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils import wire as torch_wire
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

HB_S = 0.25          # heartbeat interval of every worker and master here
# A lease a loaded host does not let lapse: with 3 x HB_S (0.75 s) a
# worker whose heartbeat thread is starved for under a second (six test
# processes compiling at once) loses its lease, the master drops it, and
# a request it was serving in the RPC topology ends empty ("stop", no
# usage; the JAX master does the same) or its cached blocks leave the
# master's index. Tests whose results ride on the worker staying listed
# give their workers this lease; tests of expiry keep their own.
LOADED_LEASE_S = 10.0
MODEL = "tiny"
ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
              max_batch_size=4, max_prefill_tokens=256,
              prefill_buckets=(32, 64, 128))


def wait_until(cond, timeout=15.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """XLA's persistent compilation cache for one module: a JAX engine
    whose programs an engine before it in the module compiled (the same
    configuration, the same programs) loads them instead of compiling
    them again. The process's cache settings come back after the module.
    (The JAX package leaves its CPU processes uncached, as a cache written
    on another machine may not load there; this one lives and dies with
    the module's process.)"""
    from jax._src import compilation_cache
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    compilation_cache.reset_cache()
    for n, v in zip(names, (str(tmp_path_factory.mktemp("xla_cache")),
                            0.0, 0)):
        jax.config.update(n, v)
    yield
    for n, v in saved.items():
        jax.config.update(n, v)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, MODEL, lambda: jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    yield jcfg, tcfg, jparams
    mp.undo()


class Cluster:
    """One StoreServer, one JAX master on its store, and workers."""

    def __init__(self, rpc_topology: bool = False,
                 policy=LoadBalancePolicyType.ROUND_ROBIN) -> None:
        self.server = StoreServer().start()
        self.master = Master(ServiceOptions(
            http_port=0, rpc_port=0, num_output_pools=4,
            load_balance_policy=policy,
            block_size=ENGINE["page_size"], heartbeat_interval_s=HB_S,
            master_upload_interval_s=HB_S,
            enable_decode_response_to_service=rpc_topology),
            store=self.server.store).start()
        self.workers = []

    def listed(self):
        status, resp = http_json("GET", self.master.rpc_address,
                                 "/rpc/static_prefill_list")
        assert status == 200, resp
        return resp["instances"]

    def add_torch_worker(self, models, **opts):
        _, tcfg, jparams = models
        w = torch_worker.Worker(
            torch_worker.WorkerOptions(
                model=MODEL, device="cpu",
                instance_type=InstanceType.DEFAULT,
                store_addr=self.server.address,
                service_addr=self.master.rpc_address,
                heartbeat_interval_s=HB_S, **opts),
            engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
            params=params_from_jax(jparams, tcfg, "cpu")).start()
        self.workers.append(w)
        assert wait_until(lambda: w.name in self.listed()), \
            "the port worker never joined the master's list"
        return w

    def add_jax_worker(self, lease_ttl_s: float = 3 * HB_S):
        w = jax_worker.Worker(
            jax_worker.WorkerOptions(
                port=0, instance_type=JaxInstanceType.DEFAULT,
                service_addr=self.master.rpc_address, model=MODEL,
                heartbeat_interval_s=HB_S, lease_ttl_s=lease_ttl_s),
            self.server.store,
            engine_cfg=JaxEngineConfig(**ENGINE)).start()
        self.workers.append(w)
        assert wait_until(lambda: w.name in self.listed())
        return w

    def close(self):
        for w in self.workers:
            w.stop()
        self.master.stop()
        self.server.stop()


@pytest.fixture(scope="module")
def jax_ref(models):
    """The reference: a JAX worker behind its own master (relay)."""
    c = Cluster()
    c.add_jax_worker()
    yield c
    c.close()


@pytest.fixture(scope="module")
def relay(models):
    c = Cluster()
    c.add_torch_worker(models)
    yield c
    c.close()


@pytest.fixture(scope="module")
def rpc(models):
    c = Cluster(rpc_topology=True)
    w = c.add_torch_worker(models)
    assert w._decode_to_service
    yield c
    c.close()


def _logprobs(choice, is_chat):
    lp = choice.get("logprobs") or {}
    if is_chat:
        return [e["logprob"] for e in lp.get("content") or []]
    return list(lp.get("token_logprobs") or [])


def generate(cluster, path, body, stream, headers=None):
    """(text, finish_reason, usage, chosen-token logprobs) of one request
    through the cluster's master."""
    is_chat = path.endswith("chat/completions")
    if not stream:
        status, resp = http_json("POST", cluster.master.http_address,
                                 path, body, timeout=120.0,
                                 headers=headers)
        assert status == 200, resp
        choice = resp["choices"][0]
        text = choice["message"]["content"] if is_chat else choice["text"]
        return (text, choice["finish_reason"], resp["usage"],
                _logprobs(choice, is_chat))
    body = {**body, "stream": True,
            "stream_options": {"include_usage": True}}
    payloads = list(iter_sse_events(http_stream(
        "POST", cluster.master.http_address, path, body, timeout=120.0,
        headers=headers)))
    assert payloads[-1] == "[DONE]", payloads[-3:]
    objs = [json.loads(p) for p in payloads[:-1]]
    chunks = [o["choices"][0] for o in objs if o["choices"]]
    if is_chat:
        text = "".join(c["delta"].get("content") or "" for c in chunks)
    else:
        text = "".join(c.get("text", "") for c in chunks)
    finish = [c["finish_reason"] for c in chunks if c["finish_reason"]]
    usage = [o["usage"] for o in objs if not o["choices"]]
    assert len(finish) == 1 and len(usage) == 1, objs
    return (text, finish[0], usage[0],
            [x for c in chunks for x in _logprobs(c, is_chat)])


def assert_same(mine, ref):
    """Equal text, finish reason and usage; the chosen tokens' logprobs
    within float32 noise (the texts of random weights are mostly bytes
    that do not decode, so the logprobs pin the token ids)."""
    assert mine[:3] == ref[:3]
    assert len(mine[3]) == len(ref[3])
    np.testing.assert_allclose(mine[3], ref[3], atol=1e-4)


REQUESTS = {
    "completion": ("/v1/completions",
                   {"model": MODEL, "prompt": "The quick brown fox",
                    "max_tokens": 12, "temperature": 0.0, "logprobs": 0}),
    "chat": ("/v1/chat/completions",
             {"model": MODEL, "messages": [
                 {"role": "system", "content": "be brief"},
                 {"role": "user", "content": "what is a page table?"}],
              "max_tokens": 10, "temperature": 0.0, "logprobs": True}),
}


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

GOLDEN = json.loads((__import__("pathlib").Path(__file__).parent
                     / "wire_contract_v1.json").read_text())


@pytest.mark.parametrize("name", sorted(torch_wire.wire_messages()))
def test_wire_message_matches_golden(name):
    assert torch_wire.describe()["messages"][name] == \
        GOLDEN["messages"][name]
    assert torch_wire.WIRE_VERSION == GOLDEN["wire_version"]


def test_request_output_round_trips_through_jax_types():
    from xllm_service_tpu.utils.types import RequestOutput as JaxOutput
    from xllm_service_tpu_torch.utils.types import (
        FinishReason, LogProb, RequestOutput, SequenceOutput, Usage)
    ro = RequestOutput(
        request_id="r", service_request_id="r", finished=True,
        outputs=[SequenceOutput(text="ab", token_ids=[97, 98],
                                finish_reason=FinishReason.LENGTH,
                                logprobs=[LogProb("a", 97, -0.5, [])])],
        usage=Usage(3, 2))
    d = ro.to_json()
    assert jax_wire.validate("RequestOutput", d) == []
    assert JaxOutput.from_json(d).to_json() == d
    assert RequestOutput.from_json(d) == ro


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

def _record(cluster, w, itype="DEFAULT"):
    return cluster.server.store.get_json(f"XLLM:{itype}:{w.name}")


def test_registration_validates_against_the_golden(relay):
    rec = _record(relay, relay.workers[0])
    assert rec is not None and rec["v"] == torch_wire.WIRE_VERSION
    assert jax_wire.validate("InstanceMetaInfo", rec) == []
    assert set(rec) - {"v"} == set(GOLDEN["messages"]["InstanceMetaInfo"])
    assert rec["instance_type"] == "DEFAULT"
    assert rec["name"] == rec["rpc_address"] == relay.workers[0].name


@pytest.mark.parametrize("field", ["page_size", "hash_seed",
                                   "kv_block_bytes", "dp_size",
                                   "k_cache_ids", "v_cache_ids", "models"])
def test_registration_matches_jax_worker(relay, jax_ref, field):
    mine = _record(relay, relay.workers[0])
    ref = _record(jax_ref, jax_ref.workers[0])
    assert mine[field] == ref[field]


# ---------------------------------------------------------------------------
# Through the master
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["full", "stream"])
@pytest.mark.parametrize("kind", sorted(REQUESTS))
@pytest.mark.parametrize("topology", ["relay", "rpc"])
def test_text_through_master_matches_jax(request, jax_ref, topology, kind,
                                         stream):
    cluster = request.getfixturevalue(topology)
    path, body = REQUESTS[kind]
    mine = generate(cluster, path, body, stream)
    ref = generate(jax_ref, path, body, stream)
    assert len(ref[3]) == ref[2]["completion_tokens"] > 0
    assert_same(mine, ref)


@pytest.mark.parametrize("topology", ["relay", "rpc"])
def test_chat_stream_sse_grammar(request, topology):
    """tests/test_e2e.py::test_chat_stream_sse_grammar, through the port."""
    cluster = request.getfixturevalue(topology)
    payloads = list(iter_sse_events(http_stream(
        "POST", cluster.master.http_address, "/v1/chat/completions",
        {"model": MODEL, "messages": [{"role": "user", "content": "hi"}],
         "max_tokens": 3, "temperature": 0.0, "stream": True,
         "ignore_eos": True, "stream_options": {"include_usage": True}},
        timeout=120.0)))
    assert payloads[-1] == "[DONE]"
    objs = [json.loads(p) for p in payloads[:-1]]
    assert objs[0]["object"] == "chat.completion.chunk"
    assert objs[0]["choices"][0]["delta"]["role"] == "assistant"
    finish_chunks = [o for o in objs if o["choices"]
                     and o["choices"][0]["finish_reason"]]
    assert finish_chunks and \
        finish_chunks[0]["choices"][0]["finish_reason"] == "length"
    usage = [o for o in objs if not o["choices"]]
    assert usage and usage[0]["usage"]["completion_tokens"] == 3


@pytest.mark.parametrize("topology", ["relay", "rpc"])
def test_service_parsed_sampling(request, jax_ref, topology):
    """max_completion_tokens and a stop string, parsed by the service and
    honoured from the forwarded body, give the JAX worker's count and
    text."""
    cluster = request.getfixturevalue(topology)
    path, body = REQUESTS["completion"]
    body = {k: v for k, v in body.items() if k != "max_tokens"}
    body["max_completion_tokens"] = 7
    mine = generate(cluster, path, body, stream=False)
    ref = generate(jax_ref, path, body, stream=False)
    assert_same(mine, ref)
    assert ref[2]["completion_tokens"] == 7
    # A stop string from the middle of the unstopped text.
    full = generate(jax_ref, path, {**body, "max_completion_tokens": 16},
                    stream=False)[0]
    stop = next(full[i:i + 2] for i in range(2, len(full) - 1)
                if full[i:i + 2].strip() and full.find(full[i:i + 2]) == i)
    body = {**body, "max_completion_tokens": 16, "stop": [stop]}
    for stream in (False, True):
        mine = generate(cluster, path, body, stream)
        ref = generate(jax_ref, path, body, stream)
        assert_same(mine, ref)
        assert ref[1] == "stop" and ref[0] == full[:full.find(stop)]


def test_mixed_cluster_both_serve(models):
    """One JAX worker and one port worker under round robin: every
    request gets the same text, and both workers take requests."""
    c = Cluster()
    try:
        tw = c.add_torch_worker(models)
        c.add_jax_worker()
        path, body = REQUESTS["completion"]
        steps0 = tw.engine.step_count
        served_here = []
        outs = []
        for _ in range(4):
            before = tw.engine.step_count
            outs.append(generate(c, path, body, stream=False))
            served_here.append(tw.engine.step_count > before)
        for out in outs[1:]:
            assert_same(out, outs[0])
        assert served_here.count(True) == 2, served_here
        assert tw.engine.step_count > steps0
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Heartbeats, load, /metrics, /cancel
# ---------------------------------------------------------------------------

def _instance_row(cluster, name):
    status, bundle = http_json("GET", cluster.master.http_address,
                               "/admin/debug_bundle", timeout=30.0)
    assert status == 200
    return next(r for r in bundle["instances"] if r["name"] == name)


def test_heartbeat_validates_against_the_golden(relay):
    w = relay.workers[0]
    hb, _ = w._build_heartbeat()
    d = hb.to_json()
    assert jax_wire.validate("Heartbeat", d) == []
    assert jax_wire.validate("LoadMetrics", d["load"]) == []
    assert jax_wire.validate("LatencyMetrics", d["latency"]) == []
    assert set(d) == set(GOLDEN["messages"]["Heartbeat"])
    assert d["name"] == w.name and d["model_states"] == {MODEL: "awake"}


@pytest.mark.parametrize("topology", ["relay", "rpc"])
def test_load_and_cancel_through_master(request, topology):
    """A long stream through the master: the master's books show the
    load its heartbeats carried, ``POST /cancel`` on the worker ends the
    stream, and the engine is idle afterwards."""
    cluster = request.getfixturevalue(topology)
    w = cluster.workers[0]
    srid = f"cancel-me-{topology}"
    got = {}

    def run():
        got["payloads"] = list(iter_sse_events(http_stream(
            "POST", cluster.master.http_address, "/v1/chat/completions",
            {"model": MODEL, "messages": [{"role": "user",
                                           "content": "count"}],
             "max_tokens": 220, "temperature": 0.0, "stream": True,
             "ignore_eos": True, "logprobs": True},
            timeout=120.0, headers={"x-request-id": srid})))

    t = threading.Thread(target=run)
    t.start()
    try:
        assert wait_until(lambda: srid in w._live and w.engine.running,
                          timeout=30.0)
        # The engine loop waits on its lock while the master's books are
        # read (the heartbeat thread does not take it).
        with w._engine_lock:
            assert wait_until(lambda: _instance_row(cluster, w.name)
                              ["load"]["running_requests"] == 1,
                              timeout=10.0)
            load = _instance_row(cluster, w.name)["load"]
            assert load["kv_cache_usage"] > 0
            assert load["waiting_requests"] == 0
            assert load["engine_alive"] == 1
        status, resp = http_json("POST", w.name, "/cancel",
                                 {"service_request_id": srid})
        assert status == 200 and resp == {"ok": True}
    finally:
        t.join(timeout=60.0)
    assert not t.is_alive()
    assert got["payloads"][-1] == "[DONE]"
    finish = [json.loads(p)["choices"][0]["finish_reason"]
              for p in got["payloads"][:-1] if json.loads(p)["choices"]]
    assert [f for f in finish if f] == ["cancelled"]
    tokens = [p for p in got["payloads"] if p != "[DONE]" and
              (json.loads(p)["choices"] or [{}])[0].get("logprobs")]
    assert len(tokens) < 220
    assert wait_until(lambda: not w.engine.running and not w._live)
    assert wait_until(lambda: _instance_row(cluster, w.name)["load"]
                      ["running_requests"] == 0, timeout=10.0)
    status, resp = http_json("POST", w.name, "/cancel",
                             {"service_request_id": srid})
    assert status == 200 and resp == {"ok": False}


def test_metrics_exposition(relay):
    w = relay.workers[0]
    generate(relay, *REQUESTS["completion"], stream=False)
    status, text = _get_text(w.name, "/metrics")
    assert status == 200
    assert validate_exposition(text) == []
    assert f'xllm_worker_running_requests{{model="{MODEL}"}}' in text
    assert f'xllm_worker_engine_alive{{model="{MODEL}"}} 1' in text
    assert "# TYPE xllm_worker_step_ms histogram" in text
    assert f'xllm_worker_step_ms_bucket{{model="{MODEL}",phase="decode",' \
        in text
    assert f'xllm_worker_steps_total{{model="{MODEL}",phase="prefill"}}' \
        in text


def _get_text(addr, path):
    from http.client import HTTPConnection
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Leases and the master's address
# ---------------------------------------------------------------------------

def test_revoked_lease_reregisters_within_two_ticks(models):
    c = Cluster()
    try:
        w = c.add_torch_worker(models)
        old = w._lease_id
        t0 = time.monotonic()
        c.server.store.lease_revoke(old)
        assert _record(c, w) is None
        assert wait_until(lambda: _record(c, w) is not None, timeout=5.0)
        took = time.monotonic() - t0
        assert w._lease_id != old
        # Two ticks, and the scheduling slack of a loaded CPU.
        assert took <= 2 * HB_S + 2.0, took
        assert wait_until(lambda: w.name in c.listed())
        # stop() revokes the lease: the master drops the worker well
        # inside the lease's TTL.
        t0 = time.monotonic()
        w.stop()
        c.workers.remove(w)
        assert wait_until(lambda: w.name not in c.listed(),
                          timeout=w.lease_ttl_s)
        assert time.monotonic() - t0 < w.lease_ttl_s
        assert _record(c, w) is None
    finally:
        c.close()


class FakeMaster:
    """An RPC endpoint that records heartbeats; ``statuses`` are the
    replies to successive beats (200 once they run out)."""

    def __init__(self, statuses=(), epoch=1):
        self.beats = []
        self.statuses = list(statuses)
        self.epoch = epoch
        fake = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status, obj):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._reply(200, {"enable_decode_response_to_service":
                                  False, "epoch": 1})

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                fake.beats.append(json.loads(self.rfile.read(n)))
                status = fake.statuses.pop(0) if fake.statuses else 200
                self._reply(status, {"ok": status == 200,
                                     "epoch": fake.epoch})

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = "%s:%d" % self.srv.server_address[:2]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_master_address_advertisement_retargets_heartbeats(models):
    _, tcfg, jparams = models
    server = StoreServer().start()
    a, b = FakeMaster(), FakeMaster()
    w = None
    try:
        w = torch_worker.Worker(
            torch_worker.WorkerOptions(
                model=MODEL, device="cpu", store_addr=server.address,
                service_addr=a.addr, heartbeat_interval_s=HB_S),
            engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
            params=params_from_jax(jparams, tcfg, "cpu")).start()
        assert wait_until(lambda: len(a.beats) >= 1)
        server.store.put_json(coordination.KEY_MASTER_ADDR,
                              {"service_id": "b", "rpc": b.addr,
                               "http": b.addr})
        assert wait_until(lambda: len(b.beats) >= 2)
        assert w.service_addr == b.addr
        assert {hb["name"] for hb in b.beats} == {w.name}
        assert all(hb["v"] == torch_wire.WIRE_VERSION for hb in b.beats)
    finally:
        if w is not None:
            w.stop()
        a.close()
        b.close()
        server.stop()


def test_step_p99_commits_only_on_an_acked_beat(models):
    """A refused beat folds its interval into the next: the acked beat's
    p99 covers both intervals' steps, and the beat after it none."""
    _, tcfg, jparams = models
    fake = FakeMaster(statuses=[500])
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu",
                                   service_addr=fake.addr,
                                   heartbeat_interval_s=3600.0),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu"))
    try:
        h = w._m_step_ms
        for _ in range(200):
            h.observe(40.0, model=MODEL, phase="decode")
        assert w._send_heartbeat() is False           # refused
        p_refused = fake.beats[-1]["latency"]["step_ms_p99"]
        assert 20.0 < p_refused <= 50.0
        for _ in range(100):
            h.observe(400.0, model=MODEL, phase="prefill")
        assert w._send_heartbeat() is True
        p_acked = fake.beats[-1]["latency"]["step_ms_p99"]
        # 300 samples: the p99 sits among the 400 ms ones (bucket 200-500).
        assert 200.0 < p_acked <= 500.0
        assert w._send_heartbeat() is True
        assert fake.beats[-1]["latency"]["step_ms_p99"] == 0.0
        h.observe(3.0, model=MODEL, phase="decode")
        assert w._send_heartbeat() is True
        assert 2.0 < fake.beats[-1]["latency"]["step_ms_p99"] <= 5.0
    finally:
        w.stop()
        fake.close()


def test_ack_from_a_deposed_master_is_no_delivery(models):
    """An ack whose epoch is behind one already acked is refused (JAX
    worker :4424-4446): the beat counts as failed and its step interval
    stays for the next beat."""
    _, tcfg, jparams = models
    fake = FakeMaster(epoch=3)
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu",
                                   service_addr=fake.addr,
                                   heartbeat_interval_s=3600.0),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu"))
    try:
        assert w._send_heartbeat() is True
        h = w._m_step_ms
        h.observe(40.0, model=MODEL, phase="decode")
        fake.epoch = 2
        assert w._send_heartbeat() is False
        fake.epoch = 3
        assert w._send_heartbeat() is True
        assert 20.0 < fake.beats[-1]["latency"]["step_ms_p99"] <= 50.0
    finally:
        w.stop()
        fake.close()


def test_forwarded_sampling_wins_over_body_fields(relay):
    """The service-parsed ``sampling`` of a forwarded body is what the
    worker serves, not the client's fields beside it."""
    w = relay.workers[0]
    status, resp = http_json(
        "POST", w.name, "/v1/completions",
        {"model": MODEL, "prompt": "hello", "max_tokens": 20,
         "temperature": 0.7, "ignore_eos": True,
         "sampling": {"max_tokens": 5, "temperature": 0.0,
                      "ignore_eos": True}})
    assert status == 200, resp
    assert resp["usage"]["completion_tokens"] == 5
    # The forwarded n = 2 is served: two choices of 5 tokens each.
    status, resp = http_json(
        "POST", w.name, "/v1/completions",
        {"model": MODEL, "prompt": "hello", "n": 1,
         "sampling": {"max_tokens": 5, "n": 2, "ignore_eos": True}})
    assert status == 200, resp
    assert [c["index"] for c in resp["choices"]] == [0, 1]
    assert resp["usage"]["completion_tokens"] == 10


def test_standalone_worker_opens_no_store(models):
    """Given neither a store nor a service, the worker only serves: no
    store, no registration, no heartbeat thread (the engine loop and the
    encode loop only, beside the front door, whose threads are the
    server's own)."""
    _, tcfg, jparams = models
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
    try:
        assert w.store is None and w._lease_id is None
        assert [t.name for t in w._threads] == ["worker-engine-loop",
                                                "worker-encode"]
        status, resp = http_json(
            "POST", w.name, "/v1/completions",
            {"model": MODEL, "prompt": "hello", "max_tokens": 3,
             "temperature": 0.0, "ignore_eos": True})
        assert status == 200, resp
        assert resp["usage"]["completion_tokens"] == 3
    finally:
        w.stop()


def test_spawn_logs_a_crash(caplog):
    def crash():
        raise RuntimeError("boom")

    with caplog.at_level(logging.ERROR, logger=threads.__name__):
        t = threads.spawn("test.crash", crash)
        t.start()               # spawn returns it unstarted, as JAX's does
        t.join(timeout=5.0)
    assert not t.is_alive() and t.name == "test.crash"
    assert "'test.crash' crashed" in caplog.text
    assert "RuntimeError: boom" in caplog.text


def test_connect_store():
    s = coordination_net.connect_store("")
    assert isinstance(s, coordination.InMemoryStore)
    s.close()
    assert isinstance(coordination_net.connect_store("127.0.0.1:1"),
                      coordination_net.RemoteStore)
    from xllm_service_tpu_torch.service.etcd_store import EtcdStore
    etcd = coordination_net.connect_store("etcd://127.0.0.1:2379")
    assert isinstance(etcd, EtcdStore)
    assert (etcd._host, etcd._port) == ("127.0.0.1", 2379)
    # A store that does not answer is an outage, not a dead lease.
    with pytest.raises(coordination_net.StoreOutageError):
        coordination_net.RemoteStore("127.0.0.1:1",
                                     timeout=2.0).lease_keepalive(1)


def test_in_memory_store_lease_expiry_fires_delete():
    s = coordination.InMemoryStore(sweep_interval_s=0.01)
    events = []
    try:
        s.add_watch("XLLM:", events.append)
        lease = s.lease_grant(0.05)
        s.put_json("XLLM:DEFAULT:w", {"a": 1}, lease)
        assert s.get_json("XLLM:DEFAULT:w") == {"a": 1}
        assert wait_until(lambda: s.get("XLLM:DEFAULT:w") is None,
                          timeout=2.0)
        assert wait_until(lambda: [e[0] for e in events]
                          == ["PUT", "DELETE"], timeout=2.0)
        assert s.lease_keepalive(lease) is False
    finally:
        s.close()


# ---------------------------------------------------------------------------
# The prefix cache's digests on the beat, and cache-aware routing
# ---------------------------------------------------------------------------

SHARED = list(range(40, 104))            # 4 full blocks of 16 tokens


def _holders(cluster, token_ids):
    """The master's index: each instance's contiguous leading blocks of
    ``token_ids``, by storage tier."""
    return cluster.master.scheduler.kvcache_mgr.match_prefix_tiers(
        token_ids)[2]


def test_heartbeat_digests_equal_jax_workers(models):
    """One port and one JAX worker behind a cache-aware master serve the
    same prompt: the master files every block of it under both, so the
    digests each beat carried are the same bytes."""
    c = Cluster(policy=LoadBalancePolicyType.CACHE_AWARE)
    try:
        mine = c.add_torch_worker(models)
        ref = c.add_jax_worker()
        prompt = SHARED + [7, 8, 9]
        for w in (mine, ref):
            status, resp = http_json(
                "POST", w.name, "/v1/completions",
                {"token_ids": prompt, "max_tokens": 4, "temperature": 0.0,
                 "ignore_eos": True}, timeout=120.0)
            assert status == 200, resp
        assert wait_until(lambda: {mine.name, ref.name} <= set(
            _holders(c, prompt))), _holders(c, prompt)
        held = _holders(c, prompt)
        assert held[mine.name] == held[ref.name] == ["hbm"] * 4
        stats = mine.engine.prefix_cache_stats()
        assert stats["lookups_total"] == 1
        _, text = _get_text(mine.name, "/metrics")
        assert 'xllm_worker_prefix_cache_lookups_total{model="tiny"} 1' \
            in text
        validate_exposition(text)
    finally:
        c.close()


def _route(cluster, token_ids):
    """Serve ``token_ids`` through the master; the winner of its routing
    audit with the winner's candidate row and the fallback reason."""
    status, resp = http_json(
        "POST", cluster.master.http_address, "/v1/completions",
        {"model": MODEL, "token_ids": list(token_ids), "max_tokens": 4,
         "temperature": 0.0, "ignore_eos": True}, timeout=120.0)
    assert status == 200, resp
    _, text = _get_text(cluster.master.http_address,
                        f"/admin/trace/{resp['id']}")
    span = json.loads(text)
    audit = span["attrs"]["schedule_decision"]
    role = next(audit[r] for r in ("prefill", "decode")
                if audit.get(r, {}).get("candidates"))
    row = next(c for c in role["candidates"]
               if c["instance"] == role["winner"])
    return role["winner"], row["match_ratio"], role["fallback_reason"]


def _routing_run(models, kind):
    c = Cluster(policy=LoadBalancePolicyType.CACHE_AWARE)
    try:
        for _ in range(2):
            (c.add_torch_worker(models, lease_ttl_s=LOADED_LEASE_S)
             if kind == "torch"
             else c.add_jax_worker(lease_ttl_s=LOADED_LEASE_S))
        a = SHARED + [5, 6, 7]
        holder, ratio_a, fallback_a = _route(c, a)
        assert wait_until(lambda: len(_holders(c, a).get(holder, []))
                          == 4), _holders(c, a)
        runs = [(ratio_a, fallback_a)]
        for tail in ([11, 12, 13, 14, 15], [200, 201]):
            winner, ratio, fallback = _route(c, SHARED + tail)
            assert winner == holder
            runs.append((ratio, fallback))
        winner, ratio, fallback = _route(c, list(range(300, 340)))
        runs.append((ratio, fallback))
        return runs
    finally:
        c.close()


def test_cache_aware_master_routes_shared_prefix_to_holder(models):
    """A shared-prefix request goes to the worker that served the prefix,
    with the JAX workers' match ratios; a request that shares nothing
    takes the least-loaded fallback."""
    mine = _routing_run(models, "torch")
    assert mine == _routing_run(models, "jax")
    assert mine[0] == (0.0, "no_prefix_overlap")
    assert mine[1][0] > 0 and mine[1][1] is None
    assert mine[2][0] > 0 and mine[2][1] is None
    assert mine[3] == (0.0, "no_prefix_overlap")
