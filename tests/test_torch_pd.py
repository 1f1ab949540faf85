"""PD disaggregation of the port (held prefills, the KV export and import,
the handoff's transports, ``/flip_role``) against the JAX package's, on
the CPU with tiny float32 models and the same weights.

Pinned here:

- engines, dense and tiny MLA: prompts prefilled with
  ``hold_after_finish`` hold the same pages under the same ledger as the
  JAX engine's, and their exports equal JAX's within 1e-4; imported into
  a decode engine under a tight pool beside running requests, the
  streams (greedy, seeded, penalized), ``num_preemptions`` and
  ``load_metrics()`` equal JAX's after every step, and the imported
  streams equal one engine's that served the whole request; the
  refusals (layout, no slot, no pages) match;
- across packages: JAX's export imported into the port and the port's
  into JAX, with the streams of one engine;
- workers behind the reference JAX master: a port PREFILL and a port
  DECODE worker in the relay and the RPC topology, streamed and not,
  answer with the texts, finish reasons and usage of a JAX PD cluster
  and of a single worker; the transports (chunked against monolithic,
  ``chunks-missing`` falling back to the whole block, a refusal and
  ``worker.fail_kv_transfer`` falling back to local decode, the direct
  path, a duplicate import, the device wire's 424 answers through a fake
  wire); mixed clusters (a JAX prefill worker with a port decode worker
  and the reverse); and ``/flip_role`` followed by the master.
"""

import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import InstanceType as JaxInstanceType
from xllm_service_tpu.config import LoadBalancePolicyType, ServiceOptions
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination_net import StoreServer
from xllm_service_tpu.service.httpd import (http_json, http_stream,
                                            iter_sse_events)
from xllm_service_tpu.service.master import Master
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, InstanceType
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import kv_wire
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.runtime.kv_cache import encode_kv_block
from xllm_service_tpu_torch.runtime.kv_transfer import probe_kv_migration
from xllm_service_tpu_torch.service import httpd as torch_httpd
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_prefix import _model

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

# 12 usable pages of 4 tokens beside the imports' blocks: decode growth
# of the running requests and the imported ones runs the pool dry.
DECODE = dict(page_size=4, num_pages=17, max_model_len=128,
              max_batch_size=8, max_prefill_tokens=32,
              prefill_buckets=(8, 16, 32), decode_steps=1,
              enable_prefix_cache=True)
PREFILL = dict(DECODE, num_pages=64)
# (request, prompt length, sampling): greedy, seeded and penalized rows.
HANDOFF = [
    ("g", 13, dict(temperature=0.0, max_tokens=12)),
    ("s", 9, dict(temperature=0.8, top_k=8, seed=11, max_tokens=10)),
    ("p", 11, dict(temperature=0.0, presence_penalty=0.4,
                   frequency_penalty=0.6, max_tokens=12)),
]
# Running on the decode engine when the imports land (one offline).
BACKGROUND = [("bg0", 10, dict(temperature=0.0, max_tokens=14), False),
              ("bg1", 7, dict(temperature=0.0, max_tokens=16), True)]


@pytest.fixture(scope="module")
def models():
    return {kind: _model(kind) for kind in ("dense", "mla")}


def _prompts(plan, vocab):
    rng = np.random.default_rng(3)
    return {rid: rng.integers(3, vocab, size=n).tolist()
            for rid, n, *_ in plan}


def _prefill_held(eng, request, sampling, prompts):
    """Prefill every HANDOFF prompt held (max_tokens 1), to idle; returns
    the load after each step."""
    for rid, _, sp in HANDOFF:
        eng.add_request(request(rid, prompts[rid], sampling(
            **{**sp, "max_tokens": 1, "ignore_eos": False}),
            hold_after_finish=True))
    loads = []
    while eng.has_work():
        eng.step()
        loads.append(eng.load_metrics())
    return loads


def _decode_imports(eng, request, sampling, prompts, exports, import_at=2,
                    background=BACKGROUND):
    """Run ``background`` on ``eng``, import each HANDOFF export after
    step ``import_at``, and drive to idle. Returns the streams, the
    per-step (preemptions, load) and the import verdicts."""
    streams = {}
    for rid, n, sp, offline in background:
        eng.add_request(request(rid, prompts[rid], sampling(
            ignore_eos=True, **sp), offline=offline))
    steps, verdicts = [], []
    step = 0
    while eng.has_work() or step <= import_at:
        step += 1
        if step == import_at + 1:
            for rid, _, sp in HANDOFF:
                tokens, k, v = exports[rid]
                ok = eng.import_sequence(
                    request(rid, prompts[rid], sampling(ignore_eos=True,
                                                        **sp)),
                    tokens, k, v)
                verdicts.append(ok)
                streams.setdefault(rid, []).append(tokens[-1])
        for o in eng.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        steps.append((eng.num_preemptions, eng.load_metrics()))
        assert step < 300, "engine did not drain"
    return streams, steps, verdicts


def _single(eng, request, sampling, prompts):
    """Every HANDOFF request served whole by one engine."""
    for rid, _, sp in HANDOFF:
        eng.add_request(request(rid, prompts[rid],
                                sampling(ignore_eos=True, **sp)))
    streams = {}
    while eng.has_work():
        for o in eng.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
    return streams


def _port_request(rid, tokens, sampling, **kw):
    return EngineRequest(rid, list(tokens), sampling, **kw)


def _jax_request(rid, tokens, sampling, **kw):
    return JaxRequest(rid, list(tokens), sampling, **kw)


@pytest.mark.parametrize("kind", ["dense", "mla"])
def test_handoff_matches_jax(models, kind):
    """One engine of each package prefills, then decodes; the dense pair
    under the tight pool beside BACKGROUND, the MLA pair alone (its
    preemptions are the dense pair's code, and each MLA shape costs the
    JAX engine a compile)."""
    jcfg, tcfg, jparams, tparams = models[kind]
    prompts = _prompts(HANDOFF + [b[:3] for b in BACKGROUND],
                       tcfg.vocab_size)
    background, ecfg = (BACKGROUND, DECODE) if kind == "dense" else \
        ((), PREFILL)
    jpre = JaxEngine(jcfg, JaxEngineConfig(**ecfg), params=jparams)
    tpre = Engine(tcfg, EngineConfig(**ecfg), params=tparams, device="cpu")
    jloads = _prefill_held(jpre, _jax_request, JaxSampling, prompts)
    tloads = _prefill_held(tpre, _port_request, SamplingParams, prompts)
    assert tloads == jloads
    assert {r: s.pages for r, s in tpre._held.items()} == \
        {r: s.pages for r, s in jpre._held.items()}
    assert tpre.load_metrics()["kv_cache_usage"] > 0    # held = used
    jexp, texp = {}, {}
    for rid, *_ in HANDOFF:
        jexp[rid] = jpre.export_held(rid)
        texp[rid] = tpre.export_held(rid)
        assert texp[rid][0] == jexp[rid][0]
        for t, j in zip(texp[rid][1:], jexp[rid][1:]):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                       rtol=0)
    assert tpre.export_held("g") is None and not tpre._held
    assert tpre.load_metrics() == jpre.load_metrics()
    assert tpre.allocator.num_free + tpre.prefix_cache.num_reclaimable \
        == ecfg["num_pages"] - 1
    # Each engine adopts its own package's export.
    want = _decode_imports(jpre, _jax_request, JaxSampling, prompts, jexp,
                           background=background)
    got = _decode_imports(tpre, _port_request, SamplingParams, prompts,
                          texp, background=background)
    assert got[2] == want[2] == [True] * len(HANDOFF)
    assert got[0] == want[0]
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert g == w, f"step {i + 1}: {g} != {w}"
    assert len(got[1]) == len(want[1])
    assert (tpre.num_preemptions > 0) == bool(background)
    # The handoff changes no stream: one engine serving each request.
    solo = _single(Engine(tcfg, EngineConfig(**PREFILL), params=tparams,
                          device="cpu"), _port_request, SamplingParams,
                   prompts)
    for rid, *_ in HANDOFF:
        assert got[0][rid] == solo[rid], rid


REFUSALS = ["layout", "slot", "pages"]


@pytest.mark.parametrize("case", REFUSALS)
def test_import_refusals_match_jax(models, case):
    jcfg, tcfg, jparams, tparams = models["dense"]
    kw = dict(DECODE)
    if case == "slot":
        kw["max_batch_size"] = 1
    if case == "pages":
        kw["num_pages"] = 8
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams)
    teng = Engine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    L, H, D = tcfg.num_layers, tcfg.kv_cache_heads, tcfg.kv_cache_dim
    tokens = list(range(3, 3 + 10))          # 9 with KV: 3 pages of 4
    n = 2 if case == "layout" else 3
    k = np.random.default_rng(0).standard_normal(
        (L, n, 4, H, D)).astype(np.float32)
    results = []
    for eng, req, sp, conv in (
            (jeng, _jax_request, JaxSampling, np.asarray),
            (teng, _port_request, SamplingParams, torch.from_numpy)):
        if case in ("slot", "pages"):
            # A running request takes the slot, or most of the pool.
            eng.add_request(req("busy", list(range(3, 3 + 21)),
                                sp(temperature=0.0, max_tokens=4)))
            eng.step()
        results.append((eng.import_sequence(
            req("m", tokens[:-1], sp(temperature=0.0, max_tokens=4)),
            tokens, conv(k), conv(k.copy())), eng.load_metrics(),
            eng.num_preemptions))
    assert results[0] == results[1]
    assert results[1][0] is False


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoff_across_packages(models, direction):
    jcfg, tcfg, jparams, tparams = models["dense"]
    prompts = _prompts(HANDOFF + [b[:3] for b in BACKGROUND],
                       tcfg.vocab_size)
    if direction == "jax_to_port":
        pre = JaxEngine(jcfg, JaxEngineConfig(**PREFILL), params=jparams)
        _prefill_held(pre, _jax_request, JaxSampling, prompts)
        exp = {}
        for rid, *_ in HANDOFF:
            tokens, k, v = pre.export_held(rid)
            exp[rid] = (tokens, torch.from_numpy(np.array(k)),
                        torch.from_numpy(np.array(v)))
        dec = Engine(tcfg, EngineConfig(**PREFILL), params=tparams,
                     device="cpu")
        got = _decode_imports(dec, _port_request, SamplingParams, prompts,
                              exp)
        solo = _single(Engine(tcfg, EngineConfig(**PREFILL),
                              params=tparams, device="cpu"),
                       _port_request, SamplingParams, prompts)
    else:
        pre = Engine(tcfg, EngineConfig(**PREFILL), params=tparams,
                     device="cpu")
        _prefill_held(pre, _port_request, SamplingParams, prompts)
        exp = {}
        for rid, *_ in HANDOFF:
            tokens, k, v = pre.export_held(rid)
            exp[rid] = (tokens, k.numpy(), v.numpy())
        dec = JaxEngine(jcfg, JaxEngineConfig(**PREFILL), params=jparams)
        got = _decode_imports(dec, _jax_request, JaxSampling, prompts, exp)
        # One port engine's streams: test_handoff_matches_jax holds the
        # two packages' streams equal.
        solo = _single(Engine(tcfg, EngineConfig(**PREFILL),
                              params=tparams, device="cpu"),
                       _port_request, SamplingParams, prompts)
    assert got[2] == [True] * len(HANDOFF)
    for rid, *_ in HANDOFF:
        assert got[0][rid] == solo[rid], rid


def test_import_rebuilds_penalty_counts(models):
    """A penalized import into a slot that a finished penalized request
    left: the port rebuilds the counts from the token lists (the stream
    equals one engine's); the JAX engine keeps the stale row."""
    jcfg, tcfg, jparams, tparams = models["dense"]
    prompts = _prompts(HANDOFF, tcfg.vocab_size)
    sp = dict(HANDOFF[2][2])
    streams = []
    for E, ecfg, req, smp, kw in (
            (JaxEngine, JaxEngineConfig, _jax_request, JaxSampling,
             dict(params=jparams)),
            (Engine, EngineConfig, _port_request, SamplingParams,
             dict(params=tparams, device="cpu"))):
        cfg = jcfg if E is JaxEngine else tcfg
        # Hold p's prefill, then serve a penalized request to its end on
        # the same engine, then adopt p.
        dec = E(cfg, ecfg(**PREFILL), **kw)
        dec.add_request(req("p", prompts["p"], smp(
            **{**sp, "max_tokens": 1}), hold_after_finish=True))
        while dec.has_work():
            dec.step()
        dec.add_request(req("first", prompts["g"], smp(ignore_eos=True,
                                                       **sp)))
        while dec.has_work():
            dec.step()
        tokens, k, v = dec.export_held("p")
        assert dec.import_sequence(req("p", prompts["p"], smp(
            ignore_eos=True, **sp)), tokens, k, v)
        out = [tokens[-1]]
        while dec.has_work():
            for o in dec.step():
                out += o.new_token_ids
        streams.append(out)
    jax_out, port_out = streams
    # One engine's stream (test_handoff_matches_jax holds the two
    # packages' streams equal).
    solo = _single(Engine(tcfg, EngineConfig(**PREFILL), params=tparams,
                          device="cpu"), _port_request, SamplingParams,
                   prompts)["p"]
    assert port_out == solo
    assert jax_out != solo


def test_cancelled_hold_releases_and_swa_keeps_pages(models):
    """A cancelled held prefill keeps nothing; ``drop_held`` releases a
    held one unread; a sliding-window model trims no page of a held
    prefill, whose export ships the whole prefix as the JAX engine's."""
    jcfg, tcfg, jparams, tparams = models["dense"]
    eng = Engine(tcfg, EngineConfig(**PREFILL), params=tparams,
                 device="cpu")
    for rid in ("a", "b"):
        eng.add_request(EngineRequest(rid, list(range(3, 14)),
                                      SamplingParams(max_tokens=1),
                                      hold_after_finish=True))
    eng.cancel("a")
    while eng.has_work():
        eng.step()
    assert list(eng._held) == ["b"]
    eng.drop_held("b")
    assert not eng._held and eng.export_held("b") is None
    assert eng.load_metrics()["kv_cache_usage"] == 0
    exports = []
    for E, cfg, ecfg, req, smp, kw in (
            (JaxEngine, jcfg, JaxEngineConfig, _jax_request, JaxSampling,
             dict(params=jparams)),
            (Engine, tcfg, EngineConfig, _port_request, SamplingParams,
             dict(params=tparams, device="cpu"))):
        e = E(dataclasses.replace(cfg, sliding_window=4), ecfg(**PREFILL),
              **kw)
        e.add_request(req("w", list(range(3, 20)),
                          smp(temperature=0.0, max_tokens=1),
                          hold_after_finish=True))
        while e.has_work():
            e.step()
        assert all(e._held["w"].pages)          # no NULL entry: untrimmed
        tokens, k, v = e.export_held("w")
        exports.append((tokens, np.asarray(k), np.asarray(v)))
    (jt, jk, jv), (tt, tk, tv) = exports
    assert tt == jt and tk.shape[1] == 5
    np.testing.assert_allclose(tk, jk, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)


def test_probe_kv_migration(models):
    _, tcfg, _, tparams = models["dense"]
    a = Engine(tcfg, EngineConfig(**PREFILL), params=tparams, device="cpu")
    b = Engine(tcfg, EngineConfig(**PREFILL), params=tparams, device="cpu")
    out = probe_kv_migration(a, b, n_pages=8, iters=2)
    assert set(out) == {"bytes", "pages", "direct_gbps", "host_gbps",
                        "host_pipelined_gbps"}
    assert out["pages"] == 8 and out["bytes"] == 8 * a.kv_block_bytes()
    assert min(out["direct_gbps"], out["host_gbps"],
               out["host_pipelined_gbps"]) > 0
    torch.testing.assert_close(b.kv[0][:, 1:9], a.kv[0][:, 1:9])


def test_device_wire_absent_on_cpu():
    """Without a GPU there is no wire: the pull says so (the prefill
    side then stops offering it), as it does for another wire's
    ticket."""
    assert kv_wire.get_device_wire() is None
    with pytest.raises(kv_wire.WireUnsupported):
        kv_wire.pull_block({"addr": "x", "uuid": 1})


# ---------------------------------------------------------------------------
# Workers behind the reference master
# ---------------------------------------------------------------------------

HB_S = 0.2
MODEL = "tiny"
WORKER_ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
                     max_batch_size=4, max_prefill_tokens=256,
                     prefill_buckets=(32, 64, 128))
BODIES = {
    "greedy": dict(prompt="migrate me please, twice over", max_tokens=7,
                   temperature=0.0, ignore_eos=True),
    "seeded": dict(prompt="seeded handoff", max_tokens=6, temperature=0.9,
                   seed=5, ignore_eos=True),
    "penalized": dict(prompt="penalize the repeats", max_tokens=8,
                      temperature=0.0, frequency_penalty=0.7,
                      presence_penalty=0.3, ignore_eos=True),
}


def wait_until(cond, timeout=15.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


@pytest.fixture(scope="module")
def wmodels():
    jcfg, tcfg, jparams, _ = _model("dense")
    jcfg = dataclasses.replace(jcfg, vocab_size=512)
    tcfg = dataclasses.replace(tcfg, vocab_size=512)
    from xllm_service_tpu.models import transformer as jtf
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, MODEL, lambda: jcfg)
    yield jcfg, tcfg, jparams
    mp.undo()


class PdCluster:
    """A StoreServer, the JAX master on it, and a prefill and a decode
    worker of the named packages."""

    def __init__(self, wmodels, prefill: str, decode: str,
                 rpc: bool = False) -> None:
        self.server = StoreServer().start()
        self.master = Master(ServiceOptions(
            http_port=0, rpc_port=0, num_output_pools=4,
            load_balance_policy=LoadBalancePolicyType.ROUND_ROBIN,
            block_size=16, heartbeat_interval_s=HB_S,
            master_upload_interval_s=HB_S,
            enable_decode_response_to_service=rpc),
            store=self.server.store).start()
        self.workers = [self._worker(wmodels, pkg, role)
                        for pkg, role in ((prefill, "PREFILL"),
                                          (decode, "DECODE"))]
        mgr = self.master.scheduler.instance_mgr
        assert wait_until(lambda: len(mgr.prefill_instances()) == 1
                          and len(mgr.decode_instances()) == 1), \
            "the PD pair never registered"
        if rpc:
            assert wait_until(lambda: all(
                w._decode_to_service for w in self.workers))

    def _worker(self, wmodels, pkg, role):
        jcfg, tcfg, jparams = wmodels
        if pkg == "jax":
            return jax_worker.Worker(
                jax_worker.WorkerOptions(
                    port=0, instance_type=JaxInstanceType(role),
                    service_addr=self.master.rpc_address, model=MODEL,
                    heartbeat_interval_s=HB_S, lease_ttl_s=3 * HB_S,
                    pd_direct_kv=False, pd_device_wire=False),
                self.server.store,
                engine_cfg=JaxEngineConfig(**WORKER_ENGINE)).start()
        return torch_worker.Worker(
            torch_worker.WorkerOptions(
                model=MODEL, device="cpu", instance_type=InstanceType(role),
                store_addr=self.server.address,
                service_addr=self.master.rpc_address,
                heartbeat_interval_s=HB_S, pd_direct_kv=False),
            engine_cfg=EngineConfig(**WORKER_ENGINE), model_cfg=tcfg,
            params=params_from_jax(jparams, tcfg, "cpu")).start()

    @property
    def prefill(self):
        return self.workers[0]

    @property
    def decode(self):
        return self.workers[1]

    def close(self) -> None:
        for w in self.workers:
            w.stop()
        self.master.stop()
        self.server.stop()


def _complete(addr, name, stream=False, chat=False):
    body = {"model": MODEL, **BODIES[name], "stream": stream}
    path = "/v1/completions"
    if chat:
        body["messages"] = [{"role": "user", "content": body.pop("prompt")}]
        path = "/v1/chat/completions"
    if not stream:
        status, resp = http_json("POST", addr, path, body, timeout=120.0)
        assert status == 200, resp
        ch = resp["choices"][0]
        text = ch["message"]["content"] if chat else ch["text"]
        return text, ch["finish_reason"], resp["usage"]["completion_tokens"]
    payloads = list(iter_sse_events(http_stream("POST", addr, path, body,
                                                timeout=120.0)))
    assert payloads[-1] == "[DONE]"
    objs = [json.loads(p) for p in payloads[:-1]]
    text, finish = "", None
    for o in objs:
        for ch in o.get("choices") or []:
            text += (ch.get("delta", {}).get("content", "") if chat
                     else ch.get("text", ""))
            finish = ch.get("finish_reason") or finish
    return text, finish, BODIES[name]["max_tokens"]


# Every body as a completion, streamed and not, and the greedy one as a
# chat; no two penalized requests in a row (see ``reference``).
FORMS = [("greedy", False, False), ("penalized", False, False),
         ("seeded", False, False), ("greedy", True, False),
         ("penalized", True, False), ("seeded", True, False),
         ("greedy", False, True), ("greedy", True, True)]


@pytest.fixture(scope="module")
def reference(wmodels):
    """The answers of a JAX PD cluster (relay), every body and form.
    Between two penalized requests another one decodes on its decode
    worker: the JAX engine's ``import_sequence`` keeps the decode
    runner's penalty counts, and only a decode with no penalized row
    drops them, so an import into the slot a finished penalized request
    left would count that request's tokens too
    (``test_import_rebuilds_penalty_counts``)."""
    c = PdCluster(wmodels, "jax", "jax")
    try:
        return {f: _complete(c.master.http_address, *f) for f in FORMS}
    finally:
        c.close()


@pytest.fixture(scope="module")
def port_pd(wmodels):
    c = PdCluster(wmodels, "port", "port")
    yield c
    c.close()


def _counts(w):
    return (w.kv_migration_direct, w.kv_migration_device_wire,
            w.kv_migration_chunked, w.kv_migration_bytes)


def test_single_worker_equals_jax_pd(wmodels, reference):
    """A single port worker (no handoff) answers as the JAX PD pair."""
    jcfg, tcfg, jparams = wmodels
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**WORKER_ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
    try:
        for name in BODIES:
            assert _complete(w.name, name) == reference[(name, False, False)]
    finally:
        w.stop()


@pytest.mark.parametrize("chat", [False, True], ids=["completion", "chat"])
@pytest.mark.parametrize("stream", [False, True], ids=["full", "stream"])
def test_port_pd_relay_equals_jax(port_pd, reference, stream, chat):
    before = _counts(port_pd.prefill)
    for name in BODIES:
        if (name, stream, chat) in reference:
            assert _complete(port_pd.master.http_address, name, stream,
                             chat) == reference[(name, stream, chat)], name
    after = _counts(port_pd.prefill)
    assert after[3] > before[3]             # the host shuttle moved bytes
    assert after[:3] == before[:3]
    assert port_pd.prefill.engine.num_held == 0
    assert wait_until(lambda: not port_pd.decode._live_srid)


def test_port_pd_rpc_equals_jax(wmodels, reference):
    c = PdCluster(wmodels, "port", "port", rpc=True)
    try:
        for stream in (False, True):
            for name in BODIES:
                assert _complete(c.master.http_address, name, stream) == \
                    reference[(name, stream, False)], (name, stream)
        assert c.prefill.kv_migration_bytes > 0
        assert c.decode.engine.step_count > 0
    finally:
        c.close()


@pytest.mark.parametrize("pair", [("jax", "port"), ("port", "jax")],
                         ids=["jax_prefill", "port_prefill"])
def test_mixed_cluster_equals_jax(wmodels, reference, pair):
    c = PdCluster(wmodels, *pair)
    try:
        for stream in (False, True):
            for name in BODIES:
                assert _complete(c.master.http_address, name, stream) == \
                    reference[(name, stream, False)], (name, stream)
        assert c.prefill.kv_migration_bytes > 0
        steps = (c.decode.engine.step_count if pair[1] == "port"
                 else c.decode.primary_runtime().engine.step_count)
        assert steps > 0
    finally:
        c.close()


def test_chunked_shuttle_equals_monolithic(port_pd, reference):
    pre = port_pd.prefill
    try:
        pre._kv_shuttle_chunk_mb = 1e-6      # one layer a chunk
        before = _counts(pre)
        assert _complete(port_pd.master.http_address, "greedy") == \
            reference[("greedy", False, False)]
        assert pre.kv_migration_chunked == before[2] + 1
        assert not port_pd.decode._kv_chunk_staging
    finally:
        pre._kv_shuttle_chunk_mb = 32.0


def test_chunks_missing_falls_back_monolithic(port_pd, reference,
                                              monkeypatch):
    pre, dec = port_pd.prefill, port_pd.decode
    monkeypatch.setattr(pre, "_kv_shuttle_chunk_mb", 1e-6)
    monkeypatch.setattr(dec, "_pop_staged_chunks", lambda *a: None)
    before, steps = _counts(pre), dec.engine.step_count
    assert _complete(port_pd.master.http_address, "penalized") == \
        reference[("penalized", False, False)]
    after = _counts(pre)
    assert after[2] == before[2] and after[3] > before[3]
    assert dec.engine.step_count > steps     # adopted, not local


@pytest.mark.parametrize("how", ["refusal", "failpoint"])
def test_fallback_decodes_locally(port_pd, reference, monkeypatch, how):
    pre, dec = port_pd.prefill, port_pd.decode
    if how == "refusal":
        monkeypatch.setattr(dec.engine, "import_sequence",
                            lambda *a, **k: False)
    else:
        pre.failpoints.arm_from_body({"name": "worker.fail_kv_transfer",
                                      "mode": "count", "n": 1})
    steps = dec.engine.step_count
    for stream in (False, True):
        assert _complete(port_pd.master.http_address, "seeded", stream) == \
            reference[("seeded", stream, False)]
        if how == "failpoint":
            break
    assert dec.engine.step_count == steps    # decoded on the prefill side
    assert not dec._live_srid and pre.engine.num_held == 0
    if how == "failpoint":
        assert pre.failpoints.state()["trips"].get(
            "worker.fail_kv_transfer") == 1


def test_direct_path(port_pd, reference, monkeypatch):
    pre = port_pd.prefill
    monkeypatch.setattr(pre.opts, "pd_direct_kv", True)
    before = _counts(pre)
    for stream in (False, True):
        assert _complete(port_pd.master.http_address, "greedy", stream) == \
            reference[("greedy", stream, False)]
    after = _counts(pre)
    assert after[0] == before[0] + 2 and after[1:3] == before[1:3]
    assert wait_until(lambda: not port_pd.decode._live_srid)


def test_duplicate_import_is_idempotent(wmodels):
    """A second import of a live request adopts nothing: the direct path
    returns the live request, and ``/kv/import`` answers the RPC
    topology's idempotent accept (a 503 in the relay topology)."""
    c = PdCluster(wmodels, "port", "port", rpc=True)
    try:
        pre, dec = c.prefill, c.decode
        tokens = list(range(3, 3 + 20))
        L = c.decode.model_cfg.num_layers
        shape = (L, 2, 16, c.decode.model_cfg.kv_cache_heads,
                 c.decode.model_cfg.kv_cache_dim)
        k = torch.randn(shape)
        meta = {"service_request_id": "dup-1", "model": MODEL,
                "tokens": tokens, "prompt_len": 19, "mm": None,
                "sampling": SamplingParams(temperature=0.0, max_tokens=400,
                                           ignore_eos=True).to_json(),
                "stream": False}
        # The first adoption decodes up to max_model_len: still live
        # while the duplicates arrive.
        ok, live, _ = dec.adopt_migrated(meta, k, k.clone())
        assert ok and live.stream_to_service
        ok2, live2, first2 = dec.adopt_migrated(meta, k, k.clone())
        assert (ok2, live2, first2) == (False, live, None)
        status, resp = torch_httpd.http_json(
            "POST", dec.name, "/kv/import", raw=encode_kv_block(k, k, meta))
        assert (status, resp["status"]) == (200, "accepted")
        assert dec.engine.live_request_ids() == ("dup-1",)
        dec.cancel_request("dup-1")
        assert wait_until(lambda: not dec._live_srid)
    finally:
        c.close()


class FakeWire:
    """A device wire for the CPU: stages in this process, pulls by uuid."""

    staged = {}

    def __init__(self, busy=False):
        self.address, self.leaked, self.busy = "fake", 0, busy

    def stage(self, k, v):
        if self.busy:
            raise kv_wire.WireBusy("no staging segment")
        uuid = len(FakeWire.staged) + 1
        FakeWire.staged[uuid] = (k.clone(), v.clone())
        return uuid

    def ticket(self, uuid):
        return {"addr": self.address, "uuid": uuid, "handle": "00",
                "pid": -1, "event": "00", "shape": [], "dtype": "float32",
                "nbytes": 0}

    def release(self, uuid, leaked=False):
        FakeWire.staged.pop(uuid, None)
        self.leaked += bool(leaked)

    def staged_count(self):
        return len(FakeWire.staged)


@pytest.mark.parametrize("failure,refused", [
    (None, False), ("unsupported", True), ("nopull", False),
    ("transient", False), ("busy", False)])
def test_device_wire_verdicts(port_pd, reference, monkeypatch, failure,
                              refused):
    """The wire's ticket path and its 424s, as in the JAX package's
    ``test_device_wire_pull_failure_falls_back_to_host``: a pull is a
    device-wire migration; a failed pull falls back to the host shuttle,
    and only wire-unsupported stops the offers to that peer. A stage
    that finds no segment (``busy``) takes the shuttle too."""
    pre, dec = port_pd.prefill, port_pd.decode
    wire = FakeWire(busy=failure == "busy")

    def pull(tr):
        if failure == "unsupported":
            raise kv_wire.WireUnsupported("backend cannot pull")
        if failure == "nopull":
            raise kv_wire.WireNoPull("connect failed")
        if failure == "transient":
            raise RuntimeError("reset mid-pull")
        return FakeWire.staged[tr["uuid"]]

    monkeypatch.setattr(kv_wire, "get_device_wire", lambda: wire)
    monkeypatch.setattr(kv_wire, "pull_block", pull)
    monkeypatch.setattr(pre, "_wire_refused", set())
    before = _counts(pre)
    assert _complete(port_pd.master.http_address, "greedy") == \
        reference[("greedy", False, False)]
    after = _counts(pre)
    assert after[1] == before[1] + (failure is None)
    assert after[3] > before[3]
    assert (dec.name in pre._wire_refused) == refused
    assert wire.staged_count() == 0
    assert wire.leaked == (failure == "transient")


def test_metrics_count_migrations(port_pd):
    from xllm_service_tpu.obs import validate_exposition
    status, _ = http_json("GET", port_pd.prefill.name, "/hello")
    text = port_pd.prefill.metrics_text()
    validate_exposition(text)
    for key in ("bytes", "seconds", "direct", "device_wire", "chunked"):
        assert f"xllm_worker_kv_migration_{key}_total" in text
    # No wire on the CPU: its series read zero.
    for series in ("xllm_worker_kv_wire_reserved_bytes 0",
                   "xllm_worker_kv_wire_busy_total 0",
                   "xllm_worker_kv_wire_leaked_total 0"):
        assert series in text


def _bare_wire(monkeypatch, max_mb):
    """A DeviceWire without a device: segments are bookkeeping only."""
    wire = kv_wire.DeviceWire.__new__(kv_wire.DeviceWire)
    wire._mu = threading.Lock()
    wire._released = threading.Condition(wire._mu)
    wire.max_bytes, wire.busy, wire.leaked = max_mb << 20, 0, 0
    wire._segments, wire._staged, wire._next_uuid = [], {}, 1

    def new_segment(size):
        seg = kv_wire._Segment(None, size, "", None, "")
        wire._segments.append(seg)
        return seg
    monkeypatch.setattr(wire, "_new_segment", new_segment)
    monkeypatch.setattr(kv_wire, "BUSY_WAIT_S", 0.5)
    return wire


def _take(wire, nbytes):
    with wire._mu:
        seg = wire._segment_for(nbytes)
        uuid = wire._next_uuid
        wire._next_uuid += 1
        seg.uuid = uuid
        wire._staged[uuid] = (seg, {})
    return uuid


def test_device_wire_segments_capped(monkeypatch):
    """The staging segments stay within their cap: a free one
    is reused, a stage waits for a release, and with no segment that
    can come free (all leaked, or a block above the cap) it is refused
    at once; refusals are counted."""
    wire = _bare_wire(monkeypatch, 128)
    a = _take(wire, 10 << 20)
    b = _take(wire, 10 << 20)
    assert wire.reserved_bytes() == 128 << 20      # two 64 MiB segments
    # Full: a release from another thread hands its segment over.
    threading.Timer(0.1, wire.release, (a,)).start()
    t0 = time.monotonic()
    c = _take(wire, 30 << 20)
    assert 0.05 < time.monotonic() - t0 < 0.5
    assert wire.reserved_bytes() == 128 << 20 and wire.busy == 0
    # No release comes: refused after the wait.
    with pytest.raises(kv_wire.WireBusy):
        _take(wire, 1 << 20)
    assert wire.busy == 1
    # Leaked segments never come free: refused without waiting.
    wire.release(b, leaked=True)
    wire.release(c, leaked=True)
    t0 = time.monotonic()
    with pytest.raises(kv_wire.WireBusy):
        _take(wire, 1 << 20)
    assert time.monotonic() - t0 < 0.1
    assert (wire.busy, wire.leaked) == (2, 2)
    # A block above the cap: refused at once.
    with pytest.raises(kv_wire.WireBusy):
        _take(_bare_wire(monkeypatch, 64), 65 << 20)
    assert kv_wire.wire_stats() == {"reserved_bytes": 0, "busy": 0,
                                    "leaked": 0}


def test_flip_role_followed_by_master(port_pd, reference):
    """Runs last on the shared cluster: the roles swap, the master's
    lists follow, and the next PD request prefills on the old decode
    worker."""
    c = port_pd
    pre, dec = c.prefill, c.decode

    def lists():
        out = {}
        for role in ("prefill", "decode"):
            status, resp = http_json("GET", c.master.rpc_address,
                                     f"/rpc/static_{role}_list")
            assert status == 200, resp
            out[role] = resp["instances"]
        return out

    assert lists() == {"prefill": [pre.name], "decode": [dec.name]}
    for w, role in ((pre, "DECODE"), (dec, "PREFILL")):
        status, resp = http_json("POST", w.name, "/flip_role",
                                 {"instance_type": role})
        assert (status, resp) == (200, {"ok": True, "instance_type": role})
    status, resp = http_json("POST", pre.name, "/flip_role",
                             {"instance_type": "NOPE"})
    assert status == 400
    assert wait_until(lambda: lists() == {"prefill": [dec.name],
                                          "decode": [pre.name]})
    before = dec.kv_migration_bytes
    assert _complete(c.master.http_address, "greedy") == \
        reference[("greedy", False, False)]
    assert dec.kv_migration_bytes > before
