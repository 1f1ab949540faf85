"""The cross-worker KV block fetch of the port (the prefix index's run
and positional registration, the engine's block export and adoption,
the worker's ``/kv/blocks`` holder and its requester following the
master's ``kv_fetch`` plan) and the registration's profiling samples,
against the JAX package, on the CPU with tiny float32 models and the
same weights.

Pinned here:

- ``PrefixCacheIndex.pages_for_hashes`` / ``register_blocks``: the
  pages, pins, ``stored`` events and return values of JAX's over the
  same operation sequences;
- ``Engine.export_blocks``: ``n`` equal to JAX's and k/v within
  ``EXPORT_ATOL`` (1e-4; the pools of two float32 forwards), from the
  pools, with tails parked in the host tier, and ``None`` once the run
  is evicted;
- ``Engine.adopt_blocks``: JAX's return value and no change on each
  refusal (layout, an unresolvable lead, a run past the prompt, no
  pages); adoption across packages both ways and within the port
  (dense, exactly once, an unreachable run refused), a run adopted
  behind a lead parked in the host tier, and a tiny DeepSeek (MLA)
  case: the temperature-0 streams after adoption equal a recompute's;
- F4: port and JAX workers behind the JAX master (round robin, a
  ``fetch`` verdict forced by ``XLLM_KV_FETCH_GBPS`` /
  ``XLLM_KV_FETCH_OVERHEAD_MS``): a port holder serves a JAX target
  (one attempt, no failure, bytes adopted, the text of a recompute), a
  JAX holder a port target (also with the wire offered: the JAX
  holder's PJRT ticket is acknowledged ``nopull`` and the bytes are
  fetched), and port serves port, over the bytes and over a fake CUDA
  IPC wire; the fallbacks (``worker.fail_kv_fetch``, a holder that
  evicted the run) counted and texts unchanged; the holder's answers to
  bad asks (strict model, JSON, hex, no hashes, ``/kv/blocks_done``)
  equal to a JAX holder's; the staged tickets' TTL sweep;
- ``kv_gbps`` on the beat, the ``/metrics`` series under the JAX
  names and help texts, and ``--enable-profiling``: the JAX
  ``profile_engine``'s requests and sample keys, and a master's
  ``TimePredictor`` for the port instance predicting > 0 ms.
"""

import dataclasses
import json
import re
import time

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.obs import validate_exposition
from xllm_service_tpu.runtime import kv_cache as jkv
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service import time_predictor as jtp
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import kv_cache as tkv
from xllm_service_tpu_torch.runtime import kv_wire
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.service import time_predictor as ttp
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_cluster import MODEL, Cluster
from tests.test_torch_cluster import wait_until
from tests.test_torch_prefix import _events, _model
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

# The pools of two float32 forwards of the same weights (the PD export's
# tolerance, tests/test_torch_pd.py).
EXPORT_ATOL = 1e-4
# Engines: pages of 4 tokens. HOLD: 23 usable pages, no host tier; TIER:
# 15 usable pages and a host tier, so that a long prompt spills the
# cached pages of an earlier one.
HOLD = dict(page_size=4, num_pages=24, max_model_len=128, max_batch_size=4,
            max_prefill_tokens=32, prefill_buckets=(8, 16, 32),
            decode_steps=1, enable_prefix_cache=True)
TIER = dict(HOLD, num_pages=16, kv_spill_mb=64.0)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 128, size=n).tolist()


# ---------------------------------------------------------------------------
# (a) the index, operation by operation
# ---------------------------------------------------------------------------

def _case_run_and_pins(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(8), page_size=4)
    tokens = list(range(16))
    pages = idx.alloc(4)
    idx.register_full_pages(tokens, pages)
    idx.release_pages(pages)
    hashes = idx.block_hashes(tokens)
    # A run stops at the first miss; the pages come back pinned, so the
    # allocation's reclamation cannot take them.
    run = idx.pages_for_hashes([hashes[0], hashes[1], b"\0" * 16,
                                hashes[3]])
    trace = [run, idx.num_reclaimable, idx.alloc(7), idx.alloc(5)]
    idx.release_pages(run)
    trace += [idx.num_reclaimable, idx.pages_for_hashes([b"\1" * 16]),
              _events(idx.drain_event())]
    return trace


def _case_register_exactly_once(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(8), page_size=4, seed=5)
    hashes = idx.block_hashes(list(range(12)))
    pages = idx.alloc(3)
    trace = [idx.register_blocks(hashes, pages),
             # The same run again, and a digest already owned by another
             # page: nothing registers twice.
             idx.register_blocks(hashes, pages)]
    spare = idx.alloc(2)
    trace.append(idx.register_blocks(hashes[1:3], spare))
    # A page that holds another digest is remapped.
    other = idx.block_hashes(list(range(50, 54)))
    trace += [idx.register_blocks(other, pages[2:]),
              idx.page_of(hashes[2]), idx.page_of(other[0])]
    idx.release_pages(pages)
    idx.release_pages(spare)
    trace += [idx.num_reclaimable, idx.allocator.num_free,
              idx.match_prefix(list(range(12)) + [9]),
              _events(idx.drain_event())]
    return trace


def _case_register_past_gap(kv):
    # Positional registration does not walk the chain: the caller
    # guarantees that the run's lead resolves.
    idx = kv.PrefixCacheIndex(kv.PageAllocator(8), page_size=2)
    tokens = list(range(8))
    hashes = idx.block_hashes(tokens)
    pages = idx.alloc(2)
    trace = [idx.register_blocks(hashes[2:], pages),
             idx.match_prefix(tokens + [1])]
    lead = idx.alloc(2)
    trace.append(idx.register_blocks(hashes[:2], lead))
    hit = idx.match_prefix(tokens + [1])
    trace += [hit, _events(idx.drain_event())]
    return trace


@pytest.mark.parametrize("case", [
    _case_run_and_pins, _case_register_exactly_once,
    _case_register_past_gap], ids=lambda f: f.__name__[6:])
def test_index_operations_equal_jax(case):
    assert case(tkv) == case(jkv)


# ---------------------------------------------------------------------------
# (b) engines: export and adoption
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return {kind: _model(kind) for kind in ("dense", "mla")}


@pytest.fixture(scope="module")
def engines(models):
    """Module-scoped (JAX, port) pairs, shared by the cases below, each
    case on prompts of its own: ``hold`` and ``tier`` (dense), and the
    targets ``hold_b`` (port only)."""
    jcfg, tcfg, jparams, tparams = models["dense"]

    def port(kw):
        return Engine(tcfg, EngineConfig(**kw), params=tparams,
                      device="cpu")

    def jax_eng(kw):
        return JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams)

    return {"hold": (jax_eng(HOLD), port(HOLD)),
            "tier": (jax_eng(TIER), port(TIER)),
            "hold_b": port(HOLD), "port": port}


def _run(eng, prompt, rid, max_tokens=6):
    req, sp = ((EngineRequest, SamplingParams) if isinstance(eng, Engine)
               else (JaxRequest, JaxSampling))
    eng.add_request(req(rid, list(prompt), sp(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True)))
    toks = []
    while eng.has_work():
        for o in eng.step():
            if o.request_id == rid:
                toks.extend(o.new_token_ids)
    return toks


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port_t(a):
    """A port tensor of an export of either package (a copy)."""
    return torch.from_numpy(np.array(_np(a)))


def _same_export(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got[0] == want[0]
    for t, j in zip(got[1:], want[1:]):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=EXPORT_ATOL,
                                   rtol=0)


def _evict_all(eng):
    """Allocation pressure that reclaims every cached page (spilled to
    the host tier where there is one)."""
    pc = eng.prefix_cache
    pages = pc.alloc(pc.allocator.num_free + pc.num_reclaimable)
    pc.release_pages(pages)


def _state(eng):
    pc = eng.prefix_cache
    return (pc.allocator.num_free, pc.num_cached_pages, pc.num_reclaimable,
            _events(eng.drain_kvcache_event()))


@pytest.mark.parametrize("case", ["pool", "evicted", "tier"])
def test_export_blocks_matches_jax(engines, case):
    """The pool's run (and its leading part: a run stops at the first
    block held nowhere), ``None`` once evicted with no tier, and a run
    whose tail the host tier holds (the TIER pool spilled it)."""
    pair = engines["tier" if case == "tier" else "hold"]
    prompt = _prompt({"pool": 1, "evicted": 2, "tier": 3}[case], 22)
    streams = [_run(e, prompt, f"x-{case}") for e in pair]
    assert streams[0] == streams[1]
    hashes = pair[1].prefix_cache.block_hashes(prompt)
    assert len(hashes) == 5
    if case == "evicted":
        for e in pair:
            _evict_all(e)
    if case == "tier":
        # A prompt sharing the first two blocks touches them; then a
        # longer one takes most of the pool, and reclamation (LRU) parks
        # the run's last three blocks in the tier.
        for e in pair:
            _run(e, prompt[:8] + _prompt(31, 6), "touch")
            _run(e, _prompt(30, 40), "pressure", max_tokens=2)
        parked = [[h in e.host_tier for h in hashes] for e in pair]
        assert parked[0] == parked[1] == [False, False, True, True, True]
    got = [e.export_blocks(hashes) for e in pair]
    _same_export(got[1], got[0])
    if case == "evicted":
        assert got[1] is None
    else:
        assert got[1][0] == 5
        # The leading part of a run, and a run behind a gap.
        _same_export(pair[1].export_blocks(hashes[:2]),
                     pair[0].export_blocks(hashes[:2]))
        assert pair[1].export_blocks([b"\0" * 16] + hashes) is None
    if case == "pool":
        # On the device (the wire's form): the same tensors.
        n, k, v = pair[1].export_blocks(hashes, device=True)
        assert n == 5 and torch.equal(k, got[1][1])
    assert _state(pair[1])[:3] == _state(pair[0])[:3]


REFUSALS = ["layout", "lead", "past_prompt", "no_pages"]


@pytest.mark.parametrize("case", REFUSALS)
def test_adopt_refusals_match_jax(models, engines, case):
    """Each refusal returns JAX's value and changes nothing: a block of
    another layout, a run whose lead is held nowhere, a run past the
    prompt's full blocks, and no free page."""
    jcfg, tcfg, *_ = models["dense"]
    L, H, D = tcfg.num_layers, tcfg.kv_cache_heads, tcfg.kv_cache_dim
    prompt = _prompt(40 + REFUSALS.index(case), 14)     # 3 full blocks
    n, start = {"layout": (2, 0), "lead": (2, 1), "past_prompt": (2, 2),
                "no_pages": (3, 0)}[case]
    shape = (L, n, 4, H, D) if case != "layout" else (L, n, 4, H, D + 1)
    k = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    results = []
    for eng, conv in ((engines["hold"][0], np.asarray),
                      (engines["hold"][1], torch.from_numpy)):
        eng.drain_kvcache_event()
        held = []
        if case == "no_pages":
            pc = eng.prefix_cache
            held = pc.alloc(pc.allocator.num_free + pc.num_reclaimable)
        before, fetched = _state(eng), eng.fetched_blocks
        got = eng.adopt_blocks(prompt, start, conv(k), conv(k.copy()))
        results.append((got, _state(eng) == before,
                        eng.fetched_blocks - fetched))
        eng.prefix_cache.release_pages(held)
    assert results[0] == results[1]
    assert results[1][:2] == (0, True)


def test_adopt_scatter_failure_frees_pages(models, engines):
    """A block the scatter cannot take raises out of ``adopt_blocks``
    with the pages it allocated freed and nothing registered."""
    _, tcfg, *_ = models["dense"]
    eng = engines["hold_b"]
    shape = (tcfg.num_layers, 2, 4, tcfg.kv_cache_heads,
             tcfg.kv_cache_dim)
    bad = np.empty(shape, dtype=object)
    eng.drain_kvcache_event()
    before, fetched = _state(eng), eng.fetched_blocks
    with pytest.raises(TypeError):
        eng.adopt_blocks(_prompt(45, 9), 0, bad, bad)
    assert _state(eng) == before and eng.fetched_blocks == fetched


def _adopt_and_serve(holder, target, prompt, rid):
    """The holder serves ``prompt`` cold, exports its full blocks, the
    target adopts them and serves the prompt: (holder's stream, target's
    stream, adopted, target's hit tokens)."""
    cold = _run(holder, prompt, f"{rid}-cold")
    hashes = (holder.prefix_cache.block_hashes(prompt))
    n, k, v = holder.export_blocks(hashes)
    conv = _port_t if isinstance(target, Engine) else _np
    k, v = conv(k), conv(v)
    hits0 = target.prefix_hit_tokens
    adopted = target.adopt_blocks(prompt, 0, k, v)
    warm = _run(target, prompt, f"{rid}-warm")
    return cold, warm, adopted, target.prefix_hit_tokens - hits0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port"])
def test_adopt_across_packages(engines, direction):
    """The JAX package's ``test_export_adopt_blocks_cross_engine``: the
    adopted blocks serve the prompt as a recompute does (the holder's own
    cold stream), hit as a local prefix, and a second adoption of the
    same run registers nothing twice; across packages both ways."""
    (jh, th), tb = engines["hold"], engines["hold_b"]
    holder, target = {"jax_to_port": (jh, tb), "port_to_jax": (th, jh),
                      "port_to_port": (th, tb)}[direction]
    seed = 50 + 10 * ["jax_to_port", "port_to_jax",
                      "port_to_port"].index(direction)
    prompt = _prompt(seed, 21)
    cold, warm, adopted, hits = _adopt_and_serve(holder, target, prompt,
                                                 direction)
    assert adopted == 5 and warm == cold and hits == 20
    pc = target.prefix_cache
    before = pc.num_cached_pages
    n, k, v = holder.export_blocks(pc.block_hashes(prompt)[:2])
    conv = _port_t if target is tb else _np
    assert target.adopt_blocks(prompt, 0, conv(k), conv(v)) == 2
    assert pc.num_cached_pages == before
    # A run whose lead the target holds nowhere is unreachable: refused.
    other = _prompt(seed + 1, 12)
    _run(holder, other, f"{direction}-other", max_tokens=1)
    n, k, v = holder.export_blocks(holder.prefix_cache.block_hashes(other))
    assert target.adopt_blocks(other, 1, conv(_np(k)[:, 1:]),
                               conv(_np(v)[:, 1:])) == 0
    assert pc.num_cached_pages == before


def test_adopt_behind_tier_lead_matches_jax(engines):
    """The JAX package's ``test_fetch_behind_spilled_lead_restores_whole
    _chain``: the target's leading blocks are parked in its host tier;
    it adopts the holder's tail behind them, and the admission restores
    the leads and hits the adopted tail: the whole prefix served, the
    stream a recompute's. Both packages, the same return values."""
    prompt = _prompt(70, 18)                       # 4 full blocks
    results = []
    for holder, target in ((engines["hold"][0], engines["tier"][0]),
                           (engines["hold"][1], engines["tier"][1])):
        _evict_all(target)
        cold = _run(holder, prompt, "lead-cold")
        hashes = holder.prefix_cache.block_hashes(prompt)
        conv = _np if isinstance(target, JaxEngine) else _port_t
        _, k, v = holder.export_blocks(hashes[:2])
        first = target.adopt_blocks(prompt, 0, conv(_np(k)), conv(_np(v)))
        # 15 of the 15 pages: the adopted leads are reclaimed, parked.
        _run(target, _prompt(71, 57), "lead-pressure", max_tokens=2)
        parked = [h in target.host_tier for h in hashes[:2]]
        _, k, v = holder.export_blocks(hashes)
        tail = target.adopt_blocks(prompt, 2, conv(_np(k)[:, 2:]),
                                   conv(_np(v)[:, 2:]))
        hits0 = target.prefix_hit_tokens
        warm = _run(target, prompt, "lead-warm")
        results.append((first, parked, tail, warm == cold,
                        target.prefix_hit_tokens - hits0))
    assert results[0] == results[1]
    assert results[1] == (2, [True, True], 2, True, 16)


def test_mla_adoption_across_packages(models):
    """Tiny DeepSeek (MLA): both pools carry the latent rows; the JAX
    engine's export adopted by the port serves the prompt as the port's
    own recompute does, and the port's export equals JAX's."""
    jcfg, tcfg, jparams, tparams = models["mla"]
    jeng = JaxEngine(jcfg, JaxEngineConfig(**HOLD), params=jparams)
    teng = Engine(tcfg, EngineConfig(**HOLD), params=tparams, device="cpu")
    target = Engine(tcfg, EngineConfig(**HOLD), params=tparams,
                    device="cpu")
    prompt = _prompt(80, 13)                       # 3 full blocks
    jcold, tcold = _run(jeng, prompt, "m"), _run(teng, prompt, "m")
    assert jcold == tcold
    hashes = teng.prefix_cache.block_hashes(prompt)
    jexp, texp = jeng.export_blocks(hashes), teng.export_blocks(hashes)
    _same_export(texp, jexp)
    assert target.adopt_blocks(prompt, 0, _port_t(jexp[1]),
                               _port_t(jexp[2])) == 3
    assert _run(target, prompt, "m-warm") == tcold
    assert target.prefix_hit_tokens == 12


# ---------------------------------------------------------------------------
# (c) workers behind the JAX master: F4, both ways
# ---------------------------------------------------------------------------

# The planner's price of a fetch far below a recompute's, so that every
# surplus run is planned as a fetch (read once, when the master starts).
FETCH_ENV = {"XLLM_KV_FETCH_GBPS": "1000", "XLLM_KV_FETCH_OVERHEAD_MS": "0"}


@pytest.fixture(scope="module")
def wmodels():
    """The tiny float32 model of tests/test_torch_cluster.py (vocab 512,
    the byte tokenizer's range), the JAX worker's registry pointed at
    it."""
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


def _cluster():
    mp = pytest.MonkeyPatch()
    for k, v in FETCH_ENV.items():
        mp.setenv(k, v)
    try:
        return Cluster()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def mixed(wmodels):
    """A port worker (profiling on) and a JAX worker behind the master."""
    c = _cluster()
    p = c.add_torch_worker(wmodels, enable_profiling=True)
    j = c.add_jax_worker()
    yield c, p, j
    c.close()


@pytest.fixture(scope="module")
def ports(wmodels):
    c = _cluster()
    a, b = c.add_torch_worker(wmodels), c.add_torch_worker(wmodels)
    yield c, a, b
    c.close()


def _complete(addr, token_ids):
    """(text, chosen-token logprobs) of a greedy completion."""
    status, resp = http_json("POST", addr, "/v1/completions", {
        "model": MODEL, "prompt": "x", "token_ids": list(token_ids),
        "max_tokens": 6, "temperature": 0.0, "ignore_eos": True,
        "logprobs": 1}, timeout=120.0)
    assert status == 200, resp
    ch = resp["choices"][0]
    return ch["text"], ch["logprobs"]["token_logprobs"]


def _same(got, want):
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)


def _fetch_counts(w):
    return (w.kv_fetch_attempts, w.kv_fetch_failures, w.kv_fetch_bytes)


def _verdicts(c):
    """The master's count of ``fetch`` verdicts."""
    text = _get_text(c.master.http_address, "/metrics")
    m = re.search(r'xllm_kv_fetch_decisions_total\{verdict="fetch"\} (\S+)',
                  text)
    return float(m.group(1)) if m else 0.0


def _get_text(addr, path):
    import http.client
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def _shared_round(c, holder, target, seed):
    """The holder serves a 4-block prompt (+ a 3-token tail) straight;
    once the master's index lists its blocks, the same prompt goes
    through the master until the round robin lands it on the target.
    Returns (the holder's cold answer, the target's, the target's
    counters before)."""
    prompt = np.random.default_rng(seed).integers(3, 256, size=67).tolist()
    cold = _complete(holder.name, prompt)
    kvm = c.master.scheduler.kvcache_mgr
    assert wait_until(lambda: len(kvm.match_prefix_tiers(prompt)[2].get(
        holder.name, ())) >= 4), "the master never indexed the holder"
    before = _fetch_counts(target)
    for _ in range(3):
        warm = _complete(c.master.http_address, prompt)
        _same(warm, cold)
        if target.kv_fetch_attempts > before[0]:
            return cold, warm, before
    raise AssertionError("the round robin never reached the target")


@pytest.mark.parametrize("pair", ["port_to_jax", "jax_to_port",
                                  "jax_to_port_wire", "port_to_port",
                                  "port_to_port_wire"])
def test_f4_fetch_through_master(mixed, ports, monkeypatch, pair):
    """F4 closed: a planned fetch from a port holder is served (a JAX
    target adopts it: one attempt, no failure, bytes, the text of a
    recompute), and so are a JAX holder's to a port target and a port
    holder's to a port target. ``*_wire``: the target offers the CUDA
    IPC wire (a fake on the CPU). A JAX holder answers with a PJRT
    ticket, which the port requester acknowledges ``nopull`` before it
    asks again for the bytes (and offers that holder no wire again); a
    port holder stages a ticket that is pulled and acknowledged."""
    c, p, j = mixed if "jax" in pair else ports
    holder, target = {"port_to_jax": (p, j), "jax_to_port": (j, p),
                      "jax_to_port_wire": (j, p),
                      "port_to_port": (p, j),
                      "port_to_port_wire": (p, j)}[pair]
    wire = None
    if pair.endswith("_wire"):
        from tests.test_torch_pd import FakeWire
        wire = FakeWire()
        monkeypatch.setattr(kv_wire, "get_device_wire", lambda: wire)
        monkeypatch.setattr(torch_worker, "_LOCAL_WORKERS", {})
        monkeypatch.setattr(target, "_fetch_wire_refused", set())
        if pair == "port_to_port_wire":
            monkeypatch.setattr(kv_wire, "pull_block",
                                lambda tr: FakeWire.staged[tr["uuid"]])
    seed = 100 + ["port_to_jax", "jax_to_port", "jax_to_port_wire",
                  "port_to_port", "port_to_port_wire"].index(pair)
    verdicts = _verdicts(c)
    fetched = (target.primary_runtime().engine
               if hasattr(target, "primary_runtime")
               else target.engine).fetched_blocks
    via_wire = getattr(target, "kv_fetch_device_wire", 0)
    cold, warm, before = _shared_round(c, holder, target, seed)
    after = _fetch_counts(target)
    assert after[0] == before[0] + 1 and after[1] == before[1]
    assert after[2] > before[2]
    eng = (target.primary_runtime().engine
           if hasattr(target, "primary_runtime") else target.engine)
    assert eng.fetched_blocks == fetched + 4
    assert _verdicts(c) > verdicts
    if pair == "jax_to_port_wire":
        assert j.name in p._fetch_wire_refused
        assert p.kv_fetch_device_wire == via_wire
        assert not j._kv_fetch_staged
    if pair == "port_to_port_wire":
        assert target.kv_fetch_device_wire == via_wire + 1
        assert not holder._kv_fetch_staged and wire.staged_count() == 0
    if holder is p or holder in ports[1:]:
        assert holder.kv_blocks_served >= 1


@pytest.mark.parametrize("how", ["failpoint", "evicted"])
def test_fetch_fallbacks_recompute(mixed, monkeypatch, how):
    """``worker.fail_kv_fetch`` armed on a port target (a JAX holder),
    and a port holder that evicted the run between the plan and the ask
    (its 404 counted by a JAX target): each falls back to recompute,
    counted, and the text is unchanged."""
    c, p, j = mixed
    holder, target = (j, p) if how == "failpoint" else (p, j)
    if how == "failpoint":
        p.failpoints.arm("worker.fail_kv_fetch", mode="always")
    else:
        export = p.engine.export_blocks

        def evicting(hashes, device=False):
            _evict_all(p.engine)
            return export(hashes, device=device)
        monkeypatch.setattr(p.engine, "export_blocks", evicting)
    try:
        cold, warm, before = _shared_round(
            c, holder, target, 200 + (how == "evicted"))
    finally:
        p.failpoints.arm("worker.fail_kv_fetch", mode="off")
    after = _fetch_counts(target)
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    assert after[2] == before[2]
    if how == "failpoint":
        assert 'xllm_failpoints_tripped_total{name="worker.fail_kv_fetch"}' \
            in _get_text(p.name, "/metrics")


def _post_raw(addr, path, data):
    import http.client
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", path, body=data,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read()
        return r.status, (json.loads(body) if r.status == 200 else None)
    finally:
        conn.close()


BAD_ASKS = {
    "other_model": ("/kv/blocks", {"model": "other", "hashes": ["00" * 16]}),
    "bad_json": ("/kv/blocks", b"{not json"),
    "bad_hex": ("/kv/blocks", {"model": MODEL, "hashes": ["zz"]}),
    "no_hashes": ("/kv/blocks", {"model": MODEL, "hashes": []}),
    "not_held": ("/kv/blocks", {"model": MODEL, "hashes": ["ab" * 16]}),
    "done_unknown": ("/kv/blocks_done", {"uuid": 12345,
                                         "outcome": "pulled"}),
    "done_no_uuid": ("/kv/blocks_done", {"outcome": "pulled"}),
}


@pytest.mark.parametrize("case", sorted(BAD_ASKS))
def test_holder_answers_match_jax(mixed, case):
    """Strict model resolution, bad JSON, bad hex, no hashes, a run no
    longer held, and ``/kv/blocks_done`` for an unknown uuid or none:
    the port holder's status (and 200 body) equal the JAX holder's."""
    _, p, j = mixed
    path, body = BAD_ASKS[case]
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    got = [_post_raw(w.name, path, data) for w in (j, p)]
    assert got[1] == got[0]
    assert got[1][0] == (200 if case == "done_unknown" else
                         404 if case in ("other_model", "not_held") else 400)


def test_staged_ticket_ttl_sweep(mixed, wmodels, monkeypatch):
    """Tickets no requester acknowledged within 60 s are released as
    leaked: by the heartbeat loop, and, on a worker without a store
    (no heartbeat loop), at each ``/kv/blocks``."""
    from tests.test_torch_pd import FakeWire
    from tests.test_torch_cluster import ENGINE
    _, p, _ = mixed
    wire = FakeWire()
    released = []
    monkeypatch.setattr(wire, "release",
                        lambda uuid, leaked=False:
                        released.append((uuid, leaked)))
    old = time.monotonic() - 61.0
    with p._kv_fetch_mu:
        p._kv_fetch_staged.update({7: (old, wire),
                                   8: (time.monotonic(), wire)})
    assert wait_until(lambda: 7 not in p._kv_fetch_staged)
    assert released == [(7, True)] and 8 in p._kv_fetch_staged
    with p._kv_fetch_mu:
        p._kv_fetch_staged.pop(8)
    _, tcfg, jparams = wmodels
    alone = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
    try:
        assert alone.store is None
        with alone._kv_fetch_mu:
            alone._kv_fetch_staged[9] = (old, wire)
        status, _ = http_json("POST", alone.name, "/kv/blocks",
                              {"model": MODEL, "hashes": ["cd" * 16]})
        assert status == 404
        assert released == [(7, True), (9, True)]
        assert not alone._kv_fetch_staged
    finally:
        alone.stop()


def test_kv_gbps_on_the_beat(mixed):
    """The beat carries the PD migrations' rate (0.0 before any), as the
    JAX worker's, and the master's books follow."""
    c, p, _ = mixed
    mgr = c.master.scheduler.instance_mgr
    assert p._build_heartbeat()[0].latency.kv_gbps == 0.0
    p.kv_migration_bytes, p.kv_migration_seconds = 6_000_000_000, 2.0
    try:
        assert p._build_heartbeat()[0].latency.kv_gbps == 3.0
        assert wait_until(lambda: mgr.get(p.name).latency.kv_gbps == 3.0)
    finally:
        p.kv_migration_bytes, p.kv_migration_seconds = 0, 0.0
    assert wait_until(lambda: mgr.get(p.name).latency.kv_gbps == 0.0)


def test_metrics_carry_the_jax_series(mixed):
    """The fetch counters under the JAX worker's names and help texts,
    through the JAX package's exposition validator."""
    _, p, j = mixed
    mine, ref = _get_text(p.name, "/metrics"), _get_text(j.name, "/metrics")
    assert validate_exposition(mine) == []
    for name in ("xllm_worker_kv_fetch_attempts_total",
                 "xllm_worker_kv_fetch_failures_total",
                 "xllm_worker_kv_fetch_bytes_total",
                 "xllm_worker_prefix_cache_fetched_blocks_total"):
        help_line = f"# HELP {name} "
        want = [x for x in ref.splitlines() if x.startswith(help_line)]
        assert want and [x for x in mine.splitlines()
                         if x.startswith(help_line)] == want


# ---------------------------------------------------------------------------
# (d) profiling samples in the registration
# ---------------------------------------------------------------------------

class _FakeEngine:
    """Records what ``profile_engine`` asks of an engine: admitted at the
    next step, each request finishes after its ``max_tokens`` steps."""

    def __init__(self, buckets, batch):
        self.ecfg = dataclasses.make_dataclass(
            "E", ["prefill_buckets", "max_batch_size"])(buckets, batch)
        self.waiting, self.running, self.log = [], [], []

    def add_request(self, req):
        sp = req.sampling
        self.log.append((req.request_id, list(req.token_ids), sp.max_tokens,
                         sp.ignore_eos, sp.temperature))
        self.waiting.append([req.sampling.max_tokens])

    def has_work(self):
        return bool(self.waiting or self.running)

    def step(self):
        self.running += self.waiting
        self.waiting = []
        for r in self.running:
            r[0] -= 1
        self.running = [r for r in self.running if r[0] > 0]
        return []


@pytest.mark.parametrize("buckets,batch", [((32, 64, 128), 4),
                                           ((16, 64), 2)])
def test_profile_engine_matches_jax(buckets, batch):
    """The port's ``profile_engine`` asks an engine what the JAX one does
    (request ids, prompts, sampling, in order) and returns samples at
    the same prompt lengths and (batch, length) pairs."""
    got, want = _FakeEngine(buckets, batch), _FakeEngine(buckets, batch)
    mine, ref = ttp.profile_engine(got), jtp.profile_engine(want)
    assert got.log == want.log
    assert [s[0] for s in mine[0]] == [s[0] for s in ref[0]]
    assert [s[:2] for s in mine[1]] == [s[:2] for s in ref[1]]


def test_registration_carries_profiling(mixed):
    """``enable_profiling``: the registration carries the samples at the
    JAX worker's lengths (32, 64, 128) and batches (1, 2, 4; 40 tokens),
    and the master's ``TimePredictor`` for the port instance predicts a
    positive TTFT and TPOT."""
    c, p, _ = mixed
    inst = c.master.scheduler.instance_mgr.get(p.name)
    ttft = [tuple(s) for s in inst.meta.ttft_profiling_data]
    tpot = [tuple(s) for s in inst.meta.tpot_profiling_data]
    assert [s[0] for s in ttft] == [32.0, 64.0, 128.0]
    assert [s[:2] for s in tpot] == [(1.0, 40.0), (2.0, 40.0), (4.0, 40.0)]
    assert all(s[-1] > 0 for s in ttft + tpot)
    assert inst.predictor.has_ttft and inst.predictor.has_tpot
    assert inst.predictor.predict_ttft(100) > 0.0
    assert inst.predictor.predict_tpot(80, 2) > 0.0
