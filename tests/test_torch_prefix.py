"""The port's prefix cache, offline preemption and host spill tier,
against the JAX package, on the CPU with tiny float32 models and the
same weights.

Held to the JAX package: the chained block digests (both of the port's
paths), the index's and the tier's pages and drained events over the
same operation sequences, the KV block codec's bytes (float32 and
bfloat16, the latter without ``ml_dtypes``), and whole engines with
``enable_prefix_cache=True`` on both sides on a plan of prompts that
share leading pages under a tight pool: token streams, the per-step
ledger, ``num_preemptions``, ``prefix_cache_stats()``,
``load_metrics()`` and the drained ``KvCacheEvent`` after every step,
in the split, ragged and prefill-first steps, in both write orders,
with fused bursts, at dense and MLA shapes, with offline requests, and
with the spill tier (including a restore that fails and is undone).
"""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime import kv_cache as jkv
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils import hashing as jhash
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import kv_cache as tkv
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils import hashing as thash
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

VOCAB = 128
# 10 usable pages of 4 tokens for up to 4 sequences of 14-30 tokens:
# decode growth runs the pool dry (preemptions), and released cached
# pages are reclaimed.
TIGHT = dict(page_size=4, num_pages=11, max_model_len=128,
             max_batch_size=4, max_prefill_tokens=32,
             prefill_buckets=(8, 16, 32))
# A 12-token shared prefix (3 full pages) and distinct tails:
# {step: [(request, tail length, max_tokens, offline), ...]}; a tail of
# None repeats the first request's whole prompt.
PLAN = {1: [("a", 5, 10, False)],
        3: [("b", 7, 8, False), ("c", 2, 12, False)],
        5: [("d", None, 6, False)],
        6: [("e", 9, 8, False)]}
OFFLINE_PLAN = {1: [("a", 5, 12, True), ("b", 9, 10, True)],
                2: [("c", 3, 10, False)],
                3: [("d", 6, 12, True), ("e", 2, 9, False)]}


def _feed(plan, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, VOCAB, size=12).tolist()
    first = None
    feed = {}
    for step, reqs in sorted(plan.items()):
        for rid, tail, max_tokens, offline in reqs:
            if tail is None:
                toks = list(first)
            else:
                toks = prefix + rng.integers(3, VOCAB, size=tail).tolist()
            first = first or toks
            feed.setdefault(step, []).append((rid, toks, max_tokens,
                                              offline))
    return feed


def _events(ev):
    return (tuple(ev.stored), tuple(ev.removed), tuple(ev.offloaded),
            tuple(ev.offloaded_ssd))


def _drive(engine, feed, request, sampling):
    """Run to idle; per step the ledger, the load, the cache stats and
    the drained cache event."""
    streams, steps, step = {}, [], 0
    while engine.has_work() or step < max(feed):
        step += 1
        for rid, toks, max_tokens, offline in feed.get(step, []):
            engine.add_request(request(
                rid, toks, sampling(max_tokens=max_tokens, temperature=0.0,
                                    ignore_eos=True), offline=offline))
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        steps.append(((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches),
                      engine.load_metrics(), engine.prefix_cache_stats(),
                      _events(engine.drain_kvcache_event())))
        assert step < 400, "engine did not drain"
    return streams, steps


MLA = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
           moe_intermediate_size=48, num_layers=3, num_heads=4,
           num_kv_heads=4, head_dim=8, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, num_experts=4,
           num_experts_per_tok=2, n_shared_experts=1,
           first_k_dense_replace=1, routed_scaling_factor=1.5,
           norm_topk_prob=False, max_position_embeddings=512,
           rope_theta=10000.0, dtype="float32", name="tiny-v2-lite",
           rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True, 0.707),
           mla_yarn_mscale=True)


def _model(kind):
    if kind == "mla":
        jcfg, tcfg = JaxModelConfig(**MLA), ModelConfig(**MLA)
    else:
        jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                                   dtype="float32")
        tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB),
                                   dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    return {kind: _model(kind) for kind in ("dense", "mla")}


def _pair(models, kind, **kw):
    jcfg, tcfg, jparams, tparams = models[kind]
    cfg = {**TIGHT, "enable_prefix_cache": True, "decode_steps": 1, **kw}
    return (JaxEngine(jcfg, JaxEngineConfig(**cfg), params=jparams),
            Engine(tcfg, EngineConfig(**cfg), params=tparams, device="cpu"))


def _assert_same_run(jeng, teng, plan):
    jst, jsteps = _drive(jeng, _feed(plan), JaxRequest, JaxSampling)
    tst, tsteps = _drive(teng, _feed(plan), EngineRequest, SamplingParams)
    assert tst == jst
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {i + 1}"
    assert len(tsteps) == len(jsteps)
    assert teng.num_preemptions == jeng.num_preemptions
    return tst, tsteps


# ---------------------------------------------------------------------------
# (a) digests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 33 + 5])
@pytest.mark.parametrize("block", [1, 4, 16, 128])
def test_block_digests_equal_jax(seed, block):
    rng = np.random.default_rng(seed % 1000)
    for n in (0, block - 1, block, 3 * block + 1, 300):
        toks = rng.integers(0, 2 ** 17, size=n).tolist()
        toks[:1] = [-5] if toks else []          # a negative id wraps
        want = jhash.prefix_block_hashes(toks, block, seed)
        assert thash.prefix_block_hashes(toks, block, seed) == want
        assert thash.prefix_block_hashes_py(toks, block, seed) == want
        assert len(want) == n // block


def test_native_helper_equals_pure_path():
    """The native helper, where it builds here, gives the pure path's
    bytes; without a compiler the pure path serves alone."""
    toks = list(range(1000, 1137)) + [2 ** 31 + 3, -1]
    if not thash.native_available():
        pytest.skip("no C++ compiler for csrc/xllm_native.cpp here")
    for bs, seed in ((16, 0), (32, 7), (128, 12345)):
        assert thash.prefix_block_hashes(toks, bs, seed) == \
            thash.prefix_block_hashes_py(toks, bs, seed)


# ---------------------------------------------------------------------------
# (b) the index and the tier, operation by operation
# ---------------------------------------------------------------------------

def _case_evict_while_acquired(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(4), page_size=4)
    tokens = list(range(8))
    pages = idx.alloc(2)
    idx.register_full_pages(tokens, pages)
    idx.release_pages(pages)
    hit = idx.match_prefix(tokens + [99, 98])
    trace = [pages, hit, idx.alloc(3), idx.page_of(idx.block_hashes(
        tokens)[0]), idx.match_prefix(tokens + [99, 98])]
    idx.release_pages(hit[0])
    idx.release_pages(hit[0])
    trace += [idx.num_reclaimable, idx.allocator.num_free,
              _events(idx.drain_event())]
    return trace


def _case_reregister_evicted(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(8), page_size=4, seed=3)
    tokens = list(range(8))
    trace = []
    for _ in range(2):
        pages = idx.alloc(2)
        idx.register_full_pages(tokens, pages)
        idx.release_pages(pages)
        trace.append(pages)
        pressure = idx.alloc(7)                 # reclaims every mapping
        trace += [pressure, idx.num_cached_pages, _events(idx.drain_event())]
        idx.release_pages(pressure)
    pages = idx.alloc(2)
    idx.register_full_pages(tokens, pages)
    idx.release_pages(pages)
    hit = idx.match_prefix(tokens + [1, 2, 3])
    trace += [hit, _events(idx.drain_event())]
    return trace


def _case_whole_prompt_hit(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(8), page_size=4)
    tokens = list(range(12))
    pages = idx.alloc(3)
    idx.register_full_pages(tokens, pages)
    idx.release_pages(pages)
    a = idx.match_prefix(tokens)
    b = idx.match_prefix(tokens + [77])
    # A NULL (trimmed) leading page registers nothing.
    idx.register_full_pages(list(range(50, 58)), [0, b[0][0]])
    return [a, b, idx.num_reclaimable, _events(idx.drain_event())]


def _case_lru_order_and_spill_hook(kv):
    idx = kv.PrefixCacheIndex(kv.PageAllocator(6), page_size=2)
    spilled = []
    idx.spill_hook = lambda h, pid: spilled.append((h, pid)) or pid % 2 == 0
    for base in (0, 10, 20):
        pages = idx.alloc(1)
        idx.register_full_pages([base, base + 1], pages)
        idx.release_pages(pages)
    got = idx.match_prefix([10, 11, 5])         # touch: no longer LRU
    idx.release_pages(got[0])
    new = idx.alloc(4)
    return [got, new, spilled, idx.num_reclaimable,
            _events(idx.drain_event())]


def _blk(kv, fill, shape=(2, 4, 2, 2)):
    if kv is tkv:
        k = torch.full(shape, fill, dtype=torch.float32)
        return k, k + 1.0
    k = np.full(shape, fill, np.float32)
    return k, k + 1.0


def _np(blk):
    return None if blk is None else [np.asarray(x).tolist() for x in blk]


def _case_tier_round_trip(kv, tmp_path):
    tier = kv.HostKvTier(capacity_bytes=1 << 20)
    trace = [tier.put(b"h1", *_blk(kv, 3.0)), _np(tier.peek(b"h1"))]
    tier.pop(b"h1")
    trace += [_np(tier.peek(b"h1")), tier.spilled_blocks,
              tier.restored_blocks, b"h1" in tier]
    big = kv.HostKvTier(capacity_bytes=8)
    trace.append(big.put(b"big" * 6, *_blk(kv, 1.0)))
    return trace


def _case_tier_lru_budget(kv, tmp_path):
    k, v = _blk(kv, 0.0)
    tier = kv.HostKvTier(capacity_bytes=2 * (k.nbytes + v.nbytes))
    trace = [tier.put(bytes([i]) * 16, *_blk(kv, float(i)))
             for i in range(3)]
    trace += [tier.num_blocks, _np(tier.peek(b"\x00" * 16)),
              tier.put(b"\x01" * 16, *_blk(kv, 9.0)), tier.bytes_used,
              _events(tier.drain_event())]
    return trace


def _case_tier_disk_demotion(kv, tmp_path):
    k, v = _blk(kv, 7.0)
    one = k.nbytes + v.nbytes
    tier = kv.HostKvTier(capacity_bytes=one,
                         disk_dir=str(tmp_path / kv.__name__),
                         disk_capacity_bytes=2 * one)
    trace = [tier.put(bytes([65 + i]) * 16, *_blk(kv, 7.0 + i))
             for i in range(4)]
    trace += [_events(tier.drain_event()), _np(tier.peek(b"B" * 16)),
              _np(tier.peek(b"A" * 16))]
    tier.pop(b"B" * 16)
    trace += [_np(tier.peek(b"B" * 16)), tier.num_blocks,
              tier.restored_blocks]
    return trace


@pytest.mark.parametrize("case", [
    _case_evict_while_acquired, _case_reregister_evicted,
    _case_whole_prompt_hit, _case_lru_order_and_spill_hook],
    ids=lambda f: f.__name__[6:])
def test_index_operations_equal_jax(case):
    assert case(tkv) == case(jkv)


@pytest.mark.parametrize("case", [
    _case_tier_round_trip, _case_tier_lru_budget, _case_tier_disk_demotion],
    ids=lambda f: f.__name__[6:])
def test_tier_operations_equal_jax(case, tmp_path):
    assert case(tkv, tmp_path) == case(jkv, tmp_path)


# ---------------------------------------------------------------------------
# (c) the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bytes_equal_jax(dtype):
    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 4, 2, 5)).astype(np.float32)
    v = rng.standard_normal((3, 4, 2, 5)).astype(np.float32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "bfloat16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
        # The same values on the JAX side, through ml_dtypes.
        k = tk.float().numpy().astype(ml_dtypes.bfloat16)
        v = tv.float().numpy().astype(ml_dtypes.bfloat16)
    want = jkv.encode_kv_block(k, v, {"layer": 2})
    got = tkv.encode_kv_block(tk, tv, {"layer": 2})
    assert got == want
    nl = got.index(b"\n")
    meta = json.loads(got[:nl])
    assert meta["dtype"] == dtype
    dk, dv = tkv.decode_kv_blob(meta, got[nl + 1:])
    assert dk.dtype == tk.dtype and torch.equal(dk, tk)
    assert torch.equal(dv, tv)
    with pytest.raises(ValueError):
        tkv.decode_kv_blob(meta, got[nl + 2:])


# ---------------------------------------------------------------------------
# (d)-(f) engines against the JAX engine, the prefix cache on
# ---------------------------------------------------------------------------

MODES = {"split": dict(),
         "ragged": dict(ragged_attn=True, write_then_attend=True),
         "prefill_first": dict(interleave=False)}


# (mode, write order, decode steps); the ragged step always writes first.
COMBOS = [(mode, order, steps) for mode in sorted(MODES)
          for order in (True, False) for steps in (1, 4)
          if order or mode != "ragged"]


@pytest.mark.parametrize(
    "mode,order,steps", COMBOS,
    ids=[f"{m}-{'wta' if o else 'atw'}-{'burst' if n > 1 else 'single'}"
         for m, o, n in COMBOS])
def test_shared_prefix_engine_matches_jax(models, mode, order, steps):
    kw = dict(MODES[mode], decode_steps=steps)
    kw.setdefault("write_then_attend", order)
    jeng, teng = _pair(models, "dense", **kw)
    tst, tsteps = _assert_same_run(jeng, teng, PLAN)
    stats = tsteps[-1][2]
    assert stats["hit_tokens_total"] >= 3 * 12
    assert stats["lookups_total"] >= len(tst)
    assert any(ev[1] for *_, ev in tsteps), "no page was reclaimed"
    assert teng.num_preemptions > 0
    if mode == "ragged":
        assert any(led[1] for led, *_ in tsteps), "no ragged step ran"


@pytest.mark.parametrize("order", [True, False],
                         ids=["write_then_attend", "attend_then_write"])
@pytest.mark.parametrize("mode", ["split", "prefill_first"])
def test_shared_prefix_mla_engine_matches_jax(models, mode, order):
    jeng, teng = _pair(models, "mla", write_then_attend=order,
                       **MODES[mode])
    _, tsteps = _assert_same_run(jeng, teng, PLAN)
    assert tsteps[-1][2]["hit_tokens_total"] >= 3 * 12


@pytest.mark.parametrize("steps", [1, 4], ids=["single", "burst"])
@pytest.mark.parametrize("mode", ["split", "ragged"])
def test_offline_online_mix_matches_jax(models, mode, steps):
    """Online requests queue first and preempt offline ones (latest
    arrival first) when the pool runs out."""
    jeng, teng = _pair(models, "dense", decode_steps=steps, **MODES[mode])
    tst, _ = _assert_same_run(jeng, teng, OFFLINE_PLAN)
    assert teng.num_preemptions > 0
    assert sorted(tst) == ["a", "b", "c", "d", "e"]


def test_waiting_order_online_before_offline(models):
    _, teng = _pair(models, "dense")
    for i, offline in enumerate((True, False, True, False)):
        teng.add_request(EngineRequest(
            f"r{i}", [3, 4, 5], SamplingParams(max_tokens=2),
            offline=offline, arrival_time=1.0 + i))
    assert [s.req.request_id for s in teng.waiting] == \
        ["r1", "r3", "r0", "r2"]


# ---------------------------------------------------------------------------
# (g) spill and restore
# ---------------------------------------------------------------------------

def _spill_pair(models, kind="dense", **kw):
    cfg = dict(page_size=16, num_pages=16, max_model_len=256,
               max_batch_size=2, max_prefill_tokens=256,
               prefill_buckets=(32, 64, 128), **{"kv_spill_mb": 64.0, **kw})
    jcfg, tcfg, jparams, tparams = models[kind]
    return (JaxEngine(jcfg, JaxEngineConfig(**cfg), params=jparams),
            Engine(tcfg, EngineConfig(**cfg), params=tparams, device="cpu"))


def _run(eng, prompt, rid, request, sampling, max_tokens=8):
    eng.add_request(request(rid, list(prompt), sampling(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True)))
    toks = []
    while eng.has_work():
        for o in eng.step():
            if o.request_id == rid:
                toks.extend(o.new_token_ids)
    return toks


P1 = [7] * 5 + list(range(40))
FILLER = list(range(30, 128)) + list(range(3, 128))[:132]


def _spill_script(eng, request, sampling):
    out = [_run(eng, P1, "a", request, sampling)]
    out.append(_events(eng.drain_kvcache_event()))
    out.append(_run(eng, FILLER, "b", request, sampling))
    out += [eng.prefix_cache_stats(), _events(eng.drain_kvcache_event())]
    out.append(_run(eng, P1, "c", request, sampling))
    out += [eng.prefix_cache_stats(), _events(eng.drain_kvcache_event()),
            eng.load_metrics()]
    return out


@pytest.mark.parametrize("kind", ["dense", "mla"])
def test_spill_restore_round_trip_matches_jax(models, kind):
    jeng, teng = _spill_pair(models, kind)
    want = _spill_script(jeng, JaxRequest, JaxSampling)
    got = _spill_script(teng, EngineRequest, SamplingParams)
    assert got == want
    assert got[3]["spilled_pages"] > 0 and got[6]["restored_pages"] > 0
    assert got[4][2] and not got[4][1]           # offloaded, not removed
    assert got[5] == got[0]                      # the cold stream again


def test_restored_pages_are_the_spilled_bytes(models):
    """A restore writes back exactly the bytes the tier took: the
    restored pool pages equal the blocks read at spill."""
    _, teng = _spill_pair(models)
    _run(teng, P1, "a", EngineRequest, SamplingParams)
    hashes = teng.prefix_cache.block_hashes(P1)
    before = {h: tkv.pool_gather(teng.kv, teng.prefix_cache.page_of(h))
              for h in hashes}
    _run(teng, FILLER, "b", EngineRequest, SamplingParams)
    parked = [h for h in hashes if h in teng.host_tier]
    assert parked
    for h in parked:
        assert all(torch.equal(a, b) for a, b in
                   zip(teng.host_tier.peek(h), before[h]))
    pages, cached = teng.prefix_cache.match_prefix(P1)
    pages, cached = teng._restore_spilled(P1, pages, cached)
    assert cached == 2 * 16
    for h, pid in zip(hashes, pages):
        assert all(torch.equal(a, b) for a, b in
                   zip(tkv.pool_gather(teng.kv, pid), before[h]))
    teng.prefix_cache.release_pages(pages)


def test_failed_restore_releases_pins_pages_and_reparks_tier(
        models, monkeypatch):
    """A restore whose copy raises unpins the chain's registered pages,
    sends the fresh pages back, and puts the tier's blocks back; the
    prefix then restores and serves the cold stream once the fault
    clears."""
    _, teng = _spill_pair(models)
    out1 = _run(teng, P1, "a", EngineRequest, SamplingParams)
    _run(teng, FILLER, "b", EngineRequest, SamplingParams)
    assert teng.prefix_cache_stats()["spilled_pages"] > 0
    idx = teng.prefix_cache

    def accounted():
        return (idx.allocator.num_free + len(idx._ref)
                + len(idx._reclaimable))

    free_before, refs_before = idx.allocator.num_free, dict(idx._ref)
    total_before = accounted()
    tier_before = [h for h in idx.block_hashes(P1) if h in teng.host_tier]
    assert tier_before

    def exploding(*a, **kw):
        raise RuntimeError("injected scatter failure")

    real = teng.kv_plane.scatter
    monkeypatch.setattr(teng.kv_plane, "scatter", exploding)
    with pytest.raises(RuntimeError, match="injected scatter"):
        teng._restore_spilled(P1, [], 0)
    assert accounted() == total_before
    assert idx.allocator.num_free >= free_before
    assert dict(idx._ref) == refs_before
    assert all(h in teng.host_tier for h in tier_before)
    monkeypatch.setattr(teng.kv_plane, "scatter", real)
    assert _run(teng, P1, "c", EngineRequest, SamplingParams) == out1
    assert teng.prefix_cache_stats()["restored_pages"] > 0


def test_spill_off_matches_jax(models):
    """Without the tier (the default) a reclaimed page's digest is
    reported removed, as the JAX engine reports it."""
    assert EngineConfig().kv_spill_mb == 0.0
    jeng, teng = _spill_pair(models, kv_spill_mb=0.0)
    assert teng.host_tier is None
    want = _spill_script(jeng, JaxRequest, JaxSampling)
    got = _spill_script(teng, EngineRequest, SamplingParams)
    assert got == want
    assert got[4][1] and not got[4][2]           # removed, not offloaded


def test_spill_env_overrides(monkeypatch, tmp_path):
    monkeypatch.setenv("XLLM_KV_SPILL_MB", "12.5")
    monkeypatch.setenv("XLLM_KV_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("XLLM_KV_SPILL_DISK_MB", "3")
    cfg = EngineConfig()
    jcfg = JaxEngineConfig()
    assert (cfg.kv_spill_mb, cfg.kv_spill_dir, cfg.kv_spill_disk_mb) == \
        (jcfg.kv_spill_mb, jcfg.kv_spill_dir, jcfg.kv_spill_disk_mb) == \
        (12.5, str(tmp_path), 3.0)
