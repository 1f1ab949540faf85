"""K6 (the all-layer decode KV write) folded into the last layer's fused
writer, on the CPU.

In the attend-then-write decode step each layer's pool-less fused
writer puts its rotated k and v (MLA: the latent row) in its slot of a
staging buffer, and the last layer's writer, in its all-layer mode
(``rope_kv_update_all_layers``, ``latent_kv_update_all_layers``), also
writes every layer's staged rows into the pools, which is K6's work.
Pinned here:

- the all-layer mode's plain version is bit for bit the unfused chain
  it replaces (the pool-less writer, ``torch.stack`` of every layer's
  rows, ``paged_kv_update_plain``) and the JAX package's all-layer
  writer, dense and latent, with inactive rows, NULL pages and
  positions past the table;
- writing before the last layer attends is safe: with NaN at every
  slot the fold writes, the current-token attention of K3' and K3''
  (their split arithmetic, which reads only the attended keys) gives
  the same bits, at every split count;
- temperature-0 streams, step ledgers and preemption counts equal the
  JAX engine's on a tight pool under ``XLLM_WRITE_THEN_ATTEND=0`` (and
  ``=1``), for ``ModelConfig.tiny`` and the tiny DeepSeek-V2-Lite
  shapes; in attend-then-write every decode forward takes the all-layer
  mode once, and no forward reaches K6 or ``torch.stack``."""

import dataclasses
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import kernels, rope
from xllm_service_tpu_torch.ops.kernels import kv_update as kv
from xllm_service_tpu_torch.ops.kernels import paged_attention as pa
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launch_counts().values())


def _rows(seed, L, Hkv, D, dtype, B=5, P=24, ps=4, MP=4):
    """Pools [L, P, ps, Hkv, D], staging [L, B, Hkv, D] (random: the
    earlier layers' rows), a page table with a NULL page under row 1's
    position, row 2 inactive, row 4's position past the table."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g).to(dtype)
    pt = (1 + torch.randperm(P - 1, generator=g)[:B * MP]).reshape(B, MP)
    pt = pt.to(torch.int32)
    positions = torch.tensor([0, 6, 9, 13, 17], dtype=torch.int32)
    pt[1, 1] = 0
    active = torch.tensor([True, True, False, True, True])
    return dict(kp=rn(L, P, ps, Hkv, D), vp=rn(L, P, ps, Hkv, D),
                k_stage=rn(L, B, Hkv, D), v_stage=rn(L, B, Hkv, D), pt=pt,
                pos=positions, act=active, rn=rn)


def _dense(x, D, Hq=4):
    rn = x["rn"]
    B, Hkv = x["pos"].shape[0], x["kp"].shape[3]
    cos, sin = rope.rope_cos_sin(x["pos"].long()[:, None], D, 10000.0,
                                 None)
    return rn(B, 1, Hq, D), rn(B, 1, Hkv, D), rn(B, 1, Hkv, D), cos, sin


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", [1, 2])
def test_dense_all_layer_mode_equals_unfused_chain(dtype, layer):
    """Layer 2 of 3 is the served case (the last); layer 1 writes pool
    layers 0..1 only."""
    x = _rows(1, 3, 2, 16, DTYPES[dtype])
    q, k, v, cos, sin = _dense(x, 16)
    kp, vp, ks, vs = (x[n].clone() for n in ("kp", "vp", "k_stage",
                                              "v_stage"))
    q1, k1 = q.clone(), k.clone()
    kv.rope_kv_update_all_layers(q1, k1, v, cos, sin, kp, vp, x["pt"],
                                 x["pos"], x["act"], layer, ks, vs)
    # The chain it replaces: the pool-less writer, a stack, K6.
    kp2, vp2 = x["kp"].clone(), x["vp"].clone()
    q2, k2 = q.clone(), k.clone()
    kv.rope_kv_update_layer(q2, k2, v, cos, sin)
    n = layer + 1
    kv.paged_kv_update_plain(
        kp2[:n], vp2[:n],
        torch.stack([x["k_stage"][i] for i in range(layer)] + [k2[:, 0]]),
        torch.stack([x["v_stage"][i] for i in range(layer)] + [v[:, 0]]),
        x["pt"], x["pos"], x["act"])
    for a, b in ((q1, q2), (k1, k2), (kp, kp2), (vp, vp2)):
        assert torch.equal(a, b)
    assert torch.equal(ks[layer], k2[:, 0]) and torch.equal(vs[layer],
                                                              v[:, 0])
    assert torch.equal(ks[:layer], x["k_stage"][:layer])
    # Rows 1 (NULL page), 2 (inactive) and 4 (past the table) dropped.
    changed = (kp != x["kp"]).flatten(3).any(-1)
    assert int(changed.sum()) == 2 * n and not changed[n:].any()
    # JAX's all-layer writer on the same rows.
    jk, jv = jatt.write_decode_kv_all_layers_xla(
        jnp.asarray(x["kp"][:n].float().numpy()),
        jnp.asarray(x["vp"][:n].float().numpy()),
        jnp.asarray(ks[:n].float().numpy()),
        jnp.asarray(vs[:n].float().numpy()), jnp.asarray(x["pt"].numpy()),
        jnp.asarray(x["pos"].numpy()), jnp.asarray(x["act"].numpy()))
    np.testing.assert_array_equal(kp[:n].float().numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp[:n].float().numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", [1, 2])
def test_latent_all_layer_mode_equals_unfused_chain(dtype, layer):
    """The MLA latent row (kv_lora_rank 32 + rope 8) into both pools."""
    r, dr = 32, 8
    x = _rows(2, 3, 1, r + dr, DTYPES[dtype])
    rn, B = x["rn"], x["pos"].shape[0]
    cos, sin = rope.rope_cos_sin(x["pos"].long()[:, None], dr, 10000.0,
                                 None)
    args = (rn(B, 1, r + dr), (1 + 0.1 * rn(r)), cos, sin, 1e-6, True)
    kp, vp = x["kp"].clone(), x["vp"].clone()
    stage = x["k_stage"].clone()
    lat = kv.latent_kv_update_all_layers(*args, kp, vp, x["pt"], x["pos"],
                                         x["act"], layer, stage)
    kp2, vp2 = x["kp"].clone(), x["vp"].clone()
    lat2 = kv.latent_kv_update_layer(*args)
    n = layer + 1
    rows = torch.stack([x["k_stage"][i] for i in range(layer)]
                       + [lat2[:, 0]])
    kv.paged_kv_update_plain(kp2[:n], vp2[:n], rows, rows, x["pt"],
                             x["pos"], x["act"])
    assert torch.equal(lat, lat2)
    assert torch.equal(stage[layer], lat2[:, 0])
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    changed = (kp != x["kp"]).flatten(3).any(-1)     # both pools alike
    assert int(changed.sum()) == 2 * n
    assert torch.equal(kp[changed], vp[changed])


def test_all_layer_mode_rejects_bad_staging():
    x = _rows(3, 3, 2, 16, torch.float32)
    q, k, v, cos, sin = _dense(x, 16)
    base = (q, k, v, cos, sin, x["kp"], x["vp"], x["pt"], x["pos"],
            x["act"])
    with pytest.raises(ValueError):            # a slot too small
        kv.rope_kv_update_all_layers(*base, 2, x["k_stage"][:, :4],
                                     x["v_stage"])
    with pytest.raises(ValueError):            # no slot for the layer
        kv.rope_kv_update_all_layers(*base, 2, x["k_stage"][:2],
                                     x["v_stage"][:2])
    with pytest.raises(ValueError):            # staging and pools together
        kv.rope_kv_update_layer(q, k, v, cos, sin, x["kp"], x["vp"],
                                x["pt"], x["pos"], x["act"], 0,
                                k_stage=x["k_stage"], v_stage=x["v_stage"])


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("geometry", ["gqa", "mla"])
def test_poisoned_fold_slots_leave_current_attention_unchanged(geometry, S):
    """NaN at every (layer, row) slot the fold writes: pool position
    ``positions`` of each active row. The last layer's current-token
    attention, cache lengths where(active, positions, 0), reads pool
    positions below them only, so its output keeps its bits."""
    rng = np.random.default_rng(7)
    L, P, ps, MP, B = 3, 40, 8, 6, 4
    Hkv, Hq, D, chunk = (2, 8, 16, 8) if geometry == "gqa" else \
        (1, 16, 72, pa.MLA_CHUNK)
    kp = torch.from_numpy(rng.normal(size=(L, P, ps, Hkv, D)).astype(
        np.float32))
    vp = kp if geometry == "mla" else torch.from_numpy(
        rng.normal(size=(L, P, ps, Hkv, D)).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * MP].reshape(
        B, MP).astype(np.int32))
    positions = torch.tensor([0, 21, 40, 33], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    cache = torch.where(active, positions, torch.zeros_like(positions))
    q = torch.from_numpy(rng.normal(size=(B, Hq, D)).astype(np.float32))
    cur = torch.from_numpy(rng.normal(size=(B, Hkv, D)).astype(np.float32))
    v_cur = cur if geometry == "mla" else torch.from_numpy(
        rng.normal(size=(B, Hkv, D)).astype(np.float32))

    def attend(k_pages, v_pages):
        return pa.paged_decode_attention_split_plain(
            q, k_pages, v_pages, pt, cache, L - 1, S, chunk, k_cur=cur,
            v_cur=v_cur)
    want = attend(kp, vp)
    kp2, vp2 = kp.clone(), vp.clone()
    flat = (pt.long().gather(1, (positions.long() // ps)[:, None])[:, 0]
            * ps + positions.long() % ps)[active]
    for pool in (kp2, vp2):
        pool.view(L, P * ps, Hkv, D)[:, flat] = float("nan")
    assert torch.isnan(kp2).any()
    got = attend(kp2, vp2 if geometry == "gqa" else kp2)
    assert torch.equal(got, want)
    # The plain reference the CPU forward runs reads the slot but masks
    # it: with the fold's own finite rows there, the same bits.
    kp3, vp3 = kp.clone(), vp.clone()
    for pool, rows in ((kp3, cur), (vp3, v_cur)):
        pool.view(L, P * ps, Hkv, D)[L - 1, flat] = rows[active]
    ref = pa.paged_decode_attention_current_plain
    np.testing.assert_array_equal(
        ref(q, kp3, vp3, pt, cache, cur, v_cur, L - 1).numpy(),
        ref(q, kp, vp, pt, cache, cur, v_cur, L - 1).numpy())
    np.testing.assert_allclose(got.numpy(), ref(
        q, kp, vp, pt, cache, cur, v_cur, L - 1).numpy(), **TOL)


# ---------------------------------------------------------------------------
# The engine, attend-then-write, on a pool that preempts
# ---------------------------------------------------------------------------

# 16 usable pages of 4 tokens for 4 sequences that grow to 22-24 tokens.
TIGHT = dict(page_size=4, num_pages=17, max_model_len=128,
             max_batch_size=4, max_prefill_tokens=32,
             prefill_buckets=(8, 16, 32))
PRESSURE = {1: [(9, 14), (14, 10)], 2: [(6, 16)], 4: [(12, 12)]}
MLA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           moe_intermediate_size=48, num_layers=3, num_heads=4,
           num_kv_heads=4, head_dim=8, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, num_experts=4,
           num_experts_per_tok=2, n_shared_experts=1,
           first_k_dense_replace=1, routed_scaling_factor=1.5,
           norm_topk_prob=False, max_position_embeddings=512,
           rope_theta=10000.0, dtype="float32", name="tiny-v2-lite",
           rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True, 0.707),
           mla_yarn_mscale=True)


def _models(model):
    if model == "dense":
        jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128),
                                   dtype="float32")
        tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                                   dtype="float32")
    else:
        jcfg, tcfg = JaxModelConfig(**MLA), ModelConfig(**MLA)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _feed(vocab, seed=0):
    rng = np.random.default_rng(seed)
    feed, i = {}, 0
    for step, reqs in sorted(PRESSURE.items()):
        for n, max_tokens in reqs:
            feed.setdefault(step, []).append(
                (f"r{i}", rng.integers(3, vocab, size=n).tolist(),
                 max_tokens))
            i += 1
    return feed


def _drive(engine, feed, request, sampling):
    """Run to idle; returns (streams, per-step ledger)."""
    streams, ledger, step = {}, [], 0
    while engine.has_work() or step < max(feed):
        step += 1
        for rid, toks, max_tokens in feed.get(step, []):
            engine.add_request(request(rid, toks, sampling(
                max_tokens=max_tokens, temperature=0.0, ignore_eos=True)))
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
        assert step < 400, "engine did not drain"
    return streams, ledger


@pytest.mark.parametrize("order", ["attend_then_write", "write_then_attend"])
@pytest.mark.parametrize("model", ["dense", "mla"])
def test_engine_matches_jax_under_pressure(monkeypatch, model, order):
    """Both orders of the KV write, chosen by XLLM_WRITE_THEN_ATTEND as a
    deployment chooses it; the all-layer mode runs in attend-then-write
    only."""
    wta = order == "write_then_attend"
    monkeypatch.setenv("XLLM_WRITE_THEN_ATTEND", "1" if wta else "0")
    jcfg, tcfg, jparams, tparams = _models(model)
    feed = _feed(tcfg.vocab_size)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **TIGHT, decode_steps=1, enable_prefix_cache=False), params=jparams)
    assert jeng.write_then_attend is wta
    jst, jled = _drive(jeng, feed, JaxRequest, JaxSampling)
    teng = Engine(tcfg, EngineConfig(**TIGHT, enable_prefix_cache=False),
                  params=tparams, device="cpu")
    assert teng.write_then_attend is wta
    calls = []
    fold = ("rope" if model == "dense" else "latent") + \
        "_kv_update_all_layers"
    inner = getattr(ttf, fold)

    def counted_fold(*args, **kw):
        calls.append(args[10 if model == "dense" else 11])
        return inner(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("K6 reached from a forward")
    monkeypatch.setattr(ttf, fold, counted_fold)
    monkeypatch.setattr(ttf, "paged_kv_update", refused, raising=False)
    tst, tled = _drive(teng, feed, EngineRequest, SamplingParams)
    assert tst == jst
    assert tled == jled
    assert teng.num_preemptions == jeng.num_preemptions > 0
    decode_forwards = sum(kind in ("decode", "mixed")
                          for kind, *_ in tled)
    assert decode_forwards > 0
    assert len(calls) == (0 if wta else decode_forwards)
    assert set(calls) <= {tcfg.num_layers - 1}         # the last layer
    assert "torch.stack" not in inspect.getsource(ttf)
