"""The port's DeepSeek path (multi-head latent attention with DeepSeek's
MoE) against the JAX package's, on the CPU in float32, on the same
weights (``params_from_jax`` of the JAX ``init_params``).

- Yarn rope and the adjacent-pair rotation against JAX: atol = rtol =
  1e-6 (float32 transcendentals of the same formulas).
- The DeepSeek gate (V2 greedy, V2 group-limited, V3 sigmoid with the
  selection bias): atol = rtol = 1e-6 on the routing map, selections
  equal. Inputs have no ties (``torch.topk`` and ``jax.lax.top_k`` may
  break ties apart).
- K3'', the MLA decode attention in both forms, through the wrappers on
  CPU tensors (their plain versions) against the Pallas kernel in
  interpret mode with the JAX package's MLA kernel switch on, at
  Hkv = 1 and D = 40 and 576: atol = rtol = 1e-5.
- Forwards of a tiny V2-Lite-shaped model and a tiny V3-shaped one, in
  both orders of the KV write: logits and both pools within atol = rtol
  = 1e-4 (float32 through three layers, different summation orders).
- The engine: temperature-0 streams and the per-step ledger identical to
  the JAX engine's; with the ragged step asked for, an MLA engine runs
  its mixed iterations split, as JAX does.
- The worker serving a tiny MLA model: texts equal to the JAX worker's.
"""

import functools
import json
from http.client import HTTPConnection

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops import pallas as jpallas
from xllm_service_tpu.ops import rope as jrope
from xllm_service_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas)
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops import rope as trope
from xllm_service_tpu_torch.ops.kernels import (
    paged_decode_attention_mla, paged_decode_attention_mla_current)
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

ROPE_TOL = dict(atol=1e-6, rtol=1e-6)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
YARN = ("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True, 0.707)

# The tiny DeepSeek shapes of tests/test_deepseek.py, as ModelConfigs:
# V2-Lite's (no q compression, greedy routing, yarn with the mscale
# fold) and V3's (q compression, sigmoid scoring with the selection
# bias, group-limited routing, normalized weights).
_BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             moe_intermediate_size=48, num_layers=3, num_heads=4,
             num_kv_heads=4, head_dim=8, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             num_experts=4, num_experts_per_tok=2, n_shared_experts=1,
             first_k_dense_replace=1, routed_scaling_factor=1.5,
             norm_topk_prob=False, max_position_embeddings=512,
             rope_theta=10000.0, dtype="float32")
CONFIGS = {
    "v2_lite": dict(_BASE, name="tiny-v2-lite", rope_scaling=YARN,
                    mla_yarn_mscale=True),
    "v3": dict(_BASE, name="tiny-v3", q_lora_rank=24, num_experts=8,
               n_group=2, topk_group=1, topk_method="group_limited_greedy",
               moe_scoring="sigmoid", routed_scaling_factor=2.5,
               norm_topk_prob=True),
}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    # CPU tensors never launch a kernel.
    assert all(n == 0 for n in kernels.launch_counts().values())


@functools.lru_cache(maxsize=None)
def _setup(kind):
    """(JAX config, port config, JAX params, port params); shared, never
    written to."""
    kw = CONFIGS[kind]
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if "router_bias" in jparams.get("layers_moe", {}):
        # The init's zero bias would leave the bias path untested.
        bias = np.random.default_rng(3).uniform(
            -0.5, 0.5, jparams["layers_moe"]["router_bias"].shape)
        jparams["layers_moe"]["router_bias"] = jnp.asarray(bias, jnp.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# Rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scaling", [
    YARN, ("yarn", 32.0, 32.0, 1.0, 4096, 1.3, False, 0.0),
    ("yarn", 4.0, 64.0, 2.0, 256, 1.0, True, 1.0), None],
    ids=["v2_lite", "untruncated", "narrow", "none"])
@pytest.mark.parametrize("dim", [8, 64])
def test_rope_matches_jax(scaling, dim):
    """Yarn frequencies and attention factor, and both rotations, with
    and without a head axis."""
    rng = np.random.default_rng(5)
    np.testing.assert_allclose(
        trope.rope_inv_freq(dim, 10000.0, scaling).numpy(),
        np.asarray(jrope.rope_inv_freq(dim, 10000.0, scaling)), **ROPE_TOL)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    tc, ts = trope.rope_cos_sin(_t(pos), dim, 10000.0, scaling)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), dim, 10000.0,
                                scaling=scaling)
    _close(tc, jc, ROPE_TOL)
    _close(ts, js, ROPE_TOL)
    for shape in ((2, 7, dim), (2, 7, 3, dim)):
        x = _f32(rng, *shape)
        _close(trope.apply_rope_interleaved(_t(x), _t(pos), 10000.0, scaling),
               jrope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(pos),
                                            10000.0, scaling), ROPE_TOL)
        _close(trope.apply_rope(_t(x), _t(pos), 10000.0, scaling),
               jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                                scaling), ROPE_TOL)


def test_mla_scale_matches_jax():
    for kind in CONFIGS:
        jcfg, tcfg = JaxModelConfig(**CONFIGS[kind]), \
            ModelConfig(**CONFIGS[kind])
        assert ttf._mla_scale(tcfg) == pytest.approx(jtf._mla_scale(jcfg),
                                                     rel=1e-12)
    # DeepSeek-V2-Lite: yarn's mscale squared, x1.590.
    lite = ModelConfig.deepseek_v2_lite()
    assert ttf._mla_scale(lite) * lite.qk_head_dim ** 0.5 == \
        pytest.approx(1.5896, abs=1e-4)


# ---------------------------------------------------------------------------
# The DeepSeek gate
# ---------------------------------------------------------------------------

GATES = {
    "v2_greedy": dict(num_experts=16, num_experts_per_tok=3),
    "v2_group": dict(num_experts=16, num_experts_per_tok=3, n_group=4,
                     topk_group=2, topk_method="group_limited_greedy"),
    "v3_sigmoid": dict(num_experts=16, num_experts_per_tok=4, n_group=4,
                       topk_group=2, topk_method="group_limited_greedy",
                       moe_scoring="sigmoid", norm_topk_prob=True,
                       routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("kind", sorted(GATES))
def test_deepseek_gate_matches_jax(kind):
    kw = dict(CONFIGS["v2_lite"], **GATES[kind])
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(7)
    x = _f32(rng, 3, 5, 64)
    router = _f32(rng, 64, 16)
    bias = (rng.uniform(-0.5, 0.5, 16).astype(np.float32)
            if kind == "v3_sigmoid" else None)
    want = np.asarray(jtf._deepseek_gate(
        jcfg, jnp.asarray(x), jnp.asarray(router),
        None if bias is None else jnp.asarray(bias)))
    got = ttf._deepseek_gate(tcfg, _t(x), _t(router),
                             None if bias is None else _t(bias)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) == kw["num_experts_per_tok"]).all()
    _close(got, want, ROPE_TOL)


# ---------------------------------------------------------------------------
# K3'': MLA decode attention, both forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,Hq", [(40, 4), (576, 16)])
@pytest.mark.parametrize("form", ["pool", "current"])
def test_mla_decode_attention_matches_pallas(monkeypatch, D, Hq, form):
    """One latent pool as K and V (Hkv = 1). Pool-only: contexts with a
    0 (zeros). Current: cache lengths with a 0 (the current row alone);
    the pool slot at each cache length holds a random row unlike the
    current one, so reading it would disagree."""
    monkeypatch.setenv("XLLM_PALLAS", "1")
    monkeypatch.setenv("XLLM_PALLAS_MLA", "1")
    assert jpallas.mla_kernel_enabled()
    rng = np.random.default_rng(43)
    L, P, ps, B, MP = 2, 16, 8, 4, 4
    pool = _f32(rng, L, P, ps, 1, D)
    q = _f32(rng, B, Hq, D)
    cur = _f32(rng, B, 1, D)
    pt = rng.integers(1, P, size=(B, MP)).astype(np.int32)
    lens = np.array([13, 0, 32, 7], np.int32)
    scale = 0.137
    for li in range(L):
        if form == "pool":
            want = paged_decode_attention_pallas(
                jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool),
                jnp.asarray(pt), jnp.asarray(lens), scale=scale,
                layer=jnp.int32(li))
            got = paged_decode_attention_mla(_t(q), _t(pool), _t(pt),
                                             _t(lens), li, scale).numpy()
        else:
            want = jatt.paged_decode_attention_current_auto(
                jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool),
                jnp.asarray(pt), jnp.asarray(lens), jnp.asarray(cur),
                jnp.asarray(cur), scale=scale, layer=jnp.int32(li))
            got = paged_decode_attention_mla_current(
                _t(q), _t(pool), _t(pt), _t(lens), _t(cur), li,
                scale).numpy()
        assert got.shape == (B, Hq, D)
        np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    if form == "pool":
        assert not got[1].any()               # context 0: zeros
    else:
        # Cache length 0: the current row alone.
        np.testing.assert_allclose(got[1], np.repeat(cur[1], Hq, axis=0),
                                   **ATTN_TOL)


def test_mla_decode_attention_rejects_bad_arguments():
    pool = torch.zeros(2, 4, 8, 1, 40)
    pt = torch.ones(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    q = torch.zeros(2, 4, 40)
    bad_calls = [
        # two latent heads
        lambda: paged_decode_attention_mla(q, torch.zeros(2, 4, 8, 2, 40),
                                           pt, lens, 0, 0.1),
        # q wider than the latent row
        lambda: paged_decode_attention_mla(torch.zeros(2, 4, 48), pool, pt,
                                           lens, 0, 0.1),
        # layer out of range
        lambda: paged_decode_attention_mla(q, pool, pt, lens, 2, 0.1),
        # lengths int64
        lambda: paged_decode_attention_mla(
            q, pool, pt, torch.ones(2, dtype=torch.int64), 0, 0.1),
        # current row of the wrong shape
        lambda: paged_decode_attention_mla_current(
            q, pool, pt, lens, torch.zeros(2, 40), 0, 0.1),
        # current row of another dtype
        lambda: paged_decode_attention_mla_current(
            q, pool, pt, lens, torch.zeros(2, 1, 40, dtype=torch.float64),
            0, 0.1),
    ]
    for call in bad_calls:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def test_mla_params_layout():
    """``params_from_jax`` carries every leaf (``layers_moe`` and the
    float32 selection bias included); the port's init gives the same
    tree."""
    jcfg, tcfg, jparams, tparams = _setup("v3")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for k in [p.key for p in path]:
            t = t[k]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tparams["layers_moe"]["router_bias"].dtype == torch.float32
    mine = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for stack in ("layers", "layers_moe"):
        assert {k: tuple(v.shape) for k, v in mine[stack].items()} == \
            {k: tuple(v.shape) for k, v in tparams[stack].items()}
    kv = ttf.init_kv_cache(tcfg, 8, 4, "cpu")
    assert tuple(kv[0].shape) == (3, 8, 4, 1, 40)


@pytest.mark.parametrize("write_then_attend", [True, False],
                         ids=["write_then_attend", "attend_then_write"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_mla_forward_matches_jax(kind, write_then_attend):
    """Two prefill windows (the second at q_start 16, unaligned on the
    shorter row's tail), then two decode steps, one row inactive on the
    second: logits and both pools. Write-then-attend decode logits of an
    inactive row are padding (JAX's XLA reference attends it to the mean
    of the latent rows, the kernel to zeros) and are not compared."""
    jcfg, tcfg, jparams, tparams = _setup(kind)
    rng = np.random.default_rng(0)
    P, ps, B, MP = 24, 8, 2, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompt = rng.integers(3, 256, size=(B, 27)).astype(np.int32)
    lens = np.array([27, 19], np.int32)
    wta = write_then_attend
    for start, T in ((0, 16), (16, 16)):
        win = np.zeros((B, T), np.int32)
        n = np.clip(lens - start, 0, T).astype(np.int32)
        for b in range(B):
            win[b, :n[b]] = prompt[b, start:start + n[b]]
        st = np.full((B,), start, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(win), jnp.asarray(st),
            jnp.asarray(n), jkv, jnp.asarray(pt), write_then_attend=wta)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, _t(win).long(), _t(st), _t(n), tkv, _t(pt),
            write_then_attend=wta)
        _close(tl, jl)
    for i in (0, 1):
        _close(tkv[i], jkv[i])
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    pos = lens.copy()
    for active in (np.array([1, 1], bool), np.array([1, 0], bool)):
        jl, jkv = jtf.forward_decode(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jkv, jnp.asarray(pt),
            write_then_attend=wta)
        tl, tkv = ttf.forward_decode(
            tparams, tcfg, _t(tok).long(), _t(pos), _t(active), tkv, _t(pt),
            write_then_attend=wta)
        rows = active if wta else np.ones_like(active)
        _close(tl.numpy()[rows], np.asarray(jl)[rows])
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    for i in (0, 1):
        _close(tkv[i], jkv[i])
    # Under MLA both pools carry the same latent rows.
    assert torch.equal(tkv[0], tkv[1])


def test_mla_has_no_ragged_forward():
    _, tcfg, _, tparams = _setup("v2_lite")
    kv = ttf.init_kv_cache(tcfg, 8, 8, "cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="ragged"):
        ttf.forward_prefill(tparams, tcfg, torch.ones(1, 4, dtype=torch.long),
                            one, one, kv, torch.ones(1, 2, dtype=torch.int32),
                            ragged=True)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=160, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))
# A prompt longer than the largest bucket (chunked) arriving beside a
# running one, so that iterations mix decode and prefill.
WORKLOAD = {1: [(9, 6)], 2: [(40, 5), (6, 4)]}


def _feed(workload, seed=0):
    rng = np.random.default_rng(seed)
    feed, i = {}, 0
    for step, reqs in sorted(workload.items()):
        for n, max_tokens in reqs:
            feed.setdefault(step, []).append(
                (f"r{i}", rng.integers(3, 256, size=n).tolist(), max_tokens))
            i += 1
    return feed


def _drive(engine, feed, request, sampling):
    """Run to idle; returns (streams by request id, per-step ledger)."""
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


@pytest.mark.parametrize("kw", [dict(write_then_attend=False),
                                dict(write_then_attend=True),
                                dict(write_then_attend=False,
                                     ragged_attn=True)],
                         ids=["attend_then_write", "write_then_attend",
                              "ragged_asked"])
def test_mla_engine_matches_jax(kw):
    jcfg, tcfg, jparams, tparams = _setup("v2_lite")
    feed = _feed(WORKLOAD)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **ENGINE_KW, **kw, decode_steps=1, enable_prefix_cache=False),
        params=jparams)
    assert not jeng.ragged
    jst, jled = _drive(jeng, feed, JaxRequest, JaxSampling)
    teng = Engine(tcfg, EngineConfig(**ENGINE_KW, **kw,
                                     enable_prefix_cache=False),
                  params=tparams, device="cpu")
    assert not teng.ragged
    assert teng.write_then_attend == kw["write_then_attend"]
    tst, tled = _drive(teng, feed, EngineRequest, SamplingParams)
    assert tst == jst
    assert tled == jled
    assert len(tst) == sum(len(v) for v in feed.values())
    assert teng.ragged_steps == 0
    # Mixed iterations ran split: a decode and a prefill forward each.
    assert any(kind == "mixed" and forwards == 2
               for kind, _, _, _, forwards in tled)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _post(addr, path, obj):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_worker_serves_tiny_mla():
    """The byte tokenizer's ids run past 256, so the model takes a
    vocabulary of 512."""
    kw = dict(CONFIGS["v2_lite"], vocab_size=512)
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny-mla", lambda: jcfg)
    jw = jax_worker.Worker(jax_worker.WorkerOptions(model="tiny-mla"),
                           InMemoryStore()).start()
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jtf.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, "cpu")
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny-mla", device="cpu"),
        model_cfg=tcfg, params=params).start()
    try:
        for path, body in (
                ("/v1/completions", {"prompt": "latent pages", "max_tokens": 9,
                                     "temperature": 0.0}),
                ("/v1/chat/completions", {"messages": [
                    {"role": "user", "content": "what is MLA?"}],
                    "max_tokens": 7, "temperature": 0.0})):
            (js, jr), (ts, tr) = _post(jw.name, path, body), \
                _post(tw.name, path, body)
            assert js == ts == 200, (jr, tr)
            key = (lambda c: c["message"]["content"]) if "messages" in body \
                else (lambda c: c["text"])
            assert key(tr["choices"][0]) == key(jr["choices"][0])
            assert tr["usage"] == jr["usage"]
    finally:
        tw.stop()
        jw.stop()
        mp.undo()


def test_deepseek_v2_lite_is_served():
    """The worker's registry names DeepSeek-V2-Lite, and the port takes
    its configuration whole."""
    cfg = torch_worker.resolve_model_config("deepseek-v2-lite")
    ttf.check_supported(cfg)
    assert cfg.mla and cfg.kv_cache_heads == 1 and cfg.kv_cache_dim == 576
