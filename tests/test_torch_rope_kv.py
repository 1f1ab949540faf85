"""The layer body's fused writers (``ops/kernels/kv_update.py``: K1 and K2
fused with the rope of q and k, and with the MLA latent row), on CPU
tensors (so running each kernel's plain version), against the JAX
package's rope, latent and writers on the same numpy inputs.

- Dense form: q and k rotated in place and k/v written, against JAX
  ``rope_for`` then the Pallas one-layer writer in interpret mode (page-
  aligned windows) or the XLA scatter the JAX package falls back to
  (unaligned and ragged windows). Tolerance: float32 atol = rtol = 1e-5
  (the cos/sin tables are the same formulas in two libraries); bf16
  atol = 1e-5, rtol = 2**-7 (one bf16 ulp: a float32 result a few ulp
  apart can round to the neighbouring bf16 value).
- Against the port's unfused chain (``rotate`` of q and of k, then
  ``paged_kv_update_layer`` / ``paged_prefill_kv_update_layer``): bit
  for bit, in float32 and bf16.
- MLA latent form: against the latent of JAX ``_mla_qkv`` plus the XLA
  writer into both pools, at tiny V2-Lite and V3 shapes, float32, atol =
  rtol = 1e-5; in bf16 against JAX ``rms_norm`` and the interleaved rope
  of the same ckv, atol = rtol = 2e-2 (bf16 outputs).
- Every forward (both orders, dense and MLA, the ragged step) calls its
  fused writer once per layer, with pools in write-then-attend and
  without in attend-then-write, and the unfused one-layer writers never.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops import rope as jrope
from xllm_service_tpu.ops.norm import rms_norm as jax_rms_norm
from xllm_service_tpu.ops.pallas.kv_update import (
    paged_kv_update_layer as jax_kv_update_layer,
    paged_prefill_kv_update_layer as jax_prefill_kv_update_layer)
from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops import rope as trope
from xllm_service_tpu_torch.ops.kernels import kv_update
from xllm_service_tpu_torch.ops.kernels import (
    latent_kv_update_layer, latent_prefill_kv_update_layer,
    paged_kv_update_layer, paged_prefill_kv_update_layer,
    rope_kv_update_layer, rope_prefill_kv_update_layer)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
LATENT_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
THETA = 10000.0
SCALINGS = {
    "none": None,
    "llama3": ("llama3", 32.0, 1.0, 4.0, 256),
    "yarn": ("yarn", 40.0, 32.0, 1.0, 4096, 0.9, True, 0.707),
}
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    a = jnp.asarray(np.asarray(x))
    return a if dtype is None else a.astype(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    # CPU tensors never launch a kernel.
    assert all(n == 0 for n in kernels.launch_counts().values())


def _dense_inputs(rng, B, T, Hq, Hkv, D, L, P, ps):
    return (_f32(rng, B, T, Hq, D), _f32(rng, B, T, Hkv, D),
            _f32(rng, B, T, Hkv, D), _f32(rng, L, P, ps, Hkv, D),
            _f32(rng, L, P, ps, Hkv, D))


def _cos_sin(positions, D, scaling):
    return trope.rope_cos_sin(_t(positions).long(), D, THETA, scaling)


# ---------------------------------------------------------------------------
# Dense form against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scaling", sorted(SCALINGS))
def test_decode_form_matches_jax(scaling, dtype):
    """GQA (Hq = 8 over Hkv = 2), a NULL page table row, an inactive row
    and a position past the table: nothing written there, every row
    rotated; against JAX rope_for + the Pallas decode writer."""
    tdt, jdt, tol = DTYPES[dtype]
    sc = SCALINGS[scaling]
    rng = np.random.default_rng(31)
    L, P, ps, Hq, Hkv, D, B, MP = 3, 32, 8, 8, 2, 64, 5, 4
    q, k, v, kp, vp = _dense_inputs(rng, B, 1, Hq, Hkv, D, L, P, ps)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[1, :] = 0                                    # NULL row
    pos = np.array([0, 5, 7, 13, 100], np.int32)    # 100: past the table
    act = np.array([1, 1, 0, 1, 1], bool)           # row 2 inactive
    layer = 1
    jq = jrope.rope_for(sc, _j(q, jdt), _j(pos)[:, None], THETA)
    jk = jrope.rope_for(sc, _j(k, jdt), _j(pos)[:, None], THETA)
    jkp, jvp = jax_kv_update_layer(
        _j(kp, jdt), _j(vp, jdt), jk[:, 0], _j(v, jdt)[:, 0], _j(pt),
        _j(pos), _j(act), jnp.int32(layer), interpret=True)
    tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
    tkp, tvp = _t(kp, tdt), _t(vp, tdt)
    cos, sin = _cos_sin(pos[:, None], D, sc)
    out = rope_kv_update_layer(tq, tk, tv, cos, sin, tkp, tvp, _t(pt),
                               _t(pos), _t(act), layer)
    assert out[0] is tq and out[1] is tk            # rotated in place
    for got, want in ((tq, jq), (tk, jk), (tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    # Rows 1 (NULL), 2 (inactive) and 4 (past the table) wrote nothing.
    changed = (tkp != _t(kp, tdt)).flatten(2).any(-1).sum().item()
    assert changed == 2


PREFILL_CASES = {
    # (starts, lengths): page-aligned starts (the Pallas writer's domain;
    # row 3 runs off the table), unaligned starts, and a ragged batch of
    # decode continuations (length 1, mid-page) beside a window.
    "aligned": ([0, 8, 0, 40], [16, 11, 16, 5]),
    "unaligned": ([4, 21, 3, 7], [16, 11, 16, 5]),
    "ragged": ([5, 13, 0, 30], [1, 1, 16, 1]),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scaling", sorted(SCALINGS))
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_form_matches_jax(case, scaling, dtype):
    """A window batch [4, 16] (padding rotated too, written only below
    each row's length; row 2's table NULL): against JAX rope_for + the
    Pallas prefill writer (aligned) or the XLA scatter (the others)."""
    tdt, jdt, tol = DTYPES[dtype]
    sc = SCALINGS[scaling]
    starts, lens = (np.array(x, np.int32) for x in PREFILL_CASES[case])
    rng = np.random.default_rng(32)
    L, P, ps, Hq, Hkv, D, B, T, MP = 3, 32, 8, 4, 2, 16, 4, 16, 6
    q, k, v, kp, vp = _dense_inputs(rng, B, T, Hq, Hkv, D, L, P, ps)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[2, :] = 0                                    # NULL row
    positions = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    layer = 2
    jq = jrope.rope_for(sc, _j(q, jdt), _j(positions), THETA)
    jk = jrope.rope_for(sc, _j(k, jdt), _j(positions), THETA)
    jargs = (_j(kp, jdt), _j(vp, jdt), jk, _j(v, jdt), _j(pt), _j(starts),
             _j(lens))
    if case == "aligned":
        jkp, jvp = jax_prefill_kv_update_layer(*jargs, jnp.int32(layer),
                                               interpret=True)
    else:
        jkp, jvp = jatt.write_prefill_kv_layer_xla(*jargs, layer)
    tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
    tkp, tvp = _t(kp, tdt), _t(vp, tdt)
    cos, sin = _cos_sin(positions, D, sc)
    rope_prefill_kv_update_layer(tq, tk, tv, cos, sin, tkp, tvp, _t(pt),
                                 _t(starts), _t(lens), layer)
    for got, want in ((tq, jq), (tk, jk), (tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pool_less_form_only_rotates(dtype):
    """Without pools (attend-then-write) both forms rotate q and k as
    JAX rope_for does and leave v alone."""
    tdt, jdt, tol = DTYPES[dtype]
    sc = SCALINGS["llama3"]
    rng = np.random.default_rng(33)
    for T, fused in ((1, rope_kv_update_layer),
                     (6, rope_prefill_kv_update_layer)):
        q, k, v = _f32(rng, 3, T, 4, 32), _f32(rng, 3, T, 2, 32), \
            _f32(rng, 3, T, 2, 32)
        positions = np.array([[0], [17], [300]], np.int32) \
            + np.arange(T, dtype=np.int32)[None, :]
        tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
        cos, sin = _cos_sin(positions, 32, sc)
        fused(tq, tk, tv, cos, sin)
        for got, x in ((tq, q), (tk, k)):
            want = jrope.rope_for(sc, _j(x, jdt), _j(positions), THETA)
            np.testing.assert_allclose(_np(got), _np(want), **tol)
        assert torch.equal(tv, _t(v, tdt))


# ---------------------------------------------------------------------------
# Dense form against the port's unfused chain, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_equals_unfused_chain(dtype):
    """rotate(q), rotate(k), then K1 / K2 (the unfused wrappers): the
    same bits in q, k and both pools, with pools and without."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(34)
    L, P, ps, Hq, Hkv, D, MP = 2, 16, 8, 6, 3, 32, 4
    for T, fused, writer in ((1, rope_kv_update_layer,
                              paged_kv_update_layer),
                             (12, rope_prefill_kv_update_layer,
                              paged_prefill_kv_update_layer)):
        B = 3
        q, k, v, kp, vp = (_t(x, tdt) for x in _dense_inputs(
            rng, B, T, Hq, Hkv, D, L, P, ps))
        pt = _t(rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP)
                .astype(np.int32))
        starts = _t(np.array([3, 9, 20], np.int32))
        positions = starts.long()[:, None] + torch.arange(T)[None, :]
        cos, sin = trope.rope_cos_sin(positions, D, THETA,
                                      SCALINGS["yarn"])
        if T == 1:
            rest = (starts, torch.tensor([True, False, True]))
        else:
            rest = (starts, _t(np.array([12, 7, 1], np.int32)))
        want_q, want_k = trope.rotate(q, cos, sin), trope.rotate(k, cos, sin)
        wkp, wvp = kp.clone(), vp.clone()
        if T == 1:
            writer(wkp, wvp, want_k[:, 0], v[:, 0], pt, *rest, 1)
        else:
            writer(wkp, wvp, want_k, v, pt, *rest, 1)
        for pools in (True, False):
            gq, gk, gkp, gvp = q.clone(), k.clone(), kp.clone(), vp.clone()
            if pools:
                fused(gq, gk, v, cos, sin, gkp, gvp, pt, *rest, 1)
            else:
                fused(gq, gk, v, cos, sin)
            assert torch.equal(gq, want_q) and torch.equal(gk, want_k)
            assert torch.equal(gkp, wkp if pools else kp)
            assert torch.equal(gvp, wvp if pools else vp)


# ---------------------------------------------------------------------------
# MLA latent form
# ---------------------------------------------------------------------------

_MLA_BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 moe_intermediate_size=48, num_layers=3, num_heads=4,
                 num_kv_heads=4, head_dim=8, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                 num_experts=4, num_experts_per_tok=2, n_shared_experts=1,
                 first_k_dense_replace=1, routed_scaling_factor=1.5,
                 norm_topk_prob=False, max_position_embeddings=512,
                 rope_theta=10000.0, dtype="float32")
MLA_CONFIGS = {
    "v2_lite": dict(_MLA_BASE, name="tiny-v2-lite",
                    rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True,
                                  0.707), mla_yarn_mscale=True),
    "v3": dict(_MLA_BASE, name="tiny-v3", q_lora_rank=24, num_experts=8,
               n_group=2, topk_group=1, topk_method="group_limited_greedy",
               moe_scoring="sigmoid", routed_scaling_factor=2.5,
               norm_topk_prob=True),
}


@functools.lru_cache(maxsize=None)
def _mla_setup(kind):
    """(JAX config, port config, JAX params, port params); shared, never
    written to."""
    kw = MLA_CONFIGS[kind]
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("form", ["decode", "prefill"])
@pytest.mark.parametrize("kind", sorted(MLA_CONFIGS))
def test_latent_form_matches_jax_mla_qkv(kind, form):
    """The latent row of one MoE layer from h: against the latent of JAX
    ``_mla_qkv`` written into both pools by the XLA scatter (decode: an
    inactive row and a NULL page; prefill: unaligned starts, a padded
    row); with pools and without."""
    jcfg, tcfg, jparams, tparams = _mla_setup(kind)
    rng = np.random.default_rng(35)
    B, T = (4, 1) if form == "decode" else (3, 8)
    L, P, ps, MP = tcfg.num_layers, 16, 8, 4
    W = tcfg.kv_cache_dim
    h = _f32(rng, B, T, tcfg.hidden_size)
    kp, vp = _f32(rng, L, P, ps, 1, W), _f32(rng, L, P, ps, 1, W)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[1, 0] = 0                                    # row 1's first page
    if form == "decode":
        starts = np.array([3, 6, 12, 30], np.int32)
        act = np.array([1, 1, 0, 1], bool)
    else:
        starts = np.array([0, 5, 11], np.int32)
        lens = np.array([8, 3, 6], np.int32)
    positions = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    layer = 1
    jlp = {k: v[0] for k, v in jparams["layers_moe"].items()}
    tlp = {k: v[0] for k, v in tparams["layers_moe"].items()}
    _, jlat = jtf._mla_qkv(jcfg, jlp, _j(h), _j(positions))
    if form == "decode":
        jkp, jvp = jatt.write_decode_kv_layer_xla(
            _j(kp), _j(vp), jlat[:, 0], jlat[:, 0], _j(pt), _j(starts),
            _j(act), layer)
        fused = latent_kv_update_layer
        rest = (_t(pt), _t(starts), _t(act), layer)
    else:
        jkp, jvp = jatt.write_prefill_kv_layer_xla(
            _j(kp), _j(vp), jlat, jlat, _j(pt), _j(starts), _j(lens), layer)
        fused = latent_prefill_kv_update_layer
        rest = (_t(pt), _t(starts), _t(lens), layer)
    args = ttf._latent_args(tcfg, tlp, _t(h),
                            ttf._mla_rope(tcfg, _t(positions)))
    tkp, tvp = _t(kp), _t(vp)
    lat = fused(*args, tkp, tvp, *rest)
    assert lat.shape == (B, T, 1, W)
    for got, want in ((lat, jlat), (tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_array_equal(fused(*args).numpy(), lat.numpy())


def test_latent_form_bf16_matches_jax_norm_and_rope():
    """bf16 at the V2-Lite latent width (512 + 64): the port's latent from
    ckv against JAX ``rms_norm`` and ``apply_rope_interleaved`` of the
    same bf16 ckv, and bit-exact with the port's unfused chain."""
    rng = np.random.default_rng(36)
    B, T, r, dr = 2, 5, 512, 64
    sc = ("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True, 0.707)
    ckv = _f32(rng, B, T, r + dr)
    w = (1.0 + 0.1 * rng.normal(size=r)).astype(np.float32)
    positions = np.array([[0], [901]], np.int32) \
        + np.arange(T, dtype=np.int32)[None, :]
    cos, sin = _cos_sin(positions, dr, sc)
    tc, tw = _t(ckv, torch.bfloat16), _t(w, torch.bfloat16)
    got = latent_prefill_kv_update_layer(tc, tw, cos, sin, 1e-6, True)
    jc = _j(ckv, jnp.bfloat16)
    want = jnp.concatenate(
        [jax_rms_norm(jc[..., :r], _j(w, jnp.bfloat16), 1e-6),
         jrope.apply_rope_interleaved(jc[..., r:], _j(positions), THETA,
                                      sc)], axis=-1)[:, :, None, :]
    np.testing.assert_allclose(_np(got), _np(want), **LATENT_BF16_TOL)
    unfused = torch.cat([ttf.rms_norm(tc[..., :r], tw, 1e-6),
                         trope.rotate_interleaved(tc[..., r:], cos, sin)],
                        dim=-1)[:, :, None, :]
    assert torch.equal(got, unfused)


def test_fused_writers_reject_bad_arguments():
    q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 1, 2, 16)
    cos, sin = torch.zeros(2, 1, 8), torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="cos/sin"):
        rope_kv_update_layer(q, k, k, torch.zeros(2, 1, 4),
                             torch.zeros(2, 1, 4))
    with pytest.raises(ValueError, match="T = 1"):
        rope_kv_update_layer(torch.zeros(2, 3, 4, 16),
                             torch.zeros(2, 3, 2, 16), None,
                             torch.zeros(2, 3, 8), torch.zeros(2, 3, 8))
    with pytest.raises(ValueError, match="must be"):
        rope_prefill_kv_update_layer(q, k, k, cos.double(), sin.double())
    with pytest.raises(ValueError, match="kv_lora_rank"):
        latent_kv_update_layer(torch.zeros(2, 1, 40), torch.zeros(40),
                               torch.zeros(2, 1, 0), torch.zeros(2, 1, 0),
                               1e-6, True)


# ---------------------------------------------------------------------------
# The forwards call the fused writers, once per layer
# ---------------------------------------------------------------------------

FUSED = ("rope_kv_update_layer", "rope_prefill_kv_update_layer",
         "latent_kv_update_layer", "latent_prefill_kv_update_layer",
         "rope_kv_update_all_layers", "latent_kv_update_all_layers")
UNFUSED = ("paged_kv_update_layer", "paged_prefill_kv_update_layer")


@pytest.fixture
def writer_calls(monkeypatch):
    """Counts each fused writer's calls through the model, split by
    whether pools were passed; the unfused one-layer writers must not be
    reached from the model at all."""
    calls = {}
    for name in FUSED:
        inner = getattr(ttf, name)

        def counted(*args, _name=name, _inner=inner, **kw):
            pools = len(args) > (6 if _name.startswith("latent") else 5)
            key = (_name, "pools" if pools else "no pools")
            calls[key] = calls.get(key, 0) + 1
            return _inner(*args, **kw)
        monkeypatch.setattr(ttf, name, counted)

    def refused(*args, **kw):
        raise AssertionError("an unfused one-layer writer was called")
    for name in UNFUSED:
        monkeypatch.setattr(ttf, name, refused, raising=False)
        monkeypatch.setattr(kv_update, name, refused)
        monkeypatch.setattr(kernels, name, refused)
    return calls


def _run_forward(cfg, params, path):
    B, ps, P = 2, 8, 16
    kv = ttf.init_kv_cache(cfg, P, ps, "cpu", dtype=torch.float32)
    pt = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32)
    wta = path != "attend_then_write_prefill" and \
        path != "attend_then_write_decode"
    if path.endswith("decode"):
        ttf.forward_decode(params, cfg, torch.tensor([3, 7]),
                           torch.tensor([9, 4], dtype=torch.int32),
                           torch.tensor([True, False]), kv, pt,
                           write_then_attend=wta)
    else:
        ragged = path == "ragged"
        T = 6
        lens = [1, 6] if ragged else [6, 4]
        ttf.forward_prefill(params, cfg, torch.randint(3, 250, (B, T)),
                            torch.tensor([9, 0], dtype=torch.int32),
                            torch.tensor(lens, dtype=torch.int32), kv, pt,
                            ragged=ragged, write_then_attend=wta)


PATHS = {
    "write_then_attend_prefill": "prefill", "write_then_attend_decode": "",
    "ragged": "prefill", "attend_then_write_prefill": "prefill",
    "attend_then_write_decode": ""}


@pytest.mark.parametrize("model,path", [
    (m, p) for m in ("dense", "mla") for p in sorted(PATHS)
    if not (m == "mla" and p == "ragged")])   # MLA never takes the ragged step
def test_forwards_call_fused_writer_once_per_layer(writer_calls, model,
                                                   path):
    if model == "dense":
        cfg = ModelConfig.tiny()
        params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", dtype=torch.float32)
    else:
        _, cfg, _, params = _mla_setup("v2_lite")
    _run_forward(cfg, params, path)
    kind = "rope" if model == "dense" else "latent"
    name = f"{kind}_{PATHS[path] + '_' if PATHS[path] else ''}kv_update_layer"
    if path == "attend_then_write_decode":
        # The last layer's writer is the all-layer mode, which writes
        # every layer's staged rows into the pools (K6 folded in).
        assert writer_calls == {(name, "no pools"): cfg.num_layers - 1,
                                (f"{kind}_kv_update_all_layers", "pools"): 1}
        return
    pools = "no pools" if path.startswith("attend_then_write") else "pools"
    assert writer_calls == {(name, pools): cfg.num_layers}
