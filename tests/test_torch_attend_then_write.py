"""The port's attend-then-write order (``write_then_attend=False``)
against the JAX package's, on the CPU in float32.

- The all-layer KV writers (``paged_kv_update``,
  ``paged_prefill_kv_update``) against the JAX Pallas kernels in
  interpret mode and against the XLA scatters: bit-exact.
- Decode attention with the current token held apart
  (``paged_decode_attention_current``) and prefill attention over the
  pool plus the fresh window (``paged_prefill_attention_fresh``) against
  the JAX Pallas forms in interpret mode and the XLA references:
  atol = rtol = 1e-5. The pool slots the current token or the window
  would occupy hold stale random values unlike the fresh operands, so a
  kernel that read them would disagree.
- The forwards, on six families, against JAX's with
  ``write_then_attend=False``, and against the port's other order: logits
  and pools within atol = rtol = 1e-4.
- The engine against the JAX engine with ``write_then_attend=False``:
  identical streams and per-step ledger.

On the CPU every wrapper runs its plain version, so no launch is
counted."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops.pallas.kv_update import (
    paged_kv_update as jax_kv_update,
    paged_prefill_kv_update as jax_prefill_kv_update)
from xllm_service_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas)
from xllm_service_tpu.ops.pallas.prefill_attention import (
    paged_prefill_attention_pallas)
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops.kernels import (
    paged_decode_attention_current, paged_kv_update,
    paged_prefill_attention_fresh, paged_prefill_kv_update)
from xllm_service_tpu_torch.runtime.engine import (
    Engine, EngineRequest, resolve_write_then_attend)
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    # CPU tensors never launch a kernel.
    assert all(n == 0 for n in kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# K6 / K7: the all-layer writers
# ---------------------------------------------------------------------------

# (Hkv, D): a GQA pool and the MLA latent geometry of tests/test_ops.py
# (one latent "head", a minor dim that is not 128-aligned).
GEOMETRIES = [(2, 64), (1, 72)]


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Hkv,D", GEOMETRIES, ids=["gqa", "mla_latent"])
def test_decode_all_layer_writer_matches_pallas_and_xla(Hkv, D):
    rng = np.random.default_rng(31)
    L, P, ps, B, MP = 3, 32, 8, 5, 4
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    kn, vn = _f32(rng, L, B, Hkv, D), _f32(rng, L, B, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[1, :] = 0                                    # NULL row
    pos = np.array([0, 5, 7, 13, 100], np.int32)    # 100: past the table
    act = np.array([1, 1, 0, 1, 1], bool)           # row 2 inactive
    args = [jnp.asarray(a) for a in (kp, vp, kn, vn, pt, pos, act)]
    want = jax_kv_update(*args, interpret=True)
    xla = jatt.write_decode_kv_all_layers_xla(*args)
    tk, tv = _t(kp), _t(vp)
    paged_kv_update(tk, tv, _t(kn), _t(vn), _t(pt), _t(pos), _t(act))
    for got, w, x in ((tk, want[0], xla[0]), (tv, want[1], xla[1])):
        _equal(got, w)
        _equal(got, x)
    # Exactly the rows that are not dropped (0 and 3) changed.
    changed = (tk.numpy() != kp).any(axis=(3, 4)).sum()
    assert changed == L * 2


@pytest.mark.parametrize("Hkv,D", GEOMETRIES, ids=["gqa", "mla_latent"])
def test_prefill_all_layer_writer_matches_pallas_and_xla(Hkv, D):
    rng = np.random.default_rng(32)
    L, P, ps, B, T, MP = 2, 32, 8, 4, 16, 6
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    kn, vn = _f32(rng, L, B, T, Hkv, D), _f32(rng, L, B, T, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[2, :] = 0                                    # NULL row
    lens = np.array([16, 11, 16, 5], np.int32)      # ragged tails
    # Page-aligned starts and T % ps == 0: the Pallas kernel's domain.
    start = np.array([0, 8, 0, 40], np.int32)       # row 3 runs off table
    args = [jnp.asarray(a) for a in (kp, vp, kn, vn, pt, start, lens)]
    want = jax_prefill_kv_update(*args, interpret=True)
    xla = jatt.write_prefill_kv_all_layers_xla(*args)
    tk, tv = _t(kp), _t(vp)
    paged_prefill_kv_update(tk, tv, _t(kn), _t(vn), _t(pt), _t(start),
                            _t(lens))
    for got, w, x in ((tk, want[0], xla[0]), (tv, want[1], xla[1])):
        _equal(got, w)
        _equal(got, x)


@pytest.mark.parametrize("Hkv,D", GEOMETRIES, ids=["gqa", "mla_latent"])
def test_prefill_all_layer_writer_unaligned_matches_xla(Hkv, D):
    """Unaligned starts and a T that is not a multiple of the page size,
    which the Pallas kernel cannot take: held to the XLA scatter."""
    rng = np.random.default_rng(33)
    L, P, ps, B, T, MP = 3, 32, 8, 4, 13, 6
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    kn, vn = _f32(rng, L, B, T, Hkv, D), _f32(rng, L, B, T, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[0, 1] = 0                                    # one NULL page
    start = np.array([4, 21, 3, 41], np.int32)
    lens = np.array([13, 9, 0, 7], np.int32)
    xla = jatt.write_prefill_kv_all_layers_xla(
        *[jnp.asarray(a) for a in (kp, vp, kn, vn, pt, start, lens)])
    tk, tv = _t(kp), _t(vp)
    paged_prefill_kv_update(tk, tv, _t(kn), _t(vn), _t(pt), _t(start),
                            _t(lens))
    _equal(tk, xla[0])
    _equal(tv, xla[1])


# ---------------------------------------------------------------------------
# K3': decode attention with the current token held apart
# ---------------------------------------------------------------------------

def _extras(rng, Hq, case):
    ex = dict(case)
    if ex.pop("sinks", False):
        s = _f32(rng, Hq)
        return {**ex, "sinks": jnp.asarray(s)}, {**ex, "sinks": _t(s)}
    return ex, ex


DECODE_CASES = [
    {},
    {"sliding_window": 6},
    {"sliding_window": 1},               # only the current key survives
    {"logits_soft_cap": 25.0, "scale": 0.21},
    {"sinks": True, "sliding_window": 11},
    {"sinks": True},
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)], ids=["g4", "g1"])
def test_decode_attention_current_matches_pallas_and_xla(case, Hq, Hkv):
    rng = np.random.default_rng(41)
    L, P, ps, D, B, MP = 2, 16, 8, 16, 5, 4
    # The pools are random everywhere, so the stale slot at each row's
    # cache_len holds values unlike k_cur/v_cur.
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, Hq, D)
    kc, vc = _f32(rng, B, Hkv, D), _f32(rng, B, Hkv, D)
    pt = rng.integers(1, P, size=(B, MP)).astype(np.int32)
    cache = np.array([1, 13, 31, 0, 8], np.int32)   # row 3: cache_len 0
    jx, tx = _extras(rng, Hq, case)
    for li in range(L):
        want = paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(cache), k_cur=jnp.asarray(kc),
            v_cur=jnp.asarray(vc), interpret=True, layer=jnp.int32(li),
            **jx)
        xla = jatt.paged_decode_attention_current(
            jnp.asarray(q), jnp.asarray(kp[li]), jnp.asarray(vp[li]),
            jnp.asarray(pt), jnp.asarray(cache), jnp.asarray(kc),
            jnp.asarray(vc), **{k: v for k, v in jx.items()})
        got = paged_decode_attention_current(
            _t(q), _t(kp), _t(vp), _t(pt), _t(cache), _t(kc), _t(vc), li,
            **tx).numpy()
        # All rows, the cache_len-0 row included.
        np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
        np.testing.assert_allclose(got, np.asarray(xla), **ATTN_TOL)
    if "sinks" not in case:
        # cache_len 0: the current token alone, so the output is v_cur.
        G = Hq // Hkv
        np.testing.assert_allclose(got[3], np.repeat(vc[3], G, axis=0),
                                   **ATTN_TOL)


def test_decode_attention_current_ignores_the_stale_slot():
    """Changing the pool slot at cache_len (and past it) changes
    nothing; changing a cached slot does."""
    rng = np.random.default_rng(42)
    L, P, ps, Hkv, D, B, MP, Hq = 1, 8, 4, 2, 16, 2, 3, 4
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q, kc, vc = _f32(rng, B, Hq, D), _f32(rng, B, Hkv, D), _f32(rng, B, Hkv, D)
    pt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    cache = np.array([5, 0], np.int32)

    def run(k):
        return paged_decode_attention_current(
            _t(q), _t(k), _t(vp), _t(pt), _t(cache), _t(kc), _t(vc),
            0).numpy()
    base = run(kp)
    stale = kp.copy()
    stale[0, 2, 1] = 99.0          # row 0, position 5 (= cache_len)
    stale[0, 4:7] = -99.0          # row 1: every slot (cache_len 0)
    np.testing.assert_array_equal(run(stale), base)
    cached = kp.copy()
    cached[0, 2, 0] += 1.0         # row 0, position 4 (cached)
    assert not np.allclose(run(cached)[0], base[0])


# ---------------------------------------------------------------------------
# K4': prefill attention over the pool plus the fresh window
# ---------------------------------------------------------------------------

PREFILL_CASES = [
    {},
    {"sliding_window": 6},
    {"logits_soft_cap": 25.0, "scale": 0.21},
    {"sinks": True, "sliding_window": 11},
]


def _prefill_inputs(rng, B, T, Hq, Hkv, D, L=2, P=40, ps=8, MP=6):
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, T, Hq, D)
    # Fresh rows unlike the (random, stale) pool slots of the window.
    kf, vf = _f32(rng, B, T, Hkv, D), _f32(rng, B, T, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    return kp, vp, q, kf, vf, pt


def _valid_rows_close(got, want, lens):
    for b in range(len(lens)):
        n = int(lens[b])
        np.testing.assert_allclose(got[b, :n], np.asarray(want)[b, :n],
                                   **ATTN_TOL)
        assert not got[b, n:].any()                 # rows past the length


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_attention_fresh_matches_pallas(case):
    """T % ps == 0, the Pallas two-source form's domain."""
    rng = np.random.default_rng(51)
    B, T, Hq, Hkv, D = 3, 16, 8, 2, 16
    kp, vp, q, kf, vf, pt = _prefill_inputs(rng, B, T, Hq, Hkv, D)
    q_start = np.array([0, 24, 8], np.int32)
    lens = np.array([16, 16, 5], np.int32)          # a ragged tail
    jx, tx = _extras(rng, Hq, case)
    for li in range(2):
        want = paged_prefill_attention_pallas(
            jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
            jnp.asarray(q_start), jnp.asarray(lens), q_block=8,
            interpret=True, layer=jnp.int32(li), **jx)
        got = paged_prefill_attention_fresh(
            _t(q), _t(kf), _t(vf), _t(kp), _t(vp), _t(pt), _t(q_start),
            _t(lens), li, **tx).numpy()
        _valid_rows_close(got, want, lens)


def _xla_fresh(q, kf, vf, kp, vp, pt, q_start, lens, extras):
    k_all = jatt.overlay_fresh_kv(jatt.gather_pages(jnp.asarray(kp),
                                                    jnp.asarray(pt)),
                                  jnp.asarray(kf), jnp.asarray(q_start))
    v_all = jatt.overlay_fresh_kv(jatt.gather_pages(jnp.asarray(vp),
                                                    jnp.asarray(pt)),
                                  jnp.asarray(vf), jnp.asarray(q_start))
    return jatt.mha_prefill(jnp.asarray(q), k_all, v_all,
                            jnp.asarray(q_start + lens),
                            jnp.asarray(q_start), **extras)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_attention_fresh_any_t_matches_xla(case):
    """T = 13 (not a multiple of the page size) and unaligned starts,
    against the XLA overlay + mha_prefill reference."""
    rng = np.random.default_rng(52)
    B, T, Hq, Hkv, D = 4, 13, 8, 2, 16
    kp, vp, q, kf, vf, pt = _prefill_inputs(rng, B, T, Hq, Hkv, D)
    q_start = np.array([0, 21, 5, 30], np.int32)
    lens = np.array([13, 9, 1, 13], np.int32)
    jx, tx = _extras(rng, Hq, case)
    want = _xla_fresh(q, kf, vf, kp[1], vp[1], pt, q_start, lens, jx)
    got = paged_prefill_attention_fresh(
        _t(q), _t(kf), _t(vf), _t(kp), _t(vp), _t(pt), _t(q_start),
        _t(lens), 1, **tx).numpy()
    _valid_rows_close(got, want, lens)


def test_overlay_fresh_kv_matches_jax_inside_the_view():
    """Where the window fits the gathered view, the port's overlay is
    JAX's on the view's S positions (the T positions it appends are
    zero); where it runs past the end, JAX's clamps the window back
    inside while the port's keeps every fresh row at its position."""
    from xllm_service_tpu_torch.ops import attention as tatt
    rng = np.random.default_rng(54)
    B, S, T, H, D = 3, 24, 8, 2, 4
    k_all, k_fresh = _f32(rng, B, S, H, D), _f32(rng, B, T, H, D)
    start = np.array([0, 5, 16], np.int32)
    want = jatt.overlay_fresh_kv(jnp.asarray(k_all), jnp.asarray(k_fresh),
                                 jnp.asarray(start))
    got = tatt.overlay_fresh_kv(_t(k_all), _t(k_fresh), _t(start)).numpy()
    assert got.shape == (B, S + T, H, D)
    np.testing.assert_array_equal(got[:, :S], np.asarray(want))
    assert not got[:, S:].any()
    start = np.array([0, 20, 24], np.int32)        # rows 1, 2 run past S
    got = tatt.overlay_fresh_kv(_t(k_all), _t(k_fresh), _t(start)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b, start[b]:start[b] + T],
                                      k_fresh[b])
        np.testing.assert_array_equal(got[b, :start[b]], k_all[b, :start[b]])


def test_prefill_attention_fresh_ignores_the_window_slots():
    rng = np.random.default_rng(53)
    B, T, Hq, Hkv, D = 2, 8, 4, 2, 16
    kp, vp, q, kf, vf, pt = _prefill_inputs(rng, B, T, Hq, Hkv, D, L=1)
    q_start = np.array([8, 3], np.int32)
    lens = np.array([8, 6], np.int32)

    def run(k, v):
        return paged_prefill_attention_fresh(
            _t(q), _t(kf), _t(vf), _t(k), _t(v), _t(pt), _t(q_start),
            _t(lens), 0).numpy()
    base = run(kp, vp)
    stale_k, stale_v = kp.copy(), vp.copy()
    # Row 0's window is page 2 of its table (positions 8-15); row 1's
    # spans positions 3-8 (pages 1-2 of its table, ids 7 and 8).
    stale_k[0, pt[0, 1]] = 50.0
    stale_v[0, pt[0, 1]] = -50.0
    stale_k[0, pt[1, 0], 3:] = 50.0
    stale_k[0, pt[1, 1], :1] = 50.0
    np.testing.assert_array_equal(run(stale_k, stale_v), base)


# ---------------------------------------------------------------------------
# Wrapper checks
# ---------------------------------------------------------------------------

def test_new_wrappers_reject_bad_arguments():
    rng = np.random.default_rng(3)
    kp, vp = _t(_f32(rng, 2, 8, 4, 2, 16)), _t(_f32(rng, 2, 8, 4, 2, 16))
    pt = torch.ones(2, 3, dtype=torch.int32)
    i32 = torch.zeros(2, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    rows = torch.zeros(2, 2, 2, 16)
    bad_calls = [
        # all-layer decode writer: fresh rows must lead with L
        lambda: paged_kv_update(kp, vp, torch.zeros(3, 2, 2, 16),
                                torch.zeros(3, 2, 2, 16), pt, i32, act),
        # active must be bool
        lambda: paged_kv_update(kp, vp, rows, rows, pt, i32, i32),
        # prefill writer: a non-contiguous window
        lambda: paged_prefill_kv_update(
            kp, vp, torch.zeros(2, 2, 16, 4, 2).transpose(3, 4).transpose(
                2, 3), torch.zeros(2, 2, 4, 2, 16), pt, i32, i32),
        # prefill writer: lengths int64
        lambda: paged_prefill_kv_update(
            kp, vp, torch.zeros(2, 2, 4, 2, 16), torch.zeros(2, 2, 4, 2, 16),
            pt, i32, torch.zeros(2, dtype=torch.int64)),
        # K3': k_cur of the wrong shape
        lambda: paged_decode_attention_current(
            torch.zeros(2, 4, 16), kp, vp, pt, i32, torch.zeros(2, 4, 16),
            torch.zeros(2, 4, 16), 0),
        # K3': k_cur of another dtype
        lambda: paged_decode_attention_current(
            torch.zeros(2, 4, 16), kp, vp, pt, i32,
            torch.zeros(2, 2, 16, dtype=torch.float64),
            torch.zeros(2, 2, 16), 0),
        # K3': layer out of range
        lambda: paged_decode_attention_current(
            torch.zeros(2, 4, 16), kp, vp, pt, i32, torch.zeros(2, 2, 16),
            torch.zeros(2, 2, 16), 2),
        # K4': fresh rows of another T
        lambda: paged_prefill_attention_fresh(
            torch.zeros(2, 4, 4, 16), torch.zeros(2, 3, 2, 16),
            torch.zeros(2, 3, 2, 16), kp, vp, pt, i32, i32, 0),
        # K4': sinks must be float32 [Hq]
        lambda: paged_prefill_attention_fresh(
            torch.zeros(2, 4, 4, 16), torch.zeros(2, 4, 2, 16),
            torch.zeros(2, 4, 2, 16), kp, vp, pt, i32, i32, 0,
            sinks=torch.zeros(3)),
    ]
    for call in bad_calls:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# The forwards on six families
# ---------------------------------------------------------------------------

FAMILIES = {
    "llama": {},
    "qwen2": {"attention_bias": True},
    "qwen3": {"qk_norm": True},
    "gemma2": {"gemma": True, "sliding_window": 6,
               "layer_sliding": (True, False),
               "attn_logit_softcapping": 30.0,
               "final_logit_softcapping": 20.0,
               "query_pre_attn_scalar": 32, "tie_word_embeddings": True},
    "mistral": {"sliding_window": 9},
    "llama3_rope": {"rope_scaling": ("llama3", 8.0, 1.0, 4.0, 64),
                    "tie_word_embeddings": True},
}


def _setup(family):
    kw = dict(FAMILIES[family], dtype="float32")
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=96), **kw)
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=96), **kw)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **MODEL_TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_attend_then_write_matches_jax(family):
    """Two prefill windows (the second at q_start > 0, unaligned on one
    row), then two decode steps, one row inactive on the second: JAX's
    attend-then-write forwards, the port's, and the port's other order
    on a copy of the pools all agree, logits (all rows) and pools."""
    jcfg, tcfg, jparams, tparams = _setup(family)
    rng = np.random.default_rng(0)
    P, ps, B, MP = 24, 8, 2, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    wkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")     # write-then-attend
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompt = rng.integers(3, 96, size=(B, 27)).astype(np.int32)
    lens = np.array([27, 19], np.int32)
    tpt = torch.from_numpy(pt)
    for start, T in ((0, 16), (16, 16)):
        win = np.zeros((B, T), np.int32)
        n = np.clip(lens - start, 0, T).astype(np.int32)
        for b in range(B):
            win[b, :n[b]] = prompt[b, start:start + n[b]]
        st = np.full((B,), start, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(win), jnp.asarray(st),
            jnp.asarray(n), jkv, jnp.asarray(pt), write_then_attend=False)
        args = (torch.from_numpy(win).long(), torch.from_numpy(st),
                torch.from_numpy(n))
        tl, tkv = ttf.forward_prefill(tparams, tcfg, *args, tkv, tpt,
                                      write_then_attend=False)
        wl, wkv = ttf.forward_prefill(tparams, tcfg, *args, wkv, tpt)
        _close(tl, jl)
        _close(tl, wl)
    for i in (0, 1):
        _close(tkv[i], jkv[i])
        _close(tkv[i], wkv[i])
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    pos = lens.copy()
    for active in (np.array([1, 1], bool), np.array([1, 0], bool)):
        jl, jkv = jtf.forward_decode(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jkv, jnp.asarray(pt),
            write_then_attend=False)
        args = (torch.from_numpy(tok).long(), torch.from_numpy(pos),
                torch.from_numpy(active))
        tl, tkv = ttf.forward_decode(tparams, tcfg, *args, tkv, tpt,
                                     write_then_attend=False)
        wl, wkv = ttf.forward_decode(tparams, tcfg, *args, wkv, tpt)
        # Every row: an inactive row attends to its current token in
        # both packages.
        _close(tl, jl)
        _close(tl[torch.from_numpy(active)], wl[torch.from_numpy(active)])
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    for i in (0, 1):
        _close(tkv[i], jkv[i])
        _close(tkv[i], wkv[i])


def test_ragged_requires_write_then_attend():
    _, tcfg, _, tparams = _setup("llama")
    kv = ttf.init_kv_cache(tcfg, 8, 8, "cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="write_then_attend"):
        ttf.forward_prefill(tparams, tcfg, torch.ones(1, 4, dtype=torch.long),
                            one, one, kv, torch.ones(1, 2, dtype=torch.int32),
                            ragged=True, write_then_attend=False)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

VOCAB = 128
ENGINE_KW = dict(page_size=8, num_pages=160, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))
STAGGERED = {1: [(8, 12)], 3: [(11, 10)]}
# More prompts than slots, one longer than the largest bucket (chunked).
CROWDED = {1: [(9, 14), (5, 6)], 2: [(70, 8), (17, 9)], 4: [(32, 7), (12, 5)]}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    jparams = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW)).params
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _feed(workload, seed=0):
    rng = np.random.default_rng(seed)
    feed, i = {}, 0
    for step, reqs in sorted(workload.items()):
        for n, max_tokens in reqs:
            feed.setdefault(step, []).append(
                (f"r{i}", rng.integers(3, VOCAB, size=n).tolist(),
                 max_tokens))
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


def _run_port(weights, workload, **kw):
    _, tcfg, _, tparams = weights
    engine = Engine(tcfg, EngineConfig(
        **{**ENGINE_KW, "enable_prefix_cache": False, **kw}),
        params=tparams, device="cpu")
    return _drive(engine, _feed(workload), EngineRequest, SamplingParams), \
        engine


def _run_jax(weights, workload, **kw):
    jcfg, _, jparams, _ = weights
    engine = JaxEngine(jcfg, JaxEngineConfig(
        **{**ENGINE_KW, **kw}, decode_steps=1, enable_prefix_cache=False),
        params=jparams)
    assert engine.write_then_attend == kw.get("write_then_attend", False)
    return _drive(engine, _feed(workload), JaxRequest, JaxSampling)


@pytest.mark.parametrize("workload", [STAGGERED, CROWDED],
                         ids=["staggered", "crowded"])
def test_engine_attend_then_write_matches_jax(weights, workload):
    jst, jled = _run_jax(weights, workload, write_then_attend=False)
    (tst, tled), engine = _run_port(weights, workload,
                                    write_then_attend=False)
    assert engine.write_then_attend is False
    assert tst == jst
    assert tled == jled
    assert len(tst) == sum(len(v) for v in _feed(workload).values())
    # The port's other order gives the same streams.
    (wst, wled), engine = _run_port(weights, workload,
                                    write_then_attend=True)
    assert engine.write_then_attend is True
    assert wst == tst and wled == tled


def test_engine_ragged_stays_write_then_attend(weights):
    """With the ragged step on and attend-then-write chosen, mixed
    iterations still go ragged (write-then-attend), as in JAX."""
    kw = dict(write_then_attend=False, ragged_attn=True)
    jst, jled = _run_jax(weights, STAGGERED, **kw)
    (tst, tled), engine = _run_port(weights, STAGGERED, **kw)
    assert tst == jst
    assert tled == jled
    assert engine.ragged and not engine.write_then_attend
    assert engine.ragged_steps >= 1


def test_write_then_attend_resolution(monkeypatch):
    monkeypatch.delenv("XLLM_WRITE_THEN_ATTEND", raising=False)
    assert EngineConfig(**ENGINE_KW).write_then_attend is None
    assert EngineConfig(**ENGINE_KW,
                        write_then_attend=False).write_then_attend is False
    monkeypatch.setenv("XLLM_WRITE_THEN_ATTEND", "0")
    assert EngineConfig(**ENGINE_KW,
                        write_then_attend=True).write_then_attend is False
    monkeypatch.setenv("XLLM_WRITE_THEN_ATTEND", "1")
    assert EngineConfig(**ENGINE_KW).write_then_attend is True
    monkeypatch.delenv("XLLM_WRITE_THEN_ATTEND")
    # None: on where the CUDA kernels run, off on the CPU.
    assert resolve_write_then_attend(None, torch.device("cuda")) is True
    assert resolve_write_then_attend(None, torch.device("cpu")) is False
    assert resolve_write_then_attend(False, torch.device("cuda")) is False
    assert resolve_write_then_attend(True, torch.device("cpu")) is True
    engine = Engine(ModelConfig.tiny(vocab_size=VOCAB),
                    EngineConfig(**ENGINE_KW), device="cpu")
    assert engine.write_then_attend is False
