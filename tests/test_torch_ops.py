"""The PyTorch port's plain ops against the JAX package's, on the CPU in
float32: the same numpy inputs go through both.

Tolerance: atol = rtol = 1e-5 (float32 on the CPU; the two frameworks
sum in different orders). The KV writers move values without
arithmetic and must agree exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops import norm as jnorm
from xllm_service_tpu.ops import rope as jrope
from xllm_service_tpu.ops import sampling as jsamp
from xllm_service_tpu_torch.ops import attention as tatt
from xllm_service_tpu_torch.ops import norm as tnorm
from xllm_service_tpu_torch.ops import rope as trope
from xllm_service_tpu_torch.ops import sampling as tsamp
from xllm_service_tpu_torch.utils.types import SamplingParams

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _f32(rng, 3, 5, 64), _f32(rng, 64)
    _close(tnorm.rms_norm(_t(x), _t(w), 1e-6),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("scaling", [
    None,
    ("llama3", 32.0, 1.0, 4.0, 8192),
    ("linear", 8.0, 0.0, 0.0, 0),
])
def test_rope(scaling):
    rng = np.random.default_rng(1)
    x = _f32(rng, 2, 7, 4, 64)
    pos = rng.integers(0, 20000, size=(2, 7)).astype(np.int32)
    _close(trope.rope_inv_freq(64, 500000.0, scaling),
           jrope.rope_inv_freq(64, 500000.0, scaling))
    # Positions up to 2e4 give angles of ~1e4 rad: float32 argument
    # reduction in sin/cos differs by ~1e-4 between the two libraries.
    _close(trope.rope_for(scaling, _t(x), _t(pos), 500000.0),
           jrope.rope_for(scaling, jnp.asarray(x), jnp.asarray(pos),
                          500000.0), atol=2e-3, rtol=1e-5)
    small = (pos % 512).astype(np.int32)
    _close(trope.apply_rope(_t(x), _t(small), 10000.0, scaling),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(small), 10000.0,
                            scaling))


def test_flat_kv_index_drops():
    pt = np.array([[3, 4, 0], [0, 0, 0], [7, 8, 9]], np.int32)
    pos = np.array([[0, 9, 17], [1, 2, 3], [5, 23, 24]], np.int32)
    valid = np.array([[1, 1, 1], [1, 1, 1], [1, 0, 1]], bool)
    got = tatt._flat_kv_index(_t(pt), _t(pos).long(), 8, 80, _t(valid))
    want = jatt._flat_kv_index(jnp.asarray(pt), jnp.asarray(pos), 8, 80,
                               jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # NULL page (row 0 pos 17, row 1), invalid (row 2 pos 23) and past
    # the table (row 2 pos 24) all map to the sentinel.
    assert got[0, 2] == got[1, 0] == got[2, 1] == got[2, 2] == 80


def _pools(rng, L=3, P=24, ps=8, Hkv=2, D=16):
    return _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)


def test_decode_writer_matches_xla():
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    B, MP = 5, 3
    kn, vn = _f32(rng, B, 2, 16), _f32(rng, B, 2, 16)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[1, :] = 0                                    # NULL row
    pos = np.array([0, 5, 7, 13, 100], np.int32)    # 100: past the table
    act = np.array([1, 1, 0, 1, 1], bool)           # row 2 inactive
    for layer in range(3):
        want = jatt.write_decode_kv_layer_xla(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pt), jnp.asarray(pos),
            jnp.asarray(act), layer)
        tk, tv = _t(kp), _t(vp)
        got = tatt.write_decode_kv_layer(tk, tv, _t(kn), _t(vn), _t(pt),
                                         _t(pos), _t(act), layer)
        assert got[0] is tk                     # in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("start,lens", [
    ([0, 8, 0, 16], [16, 11, 16, 5]),      # page-aligned, ragged tails
    ([4, 21, 3, 7], [16, 9, 0, 14]),       # unaligned starts, empty row
    ([40, 0, 30, 2], [16, 16, 16, 16]),    # windows running off the table
])
def test_prefill_writer_matches_xla(start, lens):
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng)
    B, T, MP = 4, 16, 6
    kn, vn = _f32(rng, B, T, 2, 16), _f32(rng, B, T, 2, 16)
    pt = (1 + np.arange(B * MP).reshape(B, MP) % 23).astype(np.int32)
    pt[2, 1] = 0                                    # one NULL page
    start, lens = np.array(start, np.int32), np.array(lens, np.int32)
    want = jatt.write_prefill_kv_layer_xla(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pt), jnp.asarray(start), jnp.asarray(lens), 1)
    tk, tv = _t(kp), _t(vp)
    tatt.write_prefill_kv_layer(tk, tv, _t(kn), _t(vn), _t(pt), _t(start),
                                _t(lens), 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))


EXTRAS = [
    {},
    {"sliding_window": 5},
    {"logits_soft_cap": 20.0, "scale": 0.3},
    {"sinks": True},
]


def _extras(rng, Hq, extras):
    ex = dict(extras)
    if ex.pop("sinks", False):
        s = _f32(rng, Hq)
        return ({**ex, "sinks": jnp.asarray(s)}, {**ex, "sinks": _t(s)})
    return ex, ex


@pytest.mark.parametrize("extras", EXTRAS)
def test_mha_prefill(extras):
    rng = np.random.default_rng(4)
    B, T, S, Hq, Hkv, D = 2, 8, 24, 8, 2, 16
    q, k, v = _f32(rng, B, T, Hq, D), _f32(rng, B, S, Hkv, D), \
        _f32(rng, B, S, Hkv, D)
    q_start = np.array([0, 13], np.int32)
    kv_len = q_start + np.array([8, 5], np.int32)
    jx, tx = _extras(rng, Hq, extras)
    want = jatt.mha_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kv_len), jnp.asarray(q_start), **jx)
    got = tatt.mha_prefill(_t(q), _t(k), _t(v), _t(kv_len), _t(q_start),
                           **tx)
    _close(got, want)


@pytest.mark.parametrize("extras", EXTRAS)
def test_paged_decode_attention(extras):
    rng = np.random.default_rng(5)
    P, ps, Hkv, D, B, MP, Hq = 16, 8, 2, 16, 4, 3, 8
    kp, vp = _f32(rng, P, ps, Hkv, D), _f32(rng, P, ps, Hkv, D)
    q = _f32(rng, B, Hq, D)
    pt = rng.integers(1, P, size=(B, MP)).astype(np.int32)
    ctx = np.array([1, 9, 24, 0], np.int32)         # incl. an empty row
    jx, tx = _extras(rng, Hq, extras)
    want = jatt.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ctx), **jx)
    got = tatt.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                      _t(ctx), **tx)
    _close(got, want)


def test_gather_pages():
    rng = np.random.default_rng(6)
    pages = _f32(rng, 10, 4, 2, 8)
    pt = rng.integers(0, 10, size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tatt.gather_pages(_t(pages), _t(pt)).numpy(),
        np.asarray(jatt.gather_pages(jnp.asarray(pages), jnp.asarray(pt))))


def test_greedy_and_logprobs():
    rng = np.random.default_rng(7)
    logits = _f32(rng, 6, 300) * 4
    tok = tsamp.greedy(_t(logits))
    np.testing.assert_array_equal(
        tok.numpy(), np.asarray(jsamp.greedy(jnp.asarray(logits))))
    _close(tsamp.compute_logprobs(_t(logits), tok),
           jsamp.compute_logprobs(jnp.asarray(logits),
                                  jnp.asarray(tok.numpy(), jnp.int32)))


def test_sampling_filters_and_seeds():
    """top_k=1 and a tiny top_p reduce to greedy; a seeded row draws the
    same token whatever shares its batch (streams are not the JAX
    package's: it draws with threefry)."""
    rng = np.random.default_rng(8)
    logits = _t(_f32(rng, 4, 100) * 3)
    g = torch.Generator().manual_seed(0)
    greedy = tsamp.greedy(logits)
    params = [SamplingParams(temperature=1.0, top_k=1),
              SamplingParams(temperature=0.7, top_p=1e-6),
              SamplingParams(temperature=0.0),
              SamplingParams(temperature=1.0, top_k=1, top_p=0.5)]
    got = tsamp.sample_tokens(logits, params, g, positions=[0, 1, 2, 3])
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    seeded = SamplingParams(temperature=1.5, seed=1234)
    alone = tsamp.sample_tokens(logits[:1], [seeded], g, positions=[7])
    other = SamplingParams(temperature=1.5)
    mixed = tsamp.sample_tokens(logits[[1, 0]].contiguous(),
                                [other, seeded], g, positions=[3, 7])
    assert int(alone[0]) == int(mixed[1])
    draws = {int(tsamp.sample_tokens(logits[:1], [seeded], g,
                                     positions=[p])[0]) for p in range(40)}
    assert len(draws) > 1                       # the position reseeds
