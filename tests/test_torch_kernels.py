"""The port's kernel wrappers, on CPU tensors (so running each kernel's
plain version), against the JAX package's Pallas kernels run in
interpret mode on the same numpy inputs.

The CUDA kernels themselves build and run only on a GPU, where
``chip_smoke.py`` holds each against its plain version. Tolerance for
attention: atol = rtol = 1e-5 (float32, different summation order); the
KV writers must agree exactly. Attention rows that the kernels leave
unspecified or zero (context 0; query rows past a row's length) are not
compared."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops.pallas.kv_update import (
    paged_kv_update_layer as jax_kv_update_layer,
    paged_prefill_kv_update_layer as jax_prefill_kv_update_layer)
from xllm_service_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas)
from xllm_service_tpu.ops.pallas.prefill_attention import (
    paged_prefill_attention_pallas)
from xllm_service_tpu.ops.pallas.ragged_attention import (
    ragged_paged_attention_pallas)
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops.kernels import (
    paged_decode_attention, paged_kv_update_layer, paged_prefill_attention,
    paged_prefill_kv_update_layer, ragged_paged_attention)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


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


def test_decode_kv_writer_matches_pallas():
    rng = np.random.default_rng(11)
    L, P, ps, Hkv, D, B, MP = 3, 32, 8, 2, 64, 5, 4
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    kn, vn = _f32(rng, L, B, Hkv, D), _f32(rng, L, B, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[1, :] = 0                                    # NULL row
    pos = np.array([0, 5, 7, 13, 100], np.int32)    # 100: past the table
    act = np.array([1, 1, 0, 1, 1], bool)           # row 2 inactive
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = _t(kp), _t(vp)
    for li in range(L):
        jk, jv = jax_kv_update_layer(
            jk, jv, jnp.asarray(kn[li]), jnp.asarray(vn[li]),
            jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(act),
            jnp.int32(li), interpret=True)
        paged_kv_update_layer(tk, tv, _t(kn[li]), _t(vn[li]), _t(pt),
                              _t(pos), _t(act), li)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_prefill_kv_writer_matches_pallas_and_unaligned_xla():
    rng = np.random.default_rng(12)
    L, P, ps, Hkv, D, B, T, MP = 3, 32, 8, 2, 16, 4, 16, 6
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    kn, vn = _f32(rng, B, T, Hkv, D), _f32(rng, B, T, Hkv, D)
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    pt[2, :] = 0                                    # NULL row
    lens = np.array([16, 11, 16, 5], np.int32)      # ragged tails
    # Page-aligned starts: the Pallas kernel's domain.
    start = np.array([0, 8, 0, 40], np.int32)       # row 3 runs off table
    jk, jv = jax_prefill_kv_update_layer(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pt), jnp.asarray(start), jnp.asarray(lens),
        jnp.int32(1), interpret=True)
    tk, tv = _t(kp), _t(vp)
    paged_prefill_kv_update_layer(tk, tv, _t(kn), _t(vn), _t(pt), _t(start),
                                  _t(lens), 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # Unaligned starts, which the Pallas kernel cannot take: held to the
    # XLA scatter the JAX package falls back to there.
    start = np.array([4, 21, 3, 7], np.int32)
    jk, jv = jatt.write_prefill_kv_layer_xla(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pt), jnp.asarray(start), jnp.asarray(lens), 2)
    tk, tv = _t(kp), _t(vp)
    paged_prefill_kv_update_layer(tk, tv, _t(kn), _t(vn), _t(pt), _t(start),
                                  _t(lens), 2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _extras(rng, Hq, case):
    ex = dict(case)
    if ex.pop("sinks", False):
        s = _f32(rng, Hq)
        return {**ex, "sinks": jnp.asarray(s)}, {**ex, "sinks": _t(s)}
    return ex, ex


ATTN_CASES = [
    {},
    {"sliding_window": 6},
    {"logits_soft_cap": 25.0, "scale": 0.21},
    {"sinks": True, "sliding_window": 11},
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_decode_attention_matches_pallas(case):
    rng = np.random.default_rng(21)
    L, P, ps, Hkv, D, B, MP, Hq = 2, 16, 8, 2, 16, 4, 4, 8   # GQA G=4
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, Hq, D)
    pt = rng.integers(1, P, size=(B, MP)).astype(np.int32)
    ctx = np.array([1, 13, 32, 0], np.int32)        # row 3 inactive
    jx, tx = _extras(rng, Hq, case)
    for li in range(L):
        want = paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(ctx), interpret=True,
            layer=jnp.int32(li), **jx)
        got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(ctx),
                                     li, **tx)
        active = ctx > 0
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], **TOL)
        # Context-0 rows: zeros, as the Pallas kernel leaves them.
        assert not got.numpy()[~active].any()


@pytest.mark.parametrize("case", ATTN_CASES)
def test_prefill_attention_matches_pallas(case):
    rng = np.random.default_rng(22)
    L, P, ps, Hkv, D, B, T, MP, Hq = 2, 32, 8, 2, 16, 3, 16, 6, 8
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, T, Hq, D)
    # Disjoint tables; the pool already holds each row's window (the
    # write-then-attend order), cached prefix q_start > 0 on two rows.
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    q_start = np.array([0, 24, 8], np.int32)
    lens = np.array([16, 16, 5], np.int32)          # a ragged tail
    jx, tx = _extras(rng, Hq, case)
    for li in range(L):
        want = paged_prefill_attention_pallas(
            jnp.asarray(q), None, None, jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(q_start), jnp.asarray(lens),
            q_block=8, interpret=True, from_pool=True,
            layer=jnp.int32(li), **jx)
        got = paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                      _t(q_start), _t(lens), li, **tx)
        for b in range(B):
            n = int(lens[b])
            np.testing.assert_allclose(got.numpy()[b, :n],
                                       np.asarray(want)[b, :n], **TOL)
            assert not got.numpy()[b, n:].any()     # rows past the length


def _decode_args():
    rng = np.random.default_rng(0)
    return dict(q=_t(_f32(rng, 2, 4, 16)),
                k_pages=_t(_f32(rng, 2, 8, 4, 2, 16)),
                v_pages=_t(_f32(rng, 2, 8, 4, 2, 16)),
                page_table=torch.ones(2, 3, dtype=torch.int32),
                context_lens=torch.tensor([3, 5], dtype=torch.int32),
                layer=1)


@pytest.mark.parametrize("bad", [
    {"page_table": torch.ones(2, 3, dtype=torch.int64)},       # dtype
    {"context_lens": torch.tensor([3, 5, 1], dtype=torch.int32)},  # shape
    {"q": _t(np.zeros((4, 2, 16), np.float32)).transpose(0, 1)},  # strides
    {"layer": 2},                                                # range
    {"q": torch.zeros(2, 4, 16, dtype=torch.float64)},          # q dtype
])
def test_decode_attention_rejects_bad_arguments(bad):
    args = {**_decode_args(), **bad}
    with pytest.raises(ValueError):
        paged_decode_attention(**args)


def test_writers_and_prefill_reject_bad_arguments():
    rng = np.random.default_rng(1)
    kp, vp = _t(_f32(rng, 2, 8, 4, 2, 16)), _t(_f32(rng, 2, 8, 4, 2, 16))
    pt = torch.ones(2, 3, dtype=torch.int32)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):         # active must be bool
        paged_kv_update_layer(kp, vp, torch.zeros(2, 2, 16),
                              torch.zeros(2, 2, 16), pt, i32, i32, 0)
    with pytest.raises(ValueError):         # rows must match (Hkv, D)
        paged_prefill_kv_update_layer(kp, vp, torch.zeros(2, 4, 2, 8),
                                      torch.zeros(2, 4, 2, 8), pt, i32,
                                      i32, 0)
    with pytest.raises(ValueError):         # a non-contiguous pool
        paged_prefill_attention(torch.zeros(2, 4, 4, 16),
                                kp.transpose(1, 2), vp, pt, i32, i32, 0)
    with pytest.raises(ValueError):         # sinks must be float32 [Hq]
        paged_prefill_attention(torch.zeros(2, 4, 4, 16), kp, vp, pt, i32,
                                i32, 0, sinks=torch.zeros(3))


# Ragged batches: (T, q_start, lengths, page table or None for disjoint
# tables). Rows are prefill windows, length-1 decode rows starting
# mid-page, and length-0 padding rows.
RAGGED_BATCHES = {
    # A full window, a continuation at q_start=13, a decode row at 29,
    # a padding row.
    "mixed": (16, [0, 13, 29, 0], [16, 9, 1, 0], None),
    "decode_only": (1, [5, 0, 31, 47], [1, 1, 1, 1], None),
    # Spans that start and end mid-page, crossing page boundaries.
    "page_straddle": (12, [3, 7, 15, 21], [12, 9, 1, 10], None),
    # Tables padded with the NULL page past each row's own pages.
    "null_pages": (16, [0, 13, 7, 16], [9, 9, 1, 16],
                   [[3, 1, 0, 0, 0, 0], [5, 2, 7, 0, 0, 0],
                    [4, 0, 0, 0, 0, 0], [6, 8, 9, 10, 0, 0]]),
}


def _ragged_check(batch, case, Hq=8, Hkv=2, seed=23):
    rng = np.random.default_rng(seed)
    T, q_start, lens, table = RAGGED_BATCHES[batch]
    L, P, ps, D, MP = 2, 32, 8, 16, 6
    B = len(lens)
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, T, Hq, D)
    pt = (np.asarray(table, np.int32) if table is not None else
          (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32))
    q_start, lens = np.array(q_start, np.int32), np.array(lens, np.int32)
    jx, tx = _extras(rng, Hq, case)
    for li in range(L):
        want = np.asarray(ragged_paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(q_start), jnp.asarray(lens),
            interpret=True, layer=jnp.int32(li), **jx))
        got = ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                     _t(q_start), _t(lens), li, **tx).numpy()
        for b in range(B):
            n = int(lens[b])
            np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
            assert not got[b, n:].any()             # rows past the length
        assert np.isfinite(got).all() and np.isfinite(want).all()


@pytest.mark.parametrize("batch", sorted(RAGGED_BATCHES))
def test_ragged_attention_matches_pallas(batch):
    _ragged_check(batch, {})


@pytest.mark.parametrize("case", ATTN_CASES[1:])
def test_ragged_attention_model_deltas_match_pallas(case):
    _ragged_check("mixed", case)


@pytest.mark.parametrize("Hq,Hkv", [(8, 1), (4, 4)])
def test_ragged_attention_groups_match_pallas(Hq, Hkv):
    _ragged_check("mixed", {}, Hq=Hq, Hkv=Hkv)


def test_ragged_attention_rejects_bad_arguments():
    rng = np.random.default_rng(2)
    kp, vp = _t(_f32(rng, 2, 8, 4, 2, 16)), _t(_f32(rng, 2, 8, 4, 2, 16))
    q = torch.zeros(2, 4, 4, 16)
    pt = torch.ones(2, 3, dtype=torch.int32)
    i32 = torch.zeros(2, dtype=torch.int32)
    bad = [
        dict(lengths=torch.zeros(2, dtype=torch.int64)),        # dtype
        dict(q_start=torch.zeros(3, dtype=torch.int32)),        # shape
        dict(q=torch.zeros(2, 4, 16, 4).transpose(2, 3)),       # strides
        dict(q=torch.zeros(2, 4, 3, 16)),                        # Hq % Hkv
        dict(layer=2),                                           # range
        dict(sinks=torch.zeros(4, dtype=torch.float64)),        # sinks
    ]
    for kw in bad:
        args = dict(q=q, k_pages=kp, v_pages=vp, page_table=pt, q_start=i32,
                    lengths=i32, layer=0)
        sinks = kw.pop("sinks", None)
        args.update(kw)
        with pytest.raises(ValueError):
            ragged_paged_attention(**args, sinks=sinks)
