"""The split-KV arithmetic of the decode kernels (K3, K3', K3''), in its
plain PyTorch version, against the JAX package: the XLA references
``ops/attention.py`` ``paged_decode_attention`` and
``paged_decode_attention_current``, and the Pallas kernel
``paged_decode_attention_pallas`` in interpret mode, on the same numpy
inputs.

The CUDA kernels split each row's attended keys into S shares of whole
chunks, write each split's softmax state (m, l, unnormalised O) and fold
the states in split order in the launch's last block; only then do the
sinks join the denominator. ``split_partials`` / ``combine_partials`` do
the same arithmetic on the CPU, which is the only place where the
combine's semantics can be pinned without a card: empty splits, windows
that cut across splits, soft-cap per logit, sinks counted once, context
0 (zeros) and the current key (last split; a row with cache length 0
attends to it alone). Tolerance: float32, atol = rtol = 1e-5 (the split
sums run in another order than the references')."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas)
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops.kernels import paged_attention as pa
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK = 8                      # small chunks: several per row at tiny size
SPLITS = [1, 2, 3, 8]


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launch_counts().values())


def _inputs(seed, Hq, Hkv, D, current):
    """Two layers of pools (page size 8, 6 pages a row) and four rows:
    one of context 0 (cache length 0 in the current form), one within a
    chunk, two across several chunks; stale random rows everywhere the
    current key would sit."""
    rng = np.random.default_rng(seed)
    L, P, ps, MP, B = 2, 32, 8, 6, 4
    kp, vp = _f32(rng, L, P, ps, Hkv, D), _f32(rng, L, P, ps, Hkv, D)
    q = _f32(rng, B, Hq, D)
    pt = rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP)
    lens = np.array([0, 5, 29, 47], np.int32)
    kc, vc = (_f32(rng, B, Hkv, D), _f32(rng, B, Hkv, D)) if current \
        else (None, None)
    sinks = _f32(rng, Hq) + 1.5        # large enough to weigh in
    return dict(kp=kp, vp=vp, q=q, pt=pt.astype(np.int32), lens=lens,
                kc=kc, vc=vc, sinks=sinks)


def _jax_refs(x, layer, case):
    """(Pallas in interpret mode, XLA reference) on layer ``layer``."""
    kw = dict(case)
    sinks = jnp.asarray(x["sinks"]) if kw.pop("sinks", False) else None
    args = [jnp.asarray(x[k]) for k in ("q", "kp", "vp", "pt", "lens")]
    cur = {} if x["kc"] is None else dict(k_cur=jnp.asarray(x["kc"]),
                                          v_cur=jnp.asarray(x["vc"]))
    pallas = paged_decode_attention_pallas(
        *args, interpret=True, layer=jnp.int32(layer), sinks=sinks, **cur,
        **kw)
    pools = [args[0], args[1][layer], args[2][layer], args[3], args[4]]
    if x["kc"] is None:
        xla = jatt.paged_decode_attention(*pools, sinks=sinks, **kw)
    else:
        xla = jatt.paged_decode_attention_current(
            *pools, cur["k_cur"], cur["v_cur"], sinks=sinks, **kw)
    return np.asarray(pallas), np.asarray(xla)


def _split(x, layer, S, case, chunk=CHUNK):
    kw = dict(case)
    sinks = _t(x["sinks"]) if kw.pop("sinks", False) else None
    cur = {} if x["kc"] is None else dict(k_cur=_t(x["kc"]),
                                          v_cur=_t(x["vc"]))
    return pa.paged_decode_attention_split_plain(
        _t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(x["pt"]), _t(x["lens"]),
        layer, S, chunk, sinks=sinks, **cur, **kw)


CASES = {
    "plain": {},
    # A 12-key window: [ctx - 12, ctx) starts mid-chunk and spans splits.
    "window": {"sliding_window": 12},
    "softcap": {"logits_soft_cap": 2.0, "scale": 0.9},
    "sinks": {"sinks": True},
    "sinks_window": {"sinks": True, "sliding_window": 20},
}


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
@pytest.mark.parametrize("form", ["pool", "current"])
def test_split_combine_matches_jax(form, case, S):
    x = _inputs(5, Hq=8, Hkv=2, D=16, current=form == "current")
    for layer in (0, 1):
        pallas, xla = _jax_refs(x, layer, CASES[case])
        got = _split(x, layer, S, CASES[case]).numpy()
        np.testing.assert_allclose(got, pallas, **TOL)
        active = x["lens"] > 0 if form == "pool" else slice(None)
        np.testing.assert_allclose(got[active], xla[active], **TOL)
    if form == "pool":
        # Context 0: every split empty, zeros (sinks or not), as the
        # Pallas kernel leaves the row.
        assert not got[0].any()
    elif not CASES[case].get("sinks"):
        # Cache length 0: the current key alone, whatever S.
        np.testing.assert_allclose(
            got[0], np.repeat(x["vc"][0], 4, axis=0), **TOL)


def _sinks_per_split(m, l, o, sinks):
    """The combine with the fault it must not have: each non-empty split
    folds the sinks into its own denominator."""
    sk = sinks[None, None].expand_as(m)
    m2 = torch.maximum(m, sk)
    corr = torch.where(l > 0, torch.exp(m - m2), torch.zeros(()))
    live = (l > 0).float()
    return pa.combine_partials(
        torch.where(l > 0, m2, m), l * corr + live * torch.exp(sk - m2),
        o * corr[..., None])


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("form", ["pool", "current"])
def test_sinks_join_the_denominator_once(form, S):
    x = _inputs(6, Hq=8, Hkv=2, D=16, current=form == "current")
    pallas, _ = _jax_refs(x, 1, {"sinks": True})
    args = [_t(x[k]) for k in ("q", "kp", "vp", "pt", "lens")]
    cur = {} if x["kc"] is None else dict(k_cur=_t(x["kc"]),
                                          v_cur=_t(x["vc"]))
    m, l, o = pa.split_partials(*args, 1, S, CHUNK, **cur)
    sinks = _t(x["sinks"])
    np.testing.assert_allclose(pa.combine_partials(m, l, o, sinks).numpy(),
                               pallas, **TOL)
    # Rows 2 and 3 span several splits: sinks counted per split are off.
    wrong = _sinks_per_split(m, l, o, sinks).numpy()
    assert (l[2:] > 0).sum(1).min() >= 2
    assert np.abs(wrong[2:] - pallas[2:]).max() > 1e-3


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("form", ["pool", "current"])
def test_mla_geometry_split_matches_pallas(monkeypatch, form, S):
    """One 576-wide latent head (Hkv = 1) as K and V of 16 query heads,
    64-key chunks as the MLA kernel takes them, contexts up to 3 chunks
    (so S = 8 leaves splits empty)."""
    monkeypatch.setenv("XLLM_PALLAS", "1")
    monkeypatch.setenv("XLLM_PALLAS_MLA", "1")
    rng = np.random.default_rng(44)
    L, P, ps, MP, B, Hq, D = 2, 49, 16, 12, 4, 16, 576
    pool = _f32(rng, L, P, ps, 1, D)
    q = _f32(rng, B, Hq, D)
    cur = _f32(rng, B, 1, D)
    pt = rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP)
    pt = pt.astype(np.int32)
    lens = np.array([0, 70, 191, 64], np.int32)
    scale = 0.137
    cur_j = {} if form == "pool" else dict(k_cur=jnp.asarray(cur),
                                           v_cur=jnp.asarray(cur))
    cur_t = {} if form == "pool" else dict(k_cur=_t(cur), v_cur=_t(cur))
    want = np.asarray(paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(pt), jnp.asarray(lens), interpret=True, scale=scale,
        layer=jnp.int32(1), **cur_j))
    got = pa.paged_decode_attention_split_plain(
        _t(q), _t(pool), _t(pool), _t(pt), _t(lens), 1, S, pa.MLA_CHUNK,
        scale=scale, **cur_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if form == "pool":
        assert not got[0].any()
    else:
        np.testing.assert_allclose(got[0], np.repeat(cur[0], Hq, axis=0),
                                   **TOL)


@pytest.mark.parametrize("lo,ctx,S", [(0, 0, 4), (0, 5, 3), (3, 47, 2),
                                      (0, 129, 8), (17, 200, 3)])
def test_split_bounds_cover_the_range_in_whole_chunks(lo, ctx, S):
    bounds = pa.split_bounds(lo, ctx, S, CHUNK)
    assert len(bounds) == S
    keys = [k for a, b in bounds for k in range(a, b)]
    assert keys == list(range(lo, ctx))
    live = [(a, b) for a, b in bounds if a < b]
    for a, b in live[:-1]:
        assert (b - a) % CHUNK == 0          # only the last may be short
    # Empty splits trail; the last key (CUR's current key) is in the last
    # non-empty split.
    assert bounds[:len(live)] == live
    if live:
        assert live[-1][1] == ctx


def test_split_count_rule():
    """decode_splits: blocks up to the target, at most one split per
    chunk of the longest context the page table allows."""
    gqa = dict(chunk=pa.GQA_CHUNK, target_blocks=pa.GQA_TARGET_BLOCKS)
    mla = dict(chunk=pa.MLA_CHUNK, target_blocks=pa.MLA_TARGET_BLOCKS)
    # llama3-1b, B = 8 x Hkv = 8: 528 / 64 -> 9 splits, capped at the 8
    # chunks of 8 pages of 128.
    assert pa.decode_splits(64, 1024, **gqa) == 8
    assert pa.decode_splits(64, 4096, **gqa) == 9
    assert pa.decode_splits(8, 4096, **gqa) == 32     # B = 1
    assert pa.decode_splits(528, 4096, **gqa) == 1    # the card is full
    assert pa.decode_splits(64, 100, **gqa) == 1      # one chunk
    # DeepSeek-V2-Lite, B = 8: 132 / 8 -> 17, capped at 16 chunks of 1024.
    assert pa.decode_splits(8, 1024, **mla) == 16
    assert pa.decode_splits(8, 4096, **mla) == 17
    assert pa.decode_splits(1, 4096, **mla) == 64
    # What the wrappers pass: the table's keys (plus the current one),
    # or the window's.
    assert pa.gqa_splits(8, 8, 8, 128, 0, False) == 8
    assert pa.gqa_splits(1, 8, 1, 128, 0, False) == 1
    assert pa.gqa_splits(1, 8, 1, 128, 0, True) == 2     # 129 keys
    assert pa.gqa_splits(1, 8, 32, 128, 300, False) == 3
    assert pa.mla_splits(8, 8, 128, False) == 16
    assert pa.mla_splits(8, 8, 128, True) == 17          # 1025 keys


@pytest.mark.parametrize("wrapper", ["gqa", "gqa_current", "mla",
                                     "mla_current"])
def test_wrappers_on_cpu_ignore_the_split_count(wrapper):
    """On CPU tensors a wrapper runs its plain version whatever
    ``num_splits`` says, and launches nothing."""
    x = _inputs(7, Hq=8, Hkv=2, D=16, current=True)
    q, kp, vp, pt, lens = (_t(x[k]) for k in ("q", "kp", "vp", "pt",
                                               "lens"))
    kc, vc = _t(x["kc"]), _t(x["vc"])
    lat, q1, c1 = (t.contiguous() for t in (kp[:, :, :, :1], q[:, :4],
                                            kc[:, :1]))
    call = {
        "gqa": lambda n: kernels.paged_decode_attention(
            q, kp, vp, pt, lens, 1, num_splits=n),
        "gqa_current": lambda n: kernels.paged_decode_attention_current(
            q, kp, vp, pt, lens, kc, vc, 1, num_splits=n),
        "mla": lambda n: kernels.paged_decode_attention_mla(
            q1, lat, pt, lens, 1, 0.3, num_splits=n),
        "mla_current": lambda n: kernels.paged_decode_attention_mla_current(
            q1, lat, pt, lens, c1, 1, 0.3, num_splits=n),
    }[wrapper]
    torch.testing.assert_close(call(None), call(3), rtol=0, atol=0)
