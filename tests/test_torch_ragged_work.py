"""The ragged kernel's (K5) design on the CPU: its arithmetic in plain
PyTorch against the JAX package, and its work list.

The CUDA kernel (``csrc/ragged_paged_attention.cu``) runs each window
row's query tiles through the prefill tile code and each decode row
(length 1) through the decode kernels' split walk: the row's attended
keys in S shares of whole chunks, the splits' softmax states folded in
split order in the same launch, the sinks joining the denominator once
after the fold. ``ragged_paged_attention_plain`` does that arithmetic
(``split_partials`` / ``combine_partials`` on the decode rows); it is
held here to the Pallas kernel ``ragged_paged_attention_pallas`` in
interpret mode and to the XLA reference ``mha_prefill`` over the
gathered pages, on the same numpy inputs, float32, atol = rtol = 1e-5
(the split sums run in another order). Small chunks give several splits
at tiny contexts.

The work list is the one every block of the kernel builds from the row
lengths; ``ragged_work`` is that rule on the host: every valid (row,
position, kv head) is covered once, every padding position zeroed once,
no item is empty, and the heaviest items come first. Its sizes are read
from the kernel source, so the two stay one rule."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.ops.pallas.ragged_attention import (
    ragged_paged_attention_pallas)
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops.kernels import paged_attention as pa
from xllm_service_tpu_torch.ops.kernels import ragged_attention as ra
from xllm_service_tpu_torch.ops.kernels.prefill_attention import query_tile

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK = 8                      # small split units: several per decode row
SPLITS = [1, 2, 3, 8]
SRC = Path(ra.__file__).with_name("csrc") / "ragged_paged_attention.cu"
L, P, PS, MP, D, HKV, T = 2, 48, 8, 7, 16, 2, 12

# (q_start, lengths): rows are prefill windows, length-1 decode rows
# (mid-page) and length-0 padding rows; every context within the table's
# MP x PS = 56 keys.
BATCHES = {
    "decode_only": ([4, 29, 47, 0], [1, 1, 1, 1]),
    "window_only": ([0, 13, 0, 30], [12, 9, 0, 5]),
    "mixed": ([37, 5, 20, 30], [1, 12, 1, 7]),
    "padding_row": ([47, 3, 9, 16], [1, 0, 1, 12]),
}
CASES = {
    "plain": {},
    # 13 keys: a decode row's window starts mid-chunk and spans splits.
    "window": {"sliding_window": 13},
    "softcap": {"logits_soft_cap": 2.0, "scale": 0.9},
    "sinks": {"sinks": True},
}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    assert all(n == 0 for n in kernels.launch_counts().values())


def _inputs(batch, G, seed=31):
    rng = np.random.default_rng(seed)
    starts, lens = BATCHES[batch]
    B, Hq = len(lens), HKV * G
    pt = rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP)
    return dict(kp=_f32(rng, L, P, PS, HKV, D), vp=_f32(rng, L, P, PS, HKV, D),
                q=_f32(rng, B, T, Hq, D), pt=pt.astype(np.int32),
                q_start=np.array(starts, np.int32),
                lens=np.array(lens, np.int32),
                sinks=_f32(rng, Hq) + 1.5)


def _refs(x, layer, case):
    """(Pallas in interpret mode, XLA mha_prefill over gathered pages)."""
    kw = dict(case)
    sinks = jnp.asarray(x["sinks"]) if kw.pop("sinks", False) else None
    q, kp, vp, pt, qs, lens = (jnp.asarray(x[k]) for k in (
        "q", "kp", "vp", "pt", "q_start", "lens"))
    pallas = ragged_paged_attention_pallas(
        q, kp, vp, pt, qs, lens, interpret=True, layer=jnp.int32(layer),
        sinks=sinks, **kw)
    xla = jatt.mha_prefill(q, jatt.gather_pages(kp[layer], pt),
                           jatt.gather_pages(vp[layer], pt), qs + lens, qs,
                           sinks=sinks, **kw)
    return np.asarray(pallas), np.asarray(xla)


def _plain(x, layer, case, S):
    kw = dict(case)
    sinks = _t(x["sinks"]) if kw.pop("sinks", False) else None
    return ra.ragged_paged_attention_plain(
        *(_t(x[k]) for k in ("q", "kp", "vp", "pt", "q_start", "lens")),
        layer, sinks=sinks, num_splits=S, chunk=CHUNK, **kw).numpy()


def _check(x, case, S):
    lens = x["lens"]
    for layer in range(L):
        pallas, xla = _refs(x, layer, case)
        got = _plain(x, layer, case, S)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], pallas[b, :n], **TOL)
            np.testing.assert_allclose(got[b, :n], xla[b, :n], **TOL)
            assert not got[b, n:].any()             # padding rows: zeros


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_split_decode_rows_match_jax(batch, S):
    _check(_inputs(batch, G=4), {}, S)


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", ["window", "softcap", "sinks"])
def test_split_decode_rows_match_jax_model_deltas(case, S):
    x = _inputs("mixed", G=4)
    _check(x, CASES[case], S)
    if case == "sinks" and S > 1:
        # The sinks joined once although decode rows span several
        # splits: row 0 (38 keys) holds 5 chunks of 8.
        bounds = pa.split_bounds(0, 38, S, CHUNK)
        assert sum(a < b for a, b in bounds) >= 2


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_split_decode_rows_match_jax_groups(G, S):
    _check(_inputs("mixed", G=G, seed=32 + G), CASES["window"], S)


def test_kernel_split_count_is_the_decode_kernels():
    """Without ``num_splits`` the plain version takes gqa_splits, as the
    wrapper does, on host-known sizes only."""
    x = _inputs("mixed", G=4)
    S = pa.gqa_splits(4, HKV, MP, PS, 0, False)
    args = [_t(x[k]) for k in ("q", "kp", "vp", "pt", "q_start", "lens")]
    got = ra.ragged_paged_attention_plain(*args, 1, chunk=CHUNK).numpy()
    np.testing.assert_array_equal(got, _plain(x, 1, {}, S))


# ---------------------------------------------------------------------------
# The work list
# ---------------------------------------------------------------------------

def _source_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC.read_text())
    assert m, name
    return int(eval(m.group(1), {"kSplitThreads": 128}))


def test_host_rule_shares_the_kernels_sizes():
    assert ra.ZERO_VECS == _source_int("kZeroVecs")
    assert ra._MAX_ROWS == _source_int("kMaxRows")
    assert ra._MAX_RANKS == _source_int("kMaxRanks")
    assert "return D <= 128 ? kGroups : 1;" in SRC.read_text()
    assert [ra.split_groups(d) for d in (64, 128, 256)] == [2, 2, 1]
    assert pa.GQA_CHUNK == int(re.search(
        r"constexpr int kChunk = (\d+);",
        SRC.with_name("decode_row.cuh").read_text()).group(1))


WORK = {
    # The smoke mix: 7 decode rows beside a 256-token window, T = 256.
    "serving_mix": ([116, 204, 297, 410, 149, 260, 332, 128],
                    [1] * 7 + [256], 256, 32, 8, 64, 8, 128, 0),
    "mixed_windows": ([0, 700, 5, 1500, 37], [300, 129, 1, 2, 0], 512, 32,
                      8, 64, 16, 128, 0),
    "sliding_window": ([900, 0, 4000, 1000], [1, 64, 1, 200], 256, 24, 8,
                       128, 40, 128, 300),
    "groups_of_8": ([3, 60, 0], [1, 90, 45], 96, 64, 8, 64, 4, 64, 0),
    "head_dim_256": ([9, 300, 0], [1, 1, 40], 64, 8, 2, 256, 8, 64, 0),
    "empty": ([0, 0], [0, 0], 16, 8, 2, 64, 2, 16, 0),
}


def _work(case, splits=None):
    starts, lens, T_, Hq, Hkv, D_, MP_, ps, W = WORK[case]
    S = splits or pa.gqa_splits(len(lens), Hkv, MP_, ps, W, False)
    return ra.ragged_work(starts, lens, T_, Hq, Hkv, D_, MP_, ps, W, S), S


def _tile_keys(starts, lens, QB, MP_, ps, W, item):
    b, _, t0, nt = item
    q_lo = starts[b] + t0
    lo = max(0, q_lo - W + 1) if W > 0 else 0
    return min(q_lo + nt - 1, MP_ * ps - 1) - lo + 1


@pytest.mark.parametrize("S", [None, 1, 3])
@pytest.mark.parametrize("case", sorted(WORK))
def test_work_covers_every_output_once(case, S):
    """Each 16-byte vector of the [B, T, Hq, D] output is written by
    exactly one item: a window tile (its valid rows and the rows of its
    last tile past the length, for the G heads of its kv head), a decode
    row's splits (position 0 of the kv head's heads, whose key ranges
    partition the attended range), or a zero range."""
    work, S = _work(case, S)
    starts, lens, T_, Hq, Hkv, D_, MP_, ps, W = WORK[case]
    B, G, QB, hv = len(lens), Hq // Hkv, query_tile(Hq // Hkv), D_ // 8
    count = np.zeros(B * T_ * Hq * hv, np.int64)

    def heads(b, t, h):
        first = ((b * T_ + t) * Hq + h * G) * hv
        count[first:first + G * hv] += 1
    for b, h, t0, nt in work.windows:
        for t in range(t0, min(t0 + QB, T_)):
            heads(b, t, h)
    decode = {}
    for b, h, s, k_lo, k_hi in work.splits:
        decode.setdefault((b, h), []).append((s, k_lo, k_hi))
    for (b, h), parts in decode.items():
        assert [s for s, _, _ in parts] == list(range(len(parts)))
        ctx = min(starts[b] + 1, MP_ * ps)
        lo = max(0, starts[b] + 1 - W) if W > 0 else 0
        keys = [k for _, a, e in parts for k in range(a, e)]
        assert keys == list(range(min(lo, ctx), ctx))
        heads(b, 0, h)
    assert sorted(decode) == [(b, h) for b, n in enumerate(lens) if n == 1
                              for h in range(Hkv)]
    for b, first, end in work.zeros:
        count[first:end] += 1
        assert first // (T_ * Hq * hv) == b == (end - 1) // (T_ * Hq * hv)
    assert (count == 1).all()


@pytest.mark.parametrize("case", sorted(WORK))
def test_work_items_are_never_empty(case):
    work, _ = _work(case)
    starts, lens, T_, Hq, Hkv, D_, MP_, ps, W = WORK[case]
    assert all(nt >= 1 for *_, nt in work.windows)
    assert all(k_lo < k_hi for *_, k_lo, k_hi in work.splits)
    assert all(first < end for _, first, end in work.zeros)
    assert all(n > 1 for n in (lens[b] for b, *_ in work.windows))
    QB = query_tile(Hq // Hkv)
    assert all(_tile_keys(starts, lens, QB, MP_, ps, W, it) >= 1
               for it in work.windows)


@pytest.mark.parametrize("case", sorted(WORK))
def test_work_comes_heaviest_first(case):
    """The window tiles come before the decode splits, which come before
    the zeros (the list's fields, in the kernel's order). Among the
    tiles, each row's come from its last (the latest causal limit:
    without a sliding window, the most keys) down, and every row's k-th
    tile from its last before any row's (k+1)-th; the kv head is the
    fastest index."""
    work, _ = _work(case)
    starts, lens, T_, Hq, Hkv, D_, MP_, ps, W = WORK[case]
    QB = query_tile(Hq // Hkv)
    seen, ranks = {}, []
    for i in range(0, len(work.windows), Hkv):
        group = work.windows[i:i + Hkv]
        assert [h for _, h, _, _ in group] == list(range(Hkv))
        assert len({(b, t0) for b, _, t0, _ in group}) == 1
        b, _, t0, _ = group[0]
        keys = _tile_keys(starts, lens, QB, MP_, ps, W, group[0])
        prev = seen.get(b)
        assert prev is None or t0 < prev[0]
        assert prev is None or W > 0 or keys <= prev[1]
        seen[b] = (t0, keys)
        n_tiles = -(-lens[b] // QB)
        ranks.append(n_tiles - 1 - t0 // QB)
    assert ranks == sorted(ranks)


def test_serving_mix_work_list():
    """The smoke mix: 8 window tiles x 8 kv heads, each decode row's live
    splits (one 128-key unit each at S = 8) x 8 kv heads, and the
    padding as 16 KB ranges: 1,785 padding positions of 4 KB."""
    work, S = _work("serving_mix")
    assert S == 8
    assert len(work.windows) == 64
    assert len(work.splits) == 8 * sum(-(-(s + 1) // 128) for s in
                                       [116, 204, 297, 410, 149, 260, 332])
    assert sum(e - f for _, f, e in work.zeros) * 16 == 1785 * 32 * 64 * 2


def _live_blocks_by_the_kernels_loops(work, grid, D):
    """The blocks with an item, walking each block's loops as the kernel
    does (ragged_paged_attention.cu steps 2 and 3)."""
    groups = ra.split_groups(D)
    sw = 2 // groups                        # units a split takes
    n_win = len(work.windows)
    split0 = 2 * n_win
    zero0 = split0 + sw * len(work.splits)
    units = zero0 + len(work.zeros)
    rest0 = n_win if n_win < grid else 0
    live = 0
    for blk in range(grid):
        busy = blk < n_win
        if blk >= rest0:
            pair = blk - rest0
            while split0 + 2 * pair < units:
                for grp in range(2):
                    u = split0 + 2 * pair + grp
                    if u < units and (u >= zero0 or (u - split0) % sw == 0):
                        busy = True
                pair += grid - rest0
        live += busy
    return live


@pytest.mark.parametrize("grid", [1, 5, 64, 100, 264, 1000])
@pytest.mark.parametrize("case", sorted(WORK))
def test_live_blocks_follow_the_kernels_rule(case, grid):
    """``RaggedWork.live_blocks`` against the kernel's loops, also where
    there are more window items than blocks, and at D = 256, where a
    split takes a whole block."""
    work, _ = _work(case)
    D_ = WORK[case][5]
    got = work.live_blocks(grid, D_)
    assert got == _live_blocks_by_the_kernels_loops(work, grid, D_)
    assert got <= grid
    if len(work.windows) >= grid:
        assert got == grid


@pytest.mark.parametrize("B, T, G, ok", [
    (256, 2048, 4, True), (512, 256, 4, False), (8, 16384, 4, True),
    (8, 16385, 4, False), (8, 256, 16, True), (8, 256, 32, False)])
def test_bucket_sizes_the_kernel_holds(B, T, G, ok):
    """At most 256 rows, 512 query tiles a row and a group of 16."""
    if ok:
        ra.check_sizes(B, T, G)
    else:
        with pytest.raises(ValueError):
            ra.check_sizes(B, T, G)


@pytest.mark.parametrize("max_batch_size, ok", [(256, True), (257, False)])
def test_engine_refuses_a_ragged_bucket_too_large_at_start(max_batch_size,
                                                          ok):
    """With the ragged step on, an engine whose largest bucket the
    kernel cannot hold (257 slots pad to 512 rows) is refused when it is
    built, not at its first mixed iteration; with it off, it is built."""
    from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
    from xllm_service_tpu_torch.runtime.engine import Engine
    cfg = ModelConfig.tiny()
    build = lambda ragged: Engine(  # noqa: E731
        cfg, EngineConfig(max_batch_size=max_batch_size, num_pages=16,
                          page_size=8, ragged_attn=ragged), device="cpu")
    build(False)
    if ok:
        assert build(True).ragged
    else:
        with pytest.raises(ValueError, match="rows"):
            build(True)
