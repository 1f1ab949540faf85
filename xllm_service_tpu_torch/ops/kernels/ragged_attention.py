"""Ragged paged attention (CUDA kernel ``csrc/ragged_paged_attention.cu``).

Replaces the Pallas kernel ``ragged_paged_attention_pallas``
(xllm_service_tpu/ops/pallas/ragged_attention.py:191) in the form the
engine's one-launch ragged mixed step uses: layered pools, every row's
new K/V already in the pool. A row is a prefill window or a single
decode continuation (length 1 at q_start = context - 1, starting
mid-page as often as not); there is no T % page_size requirement.

As for the other attention kernels, the layer index in the Pallas
kernel's index map becomes ``k_pages[layer]``, a view of the full pool.

Bound on an H100 at the ragged serving mix: bytes by count (the live
keys' K/V, q and the whole output, padding rows included), and in time
the chains of the longest tiles. A fixed grid of persistent blocks walks
a work list that every block builds from the row lengths on the device
(``ragged_work`` is the same rule on the host): the window tiles by the
prefill kernel's tile code, the decode rows' splits by the decode
kernel's split walk (``paged_attention.gqa_splits`` splits, folded in the
same launch), then the padding zeros. No block is spent on a tile
without a valid query, and the grid depends on host-known sizes only.

The kernel's row table holds 256 rows of at most 512 query tiles. A
larger batch is cut into launches (``launch_plan``): rows in chunks of
at most 256, and a longer window into slices of at most 512 query
tiles, each slice a window of its own at a shifted start. Rows are
independent (each attends only to its own pages), and so are the query
positions of one window, because the step writes the window before it
attends. The cut depends on B, T and the group only, so the launches
stay shape-static; every launch takes the whole batch's split count.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, count_launch, on_cuda, ptr, raise_on_error, require, stream)
from xllm_service_tpu_torch.ops.kernels.paged_attention import (
    GQA_CHUNK, _split_scratch, gqa_splits, paged_decode_attention_split_plain,
    split_bounds)
from xllm_service_tpu_torch.ops.kernels.prefill_attention import (
    check_arguments, check_cuda_shapes, paged_prefill_attention_plain,
    query_tile)

_lib = None
_MAX_GROUP = 16          # the decode rows' split tile holds 16 heads
_MAX_ROWS = 256          # the kernel's row table (kMaxRows)
_MAX_RANKS = 512         # query tiles of a row (kMaxRanks)
ZERO_VECS = 8 * 128      # 16-byte zero stores of one work item (kZeroVecs)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("ragged_paged_attention")
        lib.ragged_paged_attention.argtypes = [P] * 11 + [I] * 10 + [F, F, P]
        lib.ragged_paged_attention.restype = I
        lib.ragged_paged_attention_blocks.argtypes = [I] * 7 + [P]
        lib.ragged_paged_attention_blocks.restype = I
        _lib = lib
    return _lib


def split_groups(D: int) -> int:
    """Decode splits one block runs side by side (the kernel's
    ``split_groups``): two 128-thread halves, one at D = 256."""
    return 2 if D <= 128 else 1


def check_sizes(B: int, T: int, group: int) -> None:
    """Raises ValueError unless the kernel's row table holds a launch of
    B rows x T positions at query group ``group``: B <= 256 rows and
    T / query_tile(group) <= 512 query tiles a row. The wrapper checks
    every launch of its plan."""
    require(group <= _MAX_GROUP, f"query group {group} > {_MAX_GROUP}")
    require(B <= _MAX_ROWS, f"{B} rows > {_MAX_ROWS}")
    nqt = -(-T // query_tile(group))
    require(nqt <= _MAX_RANKS, f"{nqt} query tiles a row > {_MAX_RANKS}")


def launch_plan(B: int, T: int, group: int
                ) -> List[Tuple[int, int, int, int]]:
    """The launches of a ragged batch of B rows x T positions, each
    (b0, b1, t0, t1): rows [b0, b1) at positions [t0, t1). One launch
    when the row table holds the batch."""
    require(group <= _MAX_GROUP, f"query group {group} > {_MAX_GROUP}")
    span = _MAX_RANKS * query_tile(group)
    return [(b0, min(b0 + _MAX_ROWS, B), t0, min(t0 + span, T))
            for b0 in range(0, B, _MAX_ROWS) for t0 in range(0, T, span)]


def run_plan(launch, q: torch.Tensor, page_table: torch.Tensor,
             q_start: torch.Tensor, lengths: torch.Tensor, group: int
             ) -> torch.Tensor:
    """[B, T, Hq, D] output of ``launch(q, page_table, q_start, lengths,
    out)`` run once per entry of ``launch_plan``, each on its rows and
    positions: a position slice as a window starting t0 later, its
    lengths cut to the slice (0 where the row ended before it)."""
    B, T = q.shape[:2]
    out = torch.empty_like(q)
    for b0, b1, t0, t1 in launch_plan(B, T, group):
        if t0 == 0 and t1 == T:
            launch(q[b0:b1], page_table[b0:b1], q_start[b0:b1],
                   lengths[b0:b1], out[b0:b1])
            continue
        part = torch.empty_like(q[b0:b1, t0:t1])
        launch(q[b0:b1, t0:t1].contiguous(), page_table[b0:b1],
               q_start[b0:b1] + t0,
               (lengths[b0:b1] - t0).clamp(0, t1 - t0), part)
        out[b0:b1, t0:t1] = part
    return out


@dataclasses.dataclass
class RaggedWork:
    """The kernel's work list, in the order its blocks take it.

    windows: (row, kv head, t0, nt) query tiles of rows longer than 1,
    rank by rank (every row's last tile, which has the most keys, then
    every row's tile before it), the kv head fastest; splits: (row, kv
    head, split, k_lo, k_hi) the decode rows' splits that hold keys
    (one, empty, for a row with no keys), the split fastest; zeros:
    (row, first, end) ranges of 16-byte vectors of the flattened
    [B, T, Hq, D] output, the padding positions no tile writes."""
    windows: List[Tuple[int, int, int, int]]
    splits: List[Tuple[int, int, int, int, int]]
    zeros: List[Tuple[int, int, int]]

    def live_blocks(self, grid: int, D: int) -> int:
        """The blocks of a ``grid``-block launch that get an item, by the
        kernel's rule: window item p goes to block p % grid; the rest, in
        pairs of units (a split takes one unit, two at D = 256, where it
        takes the whole block; a zero range one), pair i to block
        rest0 + i % (grid - rest0), rest0 the blocks that hold a window
        item when some do not, else 0."""
        n_win = len(self.windows)
        units = 2 // split_groups(D) * len(self.splits) + len(self.zeros)
        rest0 = n_win if n_win < grid else 0
        live = {p % grid for p in range(n_win)}
        live |= {rest0 + i % (grid - rest0) for i in range(-(-units // 2))}
        return len(live)


def ragged_work(q_start: Sequence[int], lengths: Sequence[int], T: int,
                Hq: int, Hkv: int, D: int, max_pages: int, page_size: int,
                sliding_window: int, splits: int) -> RaggedWork:
    """The work list the kernel builds on the device from the row
    lengths, here on the host (for the tests and the records)."""
    QB = query_tile(Hq // Hkv)
    lens = [min(max(int(n), 0), T) for n in lengths]
    starts = [int(s) for s in q_start]
    tiles = [-(-n // QB) if n > 1 else 0 for n in lens]
    windows = []
    for k in range(max(tiles, default=0)):
        for b, n in enumerate(tiles):
            if n > k:
                t0 = (n - 1 - k) * QB
                windows += [(b, h, t0, min(QB, lens[b] - t0))
                            for h in range(Hkv)]
    work = []
    for b, n in enumerate(lens):
        if n != 1:
            continue
        ctx = min(starts[b] + 1, max_pages * page_size)
        lo = max(0, starts[b] + 1 - sliding_window) \
            if sliding_window > 0 else 0
        live = [r for r in split_bounds(min(lo, ctx), ctx, splits,
                                        GQA_CHUNK) if r[0] < r[1]]
        live = live or [(ctx, ctx)]
        work += [(b, h, s, k_lo, k_hi) for h in range(Hkv)
                 for s, (k_lo, k_hi) in enumerate(live)]
    pos_vecs = Hq * D // 8
    zeros = []
    for b, n in enumerate(lens):
        covered = min(tiles[b] * QB, T) if n > 1 else n
        base = (b * T + covered) * pos_vecs
        row_vecs = (T - covered) * pos_vecs
        zeros += [(b, base + lo, base + min(lo + ZERO_VECS, row_vecs))
                  for lo in range(0, row_vecs, ZERO_VECS)]
    return RaggedWork(windows, work, zeros)


def ragged_blocks(B: int, T: int, Hq: int, Hkv: int, D: int,
                  splits: int) -> int:
    """The grid of a launch at these sizes on the current CUDA device:
    the blocks the card holds at once, no more than the largest work
    list of these sizes can use."""
    blocks = ctypes.c_int(0)
    G = Hq // Hkv
    rc = _kernel().ragged_paged_attention_blocks(
        B, T, Hkv, G, D, query_tile(G), splits, ctypes.byref(blocks))
    raise_on_error("ragged_paged_attention_blocks", rc)
    return blocks.value


def ragged_paged_attention_plain(q, k_pages, v_pages, page_table, q_start,
                                 lengths, layer: int,
                                 sliding_window: int = 0,
                                 logits_soft_cap: float = 0.0,
                                 scale: Optional[float] = None,
                                 sinks: Optional[torch.Tensor] = None,
                                 num_splits: Optional[int] = None,
                                 chunk: int = GQA_CHUNK):
    """Plain version, the kernel's arithmetic: the window rows through
    the prefill kernel's plain version (``ops/attention.mha_prefill``
    over the layer's gathered pages, kv lengths q_start + lengths), the
    decode rows (length 1) split into ``num_splits`` shares of whole
    ``chunk``-key units and folded in split order, the sinks joining
    once after the fold (``paged_attention.split_partials`` /
    ``combine_partials``); query rows t >= lengths[b] zero.
    ``num_splits`` None takes the kernel's count (``gqa_splits``)."""
    out = paged_prefill_attention_plain(
        q, k_pages, v_pages, page_table, q_start, lengths, layer,
        sliding_window, logits_soft_cap, scale, sinks)
    dec = (lengths == 1).nonzero()[:, 0]
    if dec.numel():
        B, ps, Hkv = q.shape[0], k_pages.shape[2], k_pages.shape[3]
        splits = num_splits or gqa_splits(B, Hkv, page_table.shape[1], ps,
                                          sliding_window, False)
        out[dec, 0] = paged_decode_attention_split_plain(
            q[dec, 0], k_pages, v_pages, page_table[dec].contiguous(),
            q_start[dec] + 1, layer, splits, chunk,
            sliding_window=sliding_window, logits_soft_cap=logits_soft_cap,
            scale=scale, sinks=sinks).to(out.dtype)
    return out


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           q_start: torch.Tensor, lengths: torch.Tensor,
                           layer: int, *, sliding_window: int = 0,
                           logits_soft_cap: float = 0.0,
                           scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Causal GQA attention of a ragged batch over layer ``layer`` of the
    paged pools.

    q: [B, T, Hq, D], query t of row b at position q_start[b] + t, the
    first lengths[b] rows valid (1 for a decode row, 0 for a padding
    row); k/v_pages: [L, P, ps, Hkv, D]; page_table: [B, MP] int32;
    q_start/lengths: [B] int32. A key at position kv is valid for the
    query at q_pos when kv < q_start[b] + lengths[b], kv <= q_pos and
    (W > 0) kv > q_pos - W. Rows t >= lengths[b] give zeros. A decode
    row's context is split ``gqa_splits`` ways. Returns [B, T, Hq, D]."""
    tensors = check_arguments(q, k_pages, v_pages, page_table, q_start,
                              lengths, layer, sinks)
    if not on_cuda(tensors):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_table, q_start, lengths, int(layer),
            sliding_window, logits_soft_cap, scale, sinks)
    check_cuda_shapes(q, k_pages)
    B, T, Hq, D = q.shape
    ps, Hkv = k_pages.shape[2], k_pages.shape[3]
    G, MP = Hq // Hkv, page_table.shape[1]
    QB = query_tile(G)
    splits = gqa_splits(B, Hkv, MP, ps, sliding_window, False)
    scale = float(attention._attn_scale(D, scale))

    def launch(q, page_table, q_start, lengths, out):
        Bl, Tl = q.shape[:2]
        check_sizes(Bl, Tl, G)
        part_o, part_ml, tickets = _split_scratch(q, Bl * Hkv, splits, G, D)
        rc = _kernel().ragged_paged_attention(
            ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]),
            ptr(page_table), ptr(q_start), ptr(lengths), ptr(sinks),
            ptr(out), ptr(part_o), ptr(part_ml), ptr(tickets), Bl, Tl, Hkv,
            G, D, MP, ps, QB, int(splits), int(sliding_window), scale,
            float(logits_soft_cap), stream())
        raise_on_error("ragged_paged_attention", rc)
        count_launch(ragged_paged_attention)

    return run_plan(launch, q, page_table, q_start, lengths, G)


ragged_paged_attention.launches = 0
