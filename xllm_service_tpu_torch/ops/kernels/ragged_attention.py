"""Ragged paged attention (CUDA kernel ``csrc/ragged_paged_attention.cu``).

Replaces the Pallas kernel ``ragged_paged_attention_pallas``
(xllm_service_tpu/ops/pallas/ragged_attention.py:191) in the form the
engine's one-launch ragged mixed step uses: layered pools, every row's
new K/V already in the pool. A row is a prefill window or a single
decode continuation (length 1 at q_start = context - 1, starting
mid-page as often as not); there is no T % page_size requirement.

As for the other attention kernels, the layer index in the Pallas
kernel's index map becomes ``k_pages[layer]``, a view of the full pool.

Bound on an H100 at the ragged serving mix: bytes (the live keys' K/V
and the live query rows). Each block serves its (row, kv head, query
tile) by the code suited to it: a window tile by the prefill kernel's
tile code, a decode row by the decode kernel's row code, and a tile
without a valid row (most tiles of a decode row in a long bucket) only
writes its zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, on_cuda, ptr, raise_on_error, require, stream)
from xllm_service_tpu_torch.ops.kernels.prefill_attention import (
    check_arguments, check_cuda_shapes, paged_prefill_attention_plain,
    query_tile)

_lib = None
_MAX_GROUP = 16          # the decode rows' code is built for G <= 16


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("ragged_paged_attention")
        lib.ragged_paged_attention.argtypes = [
            P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, P]
        lib.ragged_paged_attention.restype = I
        _lib = lib
    return _lib


def ragged_paged_attention_plain(q, k_pages, v_pages, page_table, q_start,
                                 lengths, layer: int,
                                 sliding_window: int = 0,
                                 logits_soft_cap: float = 0.0,
                                 scale: Optional[float] = None,
                                 sinks: Optional[torch.Tensor] = None):
    """Plain version: ``ops/attention.mha_prefill`` over the layer's
    gathered pages with kv lengths q_start + lengths, query rows
    t >= lengths[b] set to zero as the kernel leaves them. That is the
    prefill kernel's plain version: a ragged row is a prefill window
    whose start need not be page-aligned."""
    return paged_prefill_attention_plain(
        q, k_pages, v_pages, page_table, q_start, lengths, layer,
        sliding_window, logits_soft_cap, scale, sinks)


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
    (W > 0) kv > q_pos - W. Rows t >= lengths[b] give zeros. Returns
    [B, T, Hq, D]."""
    tensors = check_arguments(q, k_pages, v_pages, page_table, q_start,
                              lengths, layer, sinks)
    if not on_cuda(tensors):
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_table, q_start, lengths, int(layer),
            sliding_window, logits_soft_cap, scale, sinks)
    check_cuda_shapes(q, k_pages)
    B, T, Hq, D = q.shape
    ps, Hkv = k_pages.shape[2], k_pages.shape[3]
    G = Hq // Hkv
    require(G <= _MAX_GROUP, f"query group {G} > {_MAX_GROUP}")
    out = torch.empty_like(q)
    rc = _kernel().ragged_paged_attention(
        ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(page_table),
        ptr(q_start), ptr(lengths), ptr(sinks), ptr(out), B, T, Hkv, G, D,
        page_table.shape[1], ps, query_tile(G), int(sliding_window),
        float(attention._attn_scale(D, scale)), float(logits_soft_cap),
        stream())
    raise_on_error("ragged_paged_attention", rc)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
