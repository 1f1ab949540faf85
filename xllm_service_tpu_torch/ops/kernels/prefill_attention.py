"""Paged prefill attention (CUDA kernel ``csrc/paged_prefill_attention.cu``).

Replaces the Pallas kernel ``paged_prefill_attention_pallas``
(xllm_service_tpu/ops/pallas/prefill_attention.py:272) in the form the
write-then-attend prefill step launches: layered pools with
``from_pool=True`` (the window's K/V is already in the pool, so every
key, cached prefix and window alike, is read through the page table).

As for decode, the Pallas layered form's layer-in-the-index-map becomes
``k_pages[layer]``, a view of the full pool.

Bound on an H100 at this slice's window sizes: bytes (each key row read
once per query tile of 64 (position, head) rows).
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, check, on_cuda, ptr, raise_on_error, require, stream)

_lib = None
_TILE_ROWS = 64          # (query position, head) rows per thread block
_HEAD_DIMS = (64, 128, 256)       # the kernel's instantiations


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_prefill_attention")
        lib.paged_prefill_attention.argtypes = [
            P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, P]
        lib.paged_prefill_attention.restype = I
        _lib = lib
    return _lib


def query_tile(group: int) -> int:
    """Query positions per thread block: a tile holds 64 rows of
    (position, head of the group)."""
    return max(1, _TILE_ROWS // group)


def paged_prefill_attention_plain(q, k_pages, v_pages, page_table, q_start,
                                  lengths, layer: int,
                                  sliding_window: int = 0,
                                  logits_soft_cap: float = 0.0,
                                  scale: Optional[float] = None,
                                  sinks: Optional[torch.Tensor] = None):
    """Plain version: ``ops/attention.mha_prefill`` over the layer's
    gathered pages, with query rows t >= lengths[b] set to zero as the
    kernel leaves them."""
    kp = attention.gather_pages(k_pages[layer], page_table)
    vp = attention.gather_pages(v_pages[layer], page_table)
    out = attention.mha_prefill(q, kp, vp, q_start + lengths, q_start,
                                logits_soft_cap, sliding_window, scale, sinks)
    t = torch.arange(q.shape[1], device=q.device)
    pad = t[None, :] >= lengths.long()[:, None]
    return out.masked_fill(pad[:, :, None, None], 0.0)


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            q_start: torch.Tensor, lengths: torch.Tensor,
                            layer: int, *, sliding_window: int = 0,
                            logits_soft_cap: float = 0.0,
                            scale: Optional[float] = None,
                            sinks: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Causal GQA attention of a prefill window over layer ``layer`` of
    the paged pools, the window's own K/V included.

    q: [B, T, Hq, D], query t of row b at position q_start[b] + t;
    k/v_pages: [L, P, ps, Hkv, D]; page_table: [B, MP] int32;
    q_start/lengths: [B] int32. Keys at positions
    < q_start[b] + lengths[b] are valid, causally and (W > 0) inside the
    sliding window. Rows t >= lengths[b] give zeros. Returns
    [B, T, Hq, D]."""
    check("q", q, 4)
    check("k_pages", k_pages, 5)
    check("v_pages", v_pages, 5)
    check("page_table", page_table, 2, torch.int32)
    check("q_start", q_start, 1, torch.int32)
    check("lengths", lengths, 1, torch.int32)
    B, T, Hq, D = q.shape
    L, num_pages, ps, Hkv, Dk = k_pages.shape
    require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ")
    require(q.dtype == k_pages.dtype == v_pages.dtype,
            "q and the pools must share a dtype")
    require(Dk == D and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    require(page_table.shape[0] == B and q_start.shape[0] == B
            and lengths.shape[0] == B, "batch sizes disagree")
    require(0 <= int(layer) < L, f"layer {layer} outside [0, {L})")
    tensors = [q, k_pages, v_pages, page_table, q_start, lengths]
    if sinks is not None:
        check("sinks", sinks, 1, torch.float32)
        require(sinks.shape[0] == Hq, "sinks must be [Hq]")
        tensors.append(sinks)
    if not on_cuda(tensors):
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, page_table, q_start, lengths, int(layer),
            sliding_window, logits_soft_cap, scale, sinks)
    G = Hq // Hkv
    require(q.dtype == torch.bfloat16, "the CUDA kernel takes bfloat16")
    require(D in _HEAD_DIMS, f"head_dim {D} not in {_HEAD_DIMS}")
    require(G <= _TILE_ROWS, f"query group {G} > {_TILE_ROWS}")
    require(num_pages * ps < 2 ** 31, "pool too large for int32 rows")
    out = torch.empty_like(q)
    rc = _kernel().paged_prefill_attention(
        ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(page_table),
        ptr(q_start), ptr(lengths), ptr(sinks), ptr(out), B, T, Hkv, G, D,
        page_table.shape[1], ps, query_tile(G), int(sliding_window),
        float(attention._attn_scale(D, scale)), float(logits_soft_cap),
        stream())
    raise_on_error("paged_prefill_attention", rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
