"""Paged decode attention (CUDA kernel ``csrc/paged_decode_attention.cu``).

Replaces the Pallas kernel ``paged_decode_attention_pallas``
(xllm_service_tpu/ops/pallas/paged_attention.py:154) in the form the
write-then-attend decode step launches: layered pools, pool only (the
current token was written first, so ``context_lens`` includes it).

The Pallas "layered" form put the layer index in the page DMA's index
map so that the [L, P, ps, Hkv, D] pool was never sliced; in PyTorch
``k_pages[layer]`` is a view of the full pool and costs nothing, so the
kernel reads that view.

Bound on an H100: bytes (each K/V row of the context read once).
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, check, on_cuda, ptr, raise_on_error, require, stream)

_lib = None
_HEAD_DIMS = (64, 128, 256)       # the kernel's instantiations
_MAX_GROUP = 16


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_decode_attention")
        lib.paged_decode_attention.argtypes = [
            P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, P]
        lib.paged_decode_attention.restype = I
        _lib = lib
    return _lib


def paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                 context_lens, layer: int,
                                 sliding_window: int = 0,
                                 logits_soft_cap: float = 0.0,
                                 scale: Optional[float] = None,
                                 sinks: Optional[torch.Tensor] = None):
    """Plain version: ``ops/attention.paged_decode_attention`` over the
    layer's pools, with rows of context 0 set to zero as the kernel
    leaves them (the reference gives the mean of V there)."""
    out = attention.paged_decode_attention(
        q, k_pages[layer], v_pages[layer], page_table, context_lens,
        logits_soft_cap, sliding_window, scale, sinks)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0.0)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           context_lens: torch.Tensor, layer: int, *,
                           sliding_window: int = 0,
                           logits_soft_cap: float = 0.0,
                           scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One query per row, GQA over layer ``layer`` of the paged pools.

    q: [B, Hq, D]; k/v_pages: [L, P, ps, Hkv, D]; page_table: [B, MP]
    int32; context_lens: [B] int32 keys per row, the query's own
    included. ``sliding_window`` W > 0 keeps keys at positions
    > ctx - 1 - W; ``logits_soft_cap`` and ``scale`` are Gemma's;
    ``sinks`` [Hq] float32 are GPT-OSS's. Rows with context 0 give
    zeros. Returns [B, Hq, D]."""
    check("q", q, 3)
    check("k_pages", k_pages, 5)
    check("v_pages", v_pages, 5)
    check("page_table", page_table, 2, torch.int32)
    check("context_lens", context_lens, 1, torch.int32)
    B, Hq, D = q.shape
    L, num_pages, ps, Hkv, Dk = k_pages.shape
    require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ")
    require(q.dtype == k_pages.dtype == v_pages.dtype,
            "q and the pools must share a dtype")
    require(Dk == D and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    require(page_table.shape[0] == B and context_lens.shape[0] == B,
            "batch sizes disagree")
    require(0 <= int(layer) < L, f"layer {layer} outside [0, {L})")
    tensors = [q, k_pages, v_pages, page_table, context_lens]
    if sinks is not None:
        check("sinks", sinks, 1, torch.float32)
        require(sinks.shape[0] == Hq, "sinks must be [Hq]")
        tensors.append(sinks)
    if not on_cuda(tensors):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, context_lens, int(layer),
            sliding_window, logits_soft_cap, scale, sinks)
    G = Hq // Hkv
    require(q.dtype == torch.bfloat16, "the CUDA kernel takes bfloat16")
    require(D in _HEAD_DIMS, f"head_dim {D} not in {_HEAD_DIMS}")
    require(G <= _MAX_GROUP, f"query group {G} > {_MAX_GROUP}")
    require(num_pages * ps < 2 ** 31, "pool too large for int32 rows")
    out = torch.empty_like(q)
    rc = _kernel().paged_decode_attention(
        ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(page_table),
        ptr(context_lens), ptr(sinks), ptr(out), B, Hkv, G, D,
        page_table.shape[1], ps, int(sliding_window),
        float(attention._attn_scale(D, scale)), float(logits_soft_cap),
        stream())
    raise_on_error("paged_decode_attention", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
