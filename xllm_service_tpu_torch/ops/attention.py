"""Attention over a paged KV cache: the plain PyTorch references.

The KV cache is a pool of fixed-size pages per layer,
``k_pages, v_pages : [L, P, page_size, num_kv_heads, head_dim]``. A
sequence owns an ordered list of page ids (its page table, ``[B, MP]``
int32). Page id 0 is the NULL page: writes that target it are dropped,
and the allocator (``runtime/kv_cache.py``) never hands it out.

Each function here is the counterpart of the JAX package's XLA
reference of the same name (``write_*_kv_layer`` of its
``write_*_kv_layer_xla``). They are the plain versions the hand-written
CUDA kernels in ``ops/kernels/`` are held against, and what those
kernels' wrappers run for tensors on the CPU.

Unlike the JAX functions, the two writers update the pools in place
(PyTorch needs no aliasing declaration for that) and return them.
GQA groups query heads over KV heads ([.., Hkv, G, D]); scores and the
softmax are float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NULL_PAGE = 0
_NEG_INF = -1e30

# Window of a full-attention layer when windows differ by layer
# (Gemma-2/3 alternation): larger than any context, so the window mask
# is a no-op. The CUDA kernels compute ``q_pos - window`` in int32, so
# it must stay <= 2^30.
FULL_WINDOW = 1 << 30


def _attn_scale(D: int, scale: Optional[float]) -> float:
    """Default 1/sqrt(head_dim); Gemma overrides it with
    query_pre_attn_scalar**-0.5."""
    return D ** -0.5 if scale is None else float(scale)


def _flat_kv_index(page_table: torch.Tensor, positions: torch.Tensor,
                   page_size: int, num_slots: int,
                   valid: torch.Tensor) -> torch.Tensor:
    """Map logical token ``positions`` [B, T] to flat slot indices into
    the pool viewed as [num_pages * page_size, ...]. Invalid tokens, NULL
    pages and positions past the table map to ``num_slots``, a positive
    out-of-bounds sentinel the writers drop."""
    mp = page_table.shape[1]
    page_idx = positions // page_size
    slot = positions % page_size
    # A position past the table must be dropped, not clamped onto the
    # table's last entry.
    in_table = page_idx < mp
    page_id = torch.gather(page_table.long(), 1, page_idx.clamp(max=mp - 1))
    flat = page_id * page_size + slot
    keep = valid & in_table & (page_id != NULL_PAGE)
    return torch.where(keep, flat, torch.full_like(flat, num_slots))


def _scatter_rows(pages: torch.Tensor, flat: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """pages[flat] = rows over the pool's [P * ps] slot axis, dropping
    out-of-range indices (the sentinel among them)."""
    P, ps = pages.shape[0], pages.shape[1]
    view = pages.view(P * ps, *pages.shape[2:])
    keep = (flat >= 0) & (flat < P * ps)
    view[flat[keep]] = rows[keep].to(pages.dtype)


def write_decode_kv_layer(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          page_table: torch.Tensor, positions: torch.Tensor,
                          active: torch.Tensor, layer: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ONE decode token's K/V [B, Hkv, D] per row into layer
    ``layer`` of the [L, P, ps, Hkv, D] pools, in place. Inactive rows,
    NULL pages and positions past the table write nothing."""
    ps = k_pages.shape[2]
    num_slots = k_pages.shape[1] * ps
    flat = _flat_kv_index(page_table, positions.long()[:, None], ps,
                          num_slots, active.bool()[:, None])[:, 0]
    _scatter_rows(k_pages[layer], flat, k_new)
    _scatter_rows(v_pages[layer], flat, v_new)
    return k_pages, v_pages


def write_prefill_kv_layer(k_pages: torch.Tensor, v_pages: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           page_table: torch.Tensor, start_pos: torch.Tensor,
                           lengths: torch.Tensor, layer: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a prefill window [B, T, Hkv, D] into layer ``layer`` of the
    pools, in place: token t of row b lands at position start_pos[b] + t;
    tokens with t >= lengths[b] are dropped. Any start is accepted."""
    B, T = k_new.shape[0], k_new.shape[1]
    ps = k_pages.shape[2]
    num_slots = k_pages.shape[1] * ps
    t = torch.arange(T, device=k_new.device)[None, :]
    positions = start_pos.long()[:, None] + t
    valid = t < lengths.long()[:, None]
    flat = _flat_kv_index(page_table, positions, ps, num_slots,
                          valid).reshape(-1)
    _scatter_rows(k_pages[layer], flat, k_new.reshape(B * T, *k_new.shape[2:]))
    _scatter_rows(v_pages[layer], flat, v_new.reshape(B * T, *v_new.shape[2:]))
    return k_pages, v_pages


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Gather sequences' pages [P, ps, H, D] into [B, MP * ps, H, D]."""
    g = pages[page_table.long()]                       # [B, MP, ps, H, D]
    B, MP, PS = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape(B, MP * PS, *g.shape[3:])


def _group_heads(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[..., Hq, D] -> [..., Hkv, G, D]."""
    *lead, hq, d = q.shape
    return q.reshape(*lead, num_kv_heads, hq // num_kv_heads, d)


def _softmax_with_sinks(logits: torch.Tensor, sinks: Optional[torch.Tensor],
                        num_kv_heads: int, head_axes: int) -> torch.Tensor:
    """Softmax over the last axis; GPT-OSS sinks (one logit per query
    head) join the denominator and their probability is dropped.
    ``logits`` is [B, Hkv, G, ...trailing]; ``head_axes`` counts the
    trailing axes after G (the key axis included)."""
    if sinks is None:
        return torch.softmax(logits, dim=-1)
    sk = sinks.float().reshape(num_kv_heads, -1)
    sk = sk.reshape(1, *sk.shape, *([1] * head_axes))
    sk = sk.expand(*logits.shape[:-1], 1)
    p = torch.softmax(torch.cat([logits, sk], dim=-1), dim=-1)
    return p[..., :-1]


def mha_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_lengths: torch.Tensor, q_start: torch.Tensor,
                logits_soft_cap: float = 0.0, sliding_window: int = 0,
                scale: Optional[float] = None,
                sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention for prefill.

    q: [B, T, Hq, D], the new tokens at positions q_start[b] + t; k/v:
    [B, S, Hkv, D], key position j is position j; kv_lengths: [B] valid
    keys per row. ``sliding_window`` W > 0 keeps keys with
    kv_pos > q_pos - W. Returns [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[2], k.shape[1]
    qg = _group_heads(q, Hkv).float()                        # [B,T,Hkv,G,D]
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) \
        * _attn_scale(D, scale)
    if logits_soft_cap > 0.0:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    dev = q.device
    q_pos = q_start.long()[:, None] + torch.arange(T, device=dev)[None, :]
    kv_pos = torch.arange(S, device=dev)[None, :]
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]                # [B, T, S]
    mask = mask & (kv_pos < kv_lengths.long()[:, None])[:, None, :]
    if sliding_window:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None]
                       - sliding_window)
    logits = logits.masked_fill(~mask[:, None, None], _NEG_INF)
    p = _softmax_with_sinks(logits, sinks, Hkv, 2)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           context_lens: torch.Tensor,
                           logits_soft_cap: float = 0.0,
                           sliding_window: int = 0,
                           scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token GQA attention against one layer's paged cache.

    q: [B, Hq, D]; k/v_pages: [P, ps, Hkv, D]; context_lens: [B] valid
    keys including the token written this step (the query sits at
    position context_lens - 1). Rows with context 0 get the mean of V,
    as the JAX reference's all-masked softmax gives. Returns [B, Hq, D]."""
    B, Hq, D = q.shape
    k = gather_pages(k_pages, page_table)                    # [B, S, Hkv, D]
    v = gather_pages(v_pages, page_table)
    Hkv, S = k.shape[2], k.shape[1]
    qg = _group_heads(q, Hkv).float()                        # [B, Hkv, G, D]
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) \
        * _attn_scale(D, scale)
    if logits_soft_cap > 0.0:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    ctx = context_lens.long()[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < ctx
    if sliding_window:
        mask = mask & (pos > ctx - 1 - sliding_window)
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = _softmax_with_sinks(logits, sinks, Hkv, 1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype), v)
    return out.reshape(B, Hq, D)
