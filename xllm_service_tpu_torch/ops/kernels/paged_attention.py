"""Paged decode attention (CUDA kernels ``csrc/paged_decode_attention.cu``
and ``csrc/paged_decode_attention_mla.cu``).

Replaces the Pallas kernel ``paged_decode_attention_pallas``
(xllm_service_tpu/ops/pallas/paged_attention.py:154) in the two forms
the decode step launches, on layered pools:

- ``paged_decode_attention``, write-then-attend: pool only (the current
  token was written first, so ``context_lens`` includes it);
- ``paged_decode_attention_current``, attend-then-write (the Pallas
  ``has_current`` form): the pool holds ``cache_lens`` tokens and the
  current token's K/V come as ``k_cur``/``v_cur``, written to the pool
  for all layers only after the layer loop;

and at the geometry of multi-head latent attention (MLA), where one KV
"head" per token holds the latent row (D = kv_lora_rank +
qk_rope_head_dim = 576 for DeepSeek) that serves as both K and V:
``paged_decode_attention_mla`` and ``paged_decode_attention_mla_current``
take that one pool, in the same two forms. Their kernel reads each
latent row once for both products.

The Pallas "layered" form put the layer index in the page DMA's index
map so that the [L, P, ps, Hkv, D] pool was never sliced; in PyTorch
``k_pages[layer]`` is a view of the full pool and costs nothing, so the
kernel reads that view.

Bound on an H100: bytes (each K/V row, or latent row, of the context
read once). Both kernels split each row's context over ``S`` blocks
(split-KV) and combine the splits' partial softmax states inside the
same launch; ``decode_splits`` picks ``S`` from host-known sizes only
(never the context lengths, which live on the device), and the wrappers
own the scratch and the per-row ticket counters. ``split_partials`` and
``combine_partials`` are a plain version of that split arithmetic, which
the tests hold to the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, check, count_launch, on_cuda, ptr, raise_on_error, require,
    stream)

_lib = None
_lib_mla = None
_HEAD_DIMS = (64, 128, 256)       # the kernel's instantiations
_MAX_GROUP = 16
_MLA_DIMS = (576,)                # the MLA kernel's latent row
_MLA_MAX_HEADS = 16               # one 16-row tensor-core tile
# Split-KV: keys per chunk of each kernel (a split is whole chunks) and
# the blocks each aims to launch, about one wave of the blocks an H100's
# 132 SMs hold at once: the GQA kernel's blocks (128 threads, 44 KB of
# shared memory at D = 64) fit five to an SM and it aims at four, which
# times best at 8 rows of 2048-4096 keys (chip_smoke.py's split sweep);
# the MLA kernel's (173 KB of shared memory) fit one.
SMS = 132
GQA_CHUNK, GQA_TARGET_BLOCKS = 128, 4 * SMS
MLA_CHUNK, MLA_TARGET_BLOCKS = 64, SMS

# Per-device int32 ticket counters of the split kernels, zero between
# calls (the last split of each row resets its own), so calls share them
# only in stream order: the kernels launch on the current stream. A call
# that needs more replaces the buffer; the old one stays alive for CUDA
# graphs captured with it. An engine reserves its largest size before it
# captures anything (``reserve_tickets``): a buffer first made during a
# capture would come from the graph's private pool.
_tickets: Dict[torch.device, torch.Tensor] = {}
_retired: List[torch.Tensor] = []


def decode_splits(rows: int, max_keys: int, chunk: int,
                  target_blocks: int) -> int:
    """Splits S of each row's context: enough that ``rows`` x S blocks
    reach ``target_blocks``, but no more than the chunks of ``max_keys``
    (the most keys a row can attend), so that a split can hold a chunk.
    Only host-known sizes go in: reading the context lengths would stall
    the stream and could not be captured in a CUDA graph."""
    chunks = max(1, -(-max_keys // chunk))
    return max(1, min(chunks, -(-target_blocks // max(rows, 1))))


def gqa_splits(B: int, Hkv: int, max_pages: int, page_size: int,
               sliding_window: int, current: bool) -> int:
    """The GQA kernels' split count: a row attends at most the table's
    keys (plus the current one), or the window's."""
    keys = max_pages * page_size + int(current)
    if sliding_window > 0:
        keys = min(keys, sliding_window)
    return decode_splits(B * Hkv, keys, GQA_CHUNK, GQA_TARGET_BLOCKS)


def mla_splits(B: int, max_pages: int, page_size: int,
               current: bool) -> int:
    """The MLA kernel's split count."""
    return decode_splits(B, max_pages * page_size + int(current), MLA_CHUNK,
                         MLA_TARGET_BLOCKS)


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        require(not torch.cuda.is_current_stream_capturing(),
                f"{n} split tickets needed inside a CUDA graph capture; "
                f"reserve them first (reserve_tickets)")
        if t is not None:
            _retired.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def reserve_tickets(device: torch.device, n: int) -> None:
    """Make the ticket counters of ``device`` hold ``n`` (row, kv head)
    pairs now, outside any capture."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _ticket_counters(dev, n)


def _split_scratch(q: torch.Tensor, blocks: int, splits: int, rows: int,
                   D: int):
    """(part_o, part_ml, tickets) for ``blocks`` (row, kv head) pairs of
    ``rows`` query heads each, or three Nones with one split."""
    if splits == 1:
        return None, None, None
    part_o = torch.empty(blocks * splits * rows * D, dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty(blocks * splits * 2 * rows, dtype=torch.float32,
                          device=q.device)
    return part_o, part_ml, _ticket_counters(q.device, blocks)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_decode_attention")
        lib.paged_decode_attention.argtypes = [
            P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, P]
        lib.paged_decode_attention.restype = I
        lib.paged_decode_attention_current.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F,
            F, P]
        lib.paged_decode_attention_current.restype = I
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


def _check_arguments(q, k_pages, v_pages, page_table, lens, lens_name,
                     layer, sinks) -> List[torch.Tensor]:
    """The checks both forms share; returns the tensors that must lie on
    one device."""
    check("q", q, 3)
    check("k_pages", k_pages, 5)
    check("v_pages", v_pages, 5)
    check("page_table", page_table, 2, torch.int32)
    check(lens_name, lens, 1, torch.int32)
    B, Hq, D = q.shape
    L, Hkv, Dk = k_pages.shape[0], k_pages.shape[3], k_pages.shape[4]
    require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ")
    require(q.dtype == k_pages.dtype == v_pages.dtype,
            "q and the pools must share a dtype")
    require(Dk == D and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    require(page_table.shape[0] == B and lens.shape[0] == B,
            "batch sizes disagree")
    require(0 <= int(layer) < L, f"layer {layer} outside [0, {L})")
    tensors = [q, k_pages, v_pages, page_table, lens]
    if sinks is not None:
        check("sinks", sinks, 1, torch.float32)
        require(sinks.shape[0] == Hq, "sinks must be [Hq]")
        tensors.append(sinks)
    return tensors


def _check_cuda_shapes(q: torch.Tensor, k_pages: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond ``_check_arguments``."""
    D, G = q.shape[2], q.shape[1] // k_pages.shape[3]
    require(q.dtype == torch.bfloat16, "the CUDA kernel takes bfloat16")
    require(D in _HEAD_DIMS, f"head_dim {D} not in {_HEAD_DIMS}")
    require(G <= _MAX_GROUP, f"query group {G} > {_MAX_GROUP}")
    require(k_pages.shape[1] * k_pages.shape[2] < 2 ** 31,
            "pool too large for int32 rows")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           context_lens: torch.Tensor, layer: int, *,
                           sliding_window: int = 0,
                           logits_soft_cap: float = 0.0,
                           scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None,
                           num_splits: Optional[int] = None
                           ) -> torch.Tensor:
    """One query per row, GQA over layer ``layer`` of the paged pools.

    q: [B, Hq, D]; k/v_pages: [L, P, ps, Hkv, D]; page_table: [B, MP]
    int32; context_lens: [B] int32 keys per row, the query's own
    included. ``sliding_window`` W > 0 keeps keys at positions
    > ctx - 1 - W; ``logits_soft_cap`` and ``scale`` are Gemma's;
    ``sinks`` [Hq] float32 are GPT-OSS's. Rows with context 0 give
    zeros. ``num_splits`` overrides ``decode_splits``' choice of the
    kernel's split count (1: one block per row and kv head). Returns
    [B, Hq, D]."""
    tensors = _check_arguments(q, k_pages, v_pages, page_table,
                               context_lens, "context_lens", layer, sinks)
    if not on_cuda(tensors):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, context_lens, int(layer),
            sliding_window, logits_soft_cap, scale, sinks)
    _check_cuda_shapes(q, k_pages)
    B, Hq, D = q.shape
    ps, Hkv = k_pages.shape[2], k_pages.shape[3]
    G = Hq // Hkv
    splits = num_splits or gqa_splits(B, Hkv, page_table.shape[1], ps,
                                      sliding_window, False)
    part_o, part_ml, tickets = _split_scratch(q, B * Hkv, splits, G, D)
    out = torch.empty_like(q)
    rc = _kernel().paged_decode_attention(
        ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(page_table),
        ptr(context_lens), ptr(sinks), ptr(out), ptr(part_o), ptr(part_ml),
        ptr(tickets), B, Hkv, G, D, page_table.shape[1], ps,
        int(sliding_window), int(splits),
        float(attention._attn_scale(D, scale)), float(logits_soft_cap),
        stream())
    raise_on_error("paged_decode_attention", rc)
    count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_current_plain(q, k_pages, v_pages, page_table,
                                         cache_lens, k_cur, v_cur,
                                         layer: int, sliding_window: int = 0,
                                         logits_soft_cap: float = 0.0,
                                         scale: Optional[float] = None,
                                         sinks: Optional[torch.Tensor] = None):
    """Plain version: ``ops/attention.paged_decode_attention_current``
    over the layer's pools. Every row attends at least to its current
    token, so no row is zeroed."""
    return attention.paged_decode_attention_current(
        q, k_pages[layer], v_pages[layer], page_table, cache_lens, k_cur,
        v_cur, logits_soft_cap, sliding_window, scale, sinks)


def paged_decode_attention_current(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   page_table: torch.Tensor,
                                   cache_lens: torch.Tensor,
                                   k_cur: torch.Tensor, v_cur: torch.Tensor,
                                   layer: int, *, sliding_window: int = 0,
                                   logits_soft_cap: float = 0.0,
                                   scale: Optional[float] = None,
                                   sinks: Optional[torch.Tensor] = None,
                                   num_splits: Optional[int] = None
                                   ) -> torch.Tensor:
    """One query per row, GQA over layer ``layer`` of the paged pools
    plus the current token's K/V, which the pools do not hold yet.

    q: [B, Hq, D]; k/v_pages: [L, P, ps, Hkv, D]; page_table: [B, MP]
    int32; cache_lens: [B] int32 tokens in the pools before the current
    one (the query's position); k_cur/v_cur: [B, Hkv, D]. Pool keys at
    positions < cache_len (and, W > 0, > cache_len - W) and the current
    key are attended; the pool slot at cache_len is never read. A row
    with cache_len 0 attends to its current token alone.
    ``num_splits`` as for ``paged_decode_attention``. Returns [B, Hq,
    D]."""
    tensors = _check_arguments(q, k_pages, v_pages, page_table, cache_lens,
                               "cache_lens", layer, sinks)
    check("k_cur", k_cur, 3)
    check("v_cur", v_cur, 3)
    B, Hq, D = q.shape
    Hkv = k_pages.shape[3]
    require(tuple(k_cur.shape) == (B, Hkv, D)
            and tuple(v_cur.shape) == (B, Hkv, D),
            f"k_cur/v_cur must be {(B, Hkv, D)}")
    require(k_cur.dtype == q.dtype and v_cur.dtype == q.dtype,
            "k_cur/v_cur must share q's dtype")
    if not on_cuda(tensors + [k_cur, v_cur]):
        return paged_decode_attention_current_plain(
            q, k_pages, v_pages, page_table, cache_lens, k_cur, v_cur,
            int(layer), sliding_window, logits_soft_cap, scale, sinks)
    _check_cuda_shapes(q, k_pages)
    ps = k_pages.shape[2]
    G = Hq // Hkv
    splits = num_splits or gqa_splits(B, Hkv, page_table.shape[1], ps,
                                      sliding_window, True)
    part_o, part_ml, tickets = _split_scratch(q, B * Hkv, splits, G, D)
    out = torch.empty_like(q)
    rc = _kernel().paged_decode_attention_current(
        ptr(q), ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(page_table),
        ptr(cache_lens), ptr(k_cur), ptr(v_cur), ptr(sinks), ptr(out),
        ptr(part_o), ptr(part_ml), ptr(tickets), B, Hkv, G, D,
        page_table.shape[1], ps, int(sliding_window), int(splits),
        float(attention._attn_scale(D, scale)), float(logits_soft_cap),
        stream())
    raise_on_error("paged_decode_attention_current", rc)
    count_launch(paged_decode_attention_current)
    return out


paged_decode_attention_current.launches = 0


# ---------------------------------------------------------------------------
# MLA: one latent pool serves as K and V
# ---------------------------------------------------------------------------

def _mla_kernel():
    global _lib_mla
    if _lib_mla is None:
        lib = _build.load("paged_decode_attention_mla")
        lib.paged_decode_attention_mla.argtypes = [
            P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]
        lib.paged_decode_attention_mla.restype = I
        lib.paged_decode_attention_mla_current.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]
        lib.paged_decode_attention_mla_current.restype = I
        _lib_mla = lib
    return _lib_mla


def paged_decode_attention_mla_plain(q, latent_pages, page_table,
                                     context_lens, layer: int,
                                     scale: float):
    """Plain version: ``ops/attention.paged_decode_attention`` with the
    layer's latent pool as both K and V, rows of context 0 set to zero
    as the kernel leaves them."""
    pool = latent_pages[layer]
    out = attention.paged_decode_attention(q, pool, pool, page_table,
                                           context_lens, scale=scale)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0.0)


def paged_decode_attention_mla_current_plain(q, latent_pages, page_table,
                                             cache_lens, latent_cur,
                                             layer: int, scale: float):
    """Plain version: ``ops/attention.paged_decode_attention_current``
    with the layer's latent pool and the current latent row as both K
    and V."""
    pool = latent_pages[layer]
    return attention.paged_decode_attention_current(
        q, pool, pool, page_table, cache_lens, latent_cur, latent_cur,
        scale=scale)


def _check_mla(q, latent_pages, page_table, lens, lens_name,
               layer) -> List[torch.Tensor]:
    """``_check_arguments`` with the latent pool as K and V, which must
    hold one head."""
    _check_arguments(q, latent_pages, latent_pages, page_table, lens,
                     lens_name, layer, None)
    require(latent_pages.shape[3] == 1,
            f"an MLA pool holds one latent head, got "
            f"{tuple(latent_pages.shape)}")
    return [q, latent_pages, page_table, lens]


def _check_mla_cuda(q: torch.Tensor, latent_pages: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond ``_check_mla``."""
    require(q.dtype == torch.bfloat16, "the CUDA kernel takes bfloat16")
    require(q.shape[2] in _MLA_DIMS,
            f"latent width {q.shape[2]} not in {_MLA_DIMS}")
    require(q.shape[1] <= _MLA_MAX_HEADS,
            f"{q.shape[1]} query heads > {_MLA_MAX_HEADS}")
    require(latent_pages.shape[1] * latent_pages.shape[2] < 2 ** 31,
            "pool too large for int32 rows")


def paged_decode_attention_mla(q: torch.Tensor, latent_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               context_lens: torch.Tensor, layer: int,
                               scale: float, *,
                               num_splits: Optional[int] = None
                               ) -> torch.Tensor:
    """MLA decode attention of the absorbed queries over layer ``layer``
    of the latent pool, the write-then-attend form.

    q: [B, Hq, D] (D = kv_lora_rank + qk_rope_head_dim); latent_pages:
    [L, P, ps, 1, D]; page_table: [B, MP] int32; context_lens: [B] int32
    keys per row, the query's own included; ``scale`` the softmax scale
    (yarn's mscale folded in). Rows with context 0 give zeros.
    ``num_splits`` overrides ``decode_splits``' choice (1: one block per
    row). Returns [B, Hq, D], all D columns (the caller keeps the first
    kv_lora_rank)."""
    tensors = _check_mla(q, latent_pages, page_table, context_lens,
                         "context_lens", layer)
    if not on_cuda(tensors):
        return paged_decode_attention_mla_plain(
            q, latent_pages, page_table, context_lens, int(layer),
            float(scale))
    _check_mla_cuda(q, latent_pages)
    B, Hq, D = q.shape
    ps = latent_pages.shape[2]
    splits = num_splits or mla_splits(B, page_table.shape[1], ps, False)
    part_o, part_ml, tickets = _split_scratch(q, B, splits, _MLA_MAX_HEADS,
                                              D)
    out = torch.empty_like(q)
    rc = _mla_kernel().paged_decode_attention_mla(
        ptr(q), ptr(latent_pages[layer]), ptr(page_table), ptr(context_lens),
        ptr(out), ptr(part_o), ptr(part_ml), ptr(tickets), B, Hq, D,
        page_table.shape[1], ps, int(splits), float(scale), stream())
    raise_on_error("paged_decode_attention_mla", rc)
    count_launch(paged_decode_attention_mla)
    return out


paged_decode_attention_mla.launches = 0


def paged_decode_attention_mla_current(q: torch.Tensor,
                                       latent_pages: torch.Tensor,
                                       page_table: torch.Tensor,
                                       cache_lens: torch.Tensor,
                                       latent_cur: torch.Tensor, layer: int,
                                       scale: float, *,
                                       num_splits: Optional[int] = None
                                       ) -> torch.Tensor:
    """MLA decode attention over layer ``layer`` of the latent pool plus
    the current token's latent row, which the pool does not hold yet:
    the attend-then-write form.

    q: [B, Hq, D]; latent_pages: [L, P, ps, 1, D]; cache_lens: [B] int32
    tokens in the pool before the current one; latent_cur: [B, 1, D].
    Pool keys at positions < cache_len and the current row are attended;
    the pool slot at cache_len is never read, and a row with cache_len 0
    attends to its current row alone. ``num_splits`` as for
    ``paged_decode_attention_mla``. Returns [B, Hq, D]."""
    tensors = _check_mla(q, latent_pages, page_table, cache_lens,
                         "cache_lens", layer)
    check("latent_cur", latent_cur, 3)
    B, Hq, D = q.shape
    require(tuple(latent_cur.shape) == (B, 1, D),
            f"latent_cur must be {(B, 1, D)}")
    require(latent_cur.dtype == q.dtype, "latent_cur must share q's dtype")
    if not on_cuda(tensors + [latent_cur]):
        return paged_decode_attention_mla_current_plain(
            q, latent_pages, page_table, cache_lens, latent_cur, int(layer),
            float(scale))
    _check_mla_cuda(q, latent_pages)
    ps = latent_pages.shape[2]
    splits = num_splits or mla_splits(B, page_table.shape[1], ps, True)
    part_o, part_ml, tickets = _split_scratch(q, B, splits, _MLA_MAX_HEADS,
                                              D)
    out = torch.empty_like(q)
    rc = _mla_kernel().paged_decode_attention_mla_current(
        ptr(q), ptr(latent_pages[layer]), ptr(page_table), ptr(cache_lens),
        ptr(latent_cur), ptr(out), ptr(part_o), ptr(part_ml), ptr(tickets),
        B, Hq, D, page_table.shape[1], ps, int(splits), float(scale),
        stream())
    raise_on_error("paged_decode_attention_mla_current", rc)
    count_launch(paged_decode_attention_mla_current)
    return out


paged_decode_attention_mla_current.launches = 0


# ---------------------------------------------------------------------------
# The split arithmetic, plain: what the split kernels compute, split by
# split, for the tests (the kernels are held to the plain versions above)
# ---------------------------------------------------------------------------

def split_bounds(lo: int, ctx: int, num_splits: int,
                 chunk: int) -> List[Tuple[int, int]]:
    """Key ranges [k_lo, k_hi) of the ``num_splits`` splits of the
    attended keys [lo, ctx): equal shares of whole ``chunk``-key chunks
    counted from ``lo``; trailing splits may be empty (k_lo == k_hi)."""
    chunks = max(0, -(-(ctx - lo) // chunk))
    per = -(-chunks // num_splits)
    out = []
    for s in range(num_splits):
        k_lo = lo + min(s * per, chunks) * chunk
        out.append((k_lo, min(ctx, k_lo + per * chunk)))
    return out


def split_partials(q, k_pages, v_pages, page_table, lens, layer: int,
                   num_splits: int, chunk: int, *, k_cur=None, v_cur=None,
                   sliding_window: int = 0, logits_soft_cap: float = 0.0,
                   scale: Optional[float] = None):
    """Each split's softmax state, in float32, as the split kernels
    write it: m [B, S, Hq] (the split's max logit, -inf when empty),
    l [B, S, Hq] (sum of exp(logit - m), 0 when empty) and o [B, S, Hq,
    D] (sum of exp(logit - m) v, unnormalised). Arguments as for
    ``paged_decode_attention`` (pool-only, ``lens`` context lengths) or,
    with ``k_cur``/``v_cur``, ``paged_decode_attention_current``
    (``lens`` cache lengths; the current key is the last one)."""
    B, Hq, D = q.shape
    kp, vp = k_pages[layer].float(), v_pages[layer].float()
    ps, Hkv = kp.shape[1], kp.shape[2]
    G = Hq // Hkv
    MP = page_table.shape[1]
    current = k_cur is not None
    sc = attention._attn_scale(D, scale)
    dev = q.device
    m = torch.full((B, num_splits, Hq), -math.inf, device=dev)
    l = torch.zeros(B, num_splits, Hq, device=dev)
    o = torch.zeros(B, num_splits, Hq, D, device=dev)
    for b in range(B):
        raw = int(lens[b])
        pool_end = min(raw, MP * ps)
        ctx = pool_end + int(current)
        q_pos = raw if current else raw - 1
        lo = max(0, q_pos - sliding_window + 1) if sliding_window > 0 else 0
        if current:
            lo = min(lo, pool_end)
        qg = q[b].float().reshape(Hkv, G, D)
        for s, (k_lo, k_hi) in enumerate(
                split_bounds(min(lo, ctx), ctx, num_splits, chunk)):
            if k_lo >= k_hi:
                continue
            pos = torch.arange(k_lo, k_hi, device=dev)
            in_pool = pos < pool_end
            pages = page_table[b, (pos // ps).clamp(max=MP - 1)].long()
            k = kp[pages, pos % ps]                      # [n, Hkv, D]
            v = vp[pages, pos % ps]
            if current:
                k = torch.where(in_pool[:, None, None], k,
                                k_cur[b].float()[None])
                v = torch.where(in_pool[:, None, None], v,
                                v_cur[b].float()[None])
            logits = torch.einsum("hgd,nhd->hgn", qg, k) * sc
            if logits_soft_cap > 0.0:
                logits = logits_soft_cap * torch.tanh(
                    logits / logits_soft_cap)
            mx = logits.amax(-1, keepdim=True)
            p = torch.exp(logits - mx)
            m[b, s] = mx.reshape(Hq)
            l[b, s] = p.sum(-1).reshape(Hq)
            o[b, s] = torch.einsum("hgn,nhd->hgd", p, v).reshape(Hq, D)
    return m, l, o


def combine_partials(m, l, o, sinks: Optional[torch.Tensor] = None):
    """The output [B, Hq, D] from the splits' states, folded in split
    order as the kernels' last split does: M = max_s m_s, l = sum_s l_s
    e^(m_s - M), O = sum_s o_s e^(m_s - M); then the sinks [Hq] join the
    denominator once. A row whose splits are all empty (and that has no
    sink) gives zeros."""
    zero = torch.zeros((), device=m.device)
    mx = m.amax(1)                                       # [B, Hq]
    w = torch.where(l > 0, torch.exp(m - mx[:, None].clamp(min=-1e30)),
                    zero)
    den = (l * w).sum(1)
    acc = (o * w[..., None]).sum(1)
    if sinks is not None:
        sk = sinks.float()[None].expand_as(mx)
        m2 = torch.maximum(mx, sk)
        corr = torch.exp(mx - m2)
        den = den * corr + torch.exp(sk - m2)
        acc = acc * corr[..., None]
    return torch.where(den[..., None] > 0,
                       acc / den.clamp(min=1e-30)[..., None], zero)


def paged_decode_attention_split_plain(q, k_pages, v_pages, page_table,
                                       lens, layer: int, num_splits: int,
                                       chunk: int, *, k_cur=None, v_cur=None,
                                       sliding_window: int = 0,
                                       logits_soft_cap: float = 0.0,
                                       scale: Optional[float] = None,
                                       sinks: Optional[torch.Tensor] = None):
    """Split-and-combine in float32: ``combine_partials`` of
    ``split_partials``. With an MLA latent pool pass it as both
    ``k_pages`` and ``v_pages`` (and the current row as both ``k_cur``
    and ``v_cur``)."""
    m, l, o = split_partials(
        q, k_pages, v_pages, page_table, lens, layer, num_splits, chunk,
        k_cur=k_cur, v_cur=v_cur, sliding_window=sliding_window,
        logits_soft_cap=logits_soft_cap, scale=scale)
    return combine_partials(m, l, o, sinks)
