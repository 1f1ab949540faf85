"""In-place paged KV writers (CUDA kernel ``csrc/kv_update.cu``).

Replace four Pallas kernels of xllm_service_tpu/ops/pallas/kv_update.py:

- ``paged_kv_update_layer`` (decode row, :162) and
  ``paged_prefill_kv_update_layer`` (prefill window, :336) run in the
  write-then-attend layer body: each layer writes its fresh K/V into the
  pool before its attention reads the pool;
- ``paged_kv_update`` (decode row, :77) and ``paged_prefill_kv_update``
  (prefill window, :244) run once after the layer loop of the
  attend-then-write path, with every layer's fresh rows [L, ...]: one
  launch for all layers.

The Pallas kernels took the whole [L, P, ps, Hkv, D] pool with the layer
as a scalar-prefetch operand, so that no per-layer slice was
materialized. In PyTorch ``k_pages[layer]`` is a view of the full pool,
free to take, so the one-layer kernel writes into that view in place
and needs no aliasing declaration.

Bound on an H100: bytes (each fresh row read once and written once).

The layer body runs the first two fused with their neighbours (one
launch a layer instead of ~21):

- ``rope_kv_update_layer`` / ``rope_prefill_kv_update_layer`` rotate q
  and k in place by the forward's cos/sin table and write the rotated k
  and v into the layer's pages (K1 / K2 with the rope of
  ``ops/rope.py rotate``); without pools they only rotate, which is what
  the attend-then-write layer body takes;
- ``latent_kv_update_layer`` / ``latent_prefill_kv_update_layer`` build
  the MLA latent row [rms_norm(c) * kv_a_norm | rope(k_pe)] from
  ``h @ kv_a`` and write it into both pools (K1 / K2 with the latent of
  the MLA layer body); without pools they only build it.

``paged_kv_update_layer`` and ``paged_prefill_kv_update_layer`` stay as
the unfused writers (the serving path no longer calls them).
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops import attention, rope
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, check, on_cuda, ptr, raise_on_error, require, stream)
from xllm_service_tpu_torch.ops.norm import rms_norm

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("kv_update")
        lib.kv_write.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.kv_write.restype = I
        lib.kv_write_all_layers.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                            I, I, I, I, P]
        lib.kv_write_all_layers.restype = I
        lib.rope_kv_write.argtypes = [P] * 11 + [I] * 8 + [P]
        lib.rope_kv_write.restype = I
        lib.latent_kv_write.argtypes = [P, P, P, P, F, I] + [P] * 7 \
            + [I] * 7 + [P]
        lib.latent_kv_write.restype = I
        _lib = lib
    return _lib


def _check_pools(k_pages, v_pages, k_new, v_new, layer=None) -> None:
    """``layer`` None: the all-layer writers, whose fresh rows lead with
    the pools' [L]."""
    check("k_pages", k_pages, 5)
    check("v_pages", v_pages, 5)
    require(k_pages.shape == v_pages.shape and k_pages.dtype == v_pages.dtype,
            "k_pages and v_pages must match in shape and dtype")
    require(k_new.shape == v_new.shape, "k_new and v_new must match")
    require(k_new.dtype == k_pages.dtype and v_new.dtype == k_pages.dtype,
            f"k_new/v_new must be {k_pages.dtype}")
    require(tuple(k_new.shape[-2:]) == tuple(k_pages.shape[3:]),
            f"new rows {tuple(k_new.shape)} do not match the pool's "
            f"(Hkv, D) {tuple(k_pages.shape[3:])}")
    if layer is None:
        require(k_new.shape[0] == k_pages.shape[0],
                f"fresh rows {tuple(k_new.shape)} do not lead with the "
                f"pools' {k_pages.shape[0]} layers")
    else:
        require(0 <= int(layer) < k_pages.shape[0],
                f"layer {layer} outside [0, {k_pages.shape[0]})")


def _row_bytes(k_pages) -> int:
    row_bytes = k_pages.shape[3] * k_pages.shape[4] * k_pages.element_size()
    require(row_bytes % 16 == 0,
            f"a pool row of {row_bytes} bytes is not a multiple of 16")
    return row_bytes


def _launch(k_pages, v_pages, k_new, v_new, page_table, start, lengths,
            active, layer: int, T: int) -> None:
    num_pages, ps = k_pages.shape[1], k_pages.shape[2]
    row_bytes = _row_bytes(k_pages)
    rc = _kernel().kv_write(
        ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(k_new), ptr(v_new),
        ptr(page_table), ptr(start), ptr(lengths), ptr(active),
        page_table.shape[0], T, page_table.shape[1], ps, num_pages,
        row_bytes, stream())
    raise_on_error("kv_write", rc)


def _launch_all_layers(k_pages, v_pages, k_new, v_new, page_table, start,
                       lengths, active, T: int) -> None:
    L, num_pages, ps = k_pages.shape[:3]
    row_bytes = _row_bytes(k_pages)
    rc = _kernel().kv_write_all_layers(
        ptr(k_pages), ptr(v_pages), ptr(k_new), ptr(v_new),
        ptr(page_table), ptr(start), ptr(lengths), ptr(active), L,
        page_table.shape[0], T, page_table.shape[1], ps, num_pages,
        row_bytes, stream())
    raise_on_error("kv_write_all_layers", rc)


def paged_kv_update_layer_plain(k_pages, v_pages, k_new, v_new, page_table,
                                positions, active, layer: int):
    """Plain version: the scatter reference of ``ops/attention.py``."""
    return attention.write_decode_kv_layer(
        k_pages, v_pages, k_new, v_new, page_table, positions, active, layer)


def paged_kv_update_layer(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          page_table: torch.Tensor, positions: torch.Tensor,
                          active: torch.Tensor, layer: int):
    """Write one decode token's K/V per row into layer ``layer`` of the
    pools, in place, and return the pools.

    k_pages/v_pages: [L, P, ps, Hkv, D]; k_new/v_new: [B, Hkv, D];
    page_table: [B, MP] int32; positions: [B] int32; active: [B] bool.
    Inactive rows, NULL page 0 and positions past the table write
    nothing."""
    _check_pools(k_pages, v_pages, k_new, v_new, layer)
    check("k_new", k_new, 3)
    check("v_new", v_new, 3)
    B = k_new.shape[0]
    check("page_table", page_table, 2, torch.int32)
    check("positions", positions, 1, torch.int32)
    check("active", active, 1, torch.bool)
    require(page_table.shape[0] == B and positions.shape[0] == B
            and active.shape[0] == B, "batch sizes disagree")
    if not on_cuda([k_pages, v_pages, k_new, v_new, page_table, positions,
                    active]):
        return paged_kv_update_layer_plain(k_pages, v_pages, k_new, v_new,
                                           page_table, positions, active,
                                           int(layer))
    _launch(k_pages, v_pages, k_new, v_new, page_table, positions, None,
            active, int(layer), 1)
    paged_kv_update_layer.launches += 1
    return k_pages, v_pages


paged_kv_update_layer.launches = 0


def paged_prefill_kv_update_layer_plain(k_pages, v_pages, k_new, v_new,
                                        page_table, start_pos, lengths,
                                        layer: int):
    """Plain version: the scatter reference of ``ops/attention.py``."""
    return attention.write_prefill_kv_layer(
        k_pages, v_pages, k_new, v_new, page_table, start_pos, lengths, layer)


def paged_prefill_kv_update_layer(k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  k_new: torch.Tensor, v_new: torch.Tensor,
                                  page_table: torch.Tensor,
                                  start_pos: torch.Tensor,
                                  lengths: torch.Tensor, layer: int):
    """Write a prefill window [B, T, Hkv, D] into layer ``layer`` of the
    pools, in place, and return the pools. Token t of row b lands at
    position start_pos[b] + t; tokens with t >= lengths[b], NULL pages
    and positions past the table are dropped. Any start and any T are
    accepted (the Pallas kernel needed page-aligned starts and T % ps ==
    0)."""
    _check_pools(k_pages, v_pages, k_new, v_new, layer)
    check("k_new", k_new, 4)
    check("v_new", v_new, 4)
    B, T = k_new.shape[0], k_new.shape[1]
    check("page_table", page_table, 2, torch.int32)
    check("start_pos", start_pos, 1, torch.int32)
    check("lengths", lengths, 1, torch.int32)
    require(page_table.shape[0] == B and start_pos.shape[0] == B
            and lengths.shape[0] == B, "batch sizes disagree")
    if not on_cuda([k_pages, v_pages, k_new, v_new, page_table, start_pos,
                    lengths]):
        return paged_prefill_kv_update_layer_plain(
            k_pages, v_pages, k_new, v_new, page_table, start_pos, lengths,
            int(layer))
    _launch(k_pages, v_pages, k_new, v_new, page_table, start_pos, lengths,
            None, int(layer), T)
    paged_prefill_kv_update_layer.launches += 1
    return k_pages, v_pages


paged_prefill_kv_update_layer.launches = 0


def paged_kv_update_plain(k_pages, v_pages, k_new, v_new, page_table,
                          positions, active):
    """Plain version: the all-layer scatter reference of
    ``ops/attention.py``."""
    return attention.write_decode_kv_all_layers(
        k_pages, v_pages, k_new, v_new, page_table, positions, active)


def paged_kv_update(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    page_table: torch.Tensor, positions: torch.Tensor,
                    active: torch.Tensor):
    """Write one decode token's K/V per row into ALL layers of the pools,
    in place, in one launch, and return the pools.

    k_pages/v_pages: [L, P, ps, Hkv, D]; k_new/v_new: [L, B, Hkv, D];
    page_table: [B, MP] int32; positions: [B] int32; active: [B] bool.
    Drops as ``paged_kv_update_layer``."""
    _check_pools(k_pages, v_pages, k_new, v_new)
    check("k_new", k_new, 4)
    check("v_new", v_new, 4)
    B = k_new.shape[1]
    check("page_table", page_table, 2, torch.int32)
    check("positions", positions, 1, torch.int32)
    check("active", active, 1, torch.bool)
    require(page_table.shape[0] == B and positions.shape[0] == B
            and active.shape[0] == B, "batch sizes disagree")
    if not on_cuda([k_pages, v_pages, k_new, v_new, page_table, positions,
                    active]):
        return paged_kv_update_plain(k_pages, v_pages, k_new, v_new,
                                     page_table, positions, active)
    _launch_all_layers(k_pages, v_pages, k_new, v_new, page_table,
                       positions, None, active, 1)
    paged_kv_update.launches += 1
    return k_pages, v_pages


paged_kv_update.launches = 0


def paged_prefill_kv_update_plain(k_pages, v_pages, k_new, v_new,
                                  page_table, start_pos, lengths):
    """Plain version: the all-layer scatter reference of
    ``ops/attention.py``."""
    return attention.write_prefill_kv_all_layers(
        k_pages, v_pages, k_new, v_new, page_table, start_pos, lengths)


def paged_prefill_kv_update(k_pages: torch.Tensor, v_pages: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            page_table: torch.Tensor,
                            start_pos: torch.Tensor, lengths: torch.Tensor):
    """Write a prefill window [L, B, T, Hkv, D] into ALL layers of the
    pools, in place, in one launch, and return the pools. Positions and
    drops as ``paged_prefill_kv_update_layer``; any start and any T are
    accepted (the Pallas kernel needed page-aligned starts and
    T % ps == 0, the shape of its page DMAs)."""
    _check_pools(k_pages, v_pages, k_new, v_new)
    check("k_new", k_new, 5)
    check("v_new", v_new, 5)
    B, T = k_new.shape[1], k_new.shape[2]
    check("page_table", page_table, 2, torch.int32)
    check("start_pos", start_pos, 1, torch.int32)
    check("lengths", lengths, 1, torch.int32)
    require(page_table.shape[0] == B and start_pos.shape[0] == B
            and lengths.shape[0] == B, "batch sizes disagree")
    if not on_cuda([k_pages, v_pages, k_new, v_new, page_table, start_pos,
                    lengths]):
        return paged_prefill_kv_update_plain(
            k_pages, v_pages, k_new, v_new, page_table, start_pos, lengths)
    _launch_all_layers(k_pages, v_pages, k_new, v_new, page_table,
                       start_pos, lengths, None, T)
    paged_prefill_kv_update.launches += 1
    return k_pages, v_pages


paged_prefill_kv_update.launches = 0


# ---------------------------------------------------------------------------
# The layer body's writers fused with their neighbours (``rope_kv_write``
# and ``latent_kv_write`` of csrc/kv_update.cu)
# ---------------------------------------------------------------------------

def _aligned(name: str, t: torch.Tensor) -> None:
    require(t.data_ptr() % 16 == 0,
            f"{name} must start on a 16-byte boundary for the kernel")


def _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer) -> None:
    check("q", q, 4)
    check("k", k, 4)
    B, T, _, D = q.shape
    require(k.shape[:2] == (B, T) and k.shape[3] == D and k.dtype == q.dtype,
            f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(D % 2 == 0, f"head_dim {D} is odd")
    check("cos", cos, 3, torch.float32)
    check("sin", sin, 3, torch.float32)
    require(tuple(cos.shape) == (B, T, D // 2) and cos.shape == sin.shape,
            f"cos/sin must be [B, T, D/2] = {(B, T, D // 2)}, got "
            f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    if k_pages is not None:
        check("v", v, 4)
        _check_pools(k_pages, v_pages, k, v, layer)


def _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, start,
                 lengths, active, layer: int) -> None:
    B, T, Hq, D = q.shape
    tensors = [q, k, cos, sin]
    if k_pages is not None:
        tensors += [v, k_pages, v_pages]
    require(q.dtype == torch.bfloat16,
            f"the kernel rotates bf16, got {q.dtype}")
    require(D % 16 == 0, f"the kernel needs head_dim % 16 == 0, got {D}")
    for name, t in zip(("q", "k", "cos", "sin", "v", "k_pages", "v_pages"),
                       tensors):
        _aligned(name, t)
    if k_pages is None:
        kp = vp = None
        MP = ps = num_pages = 0
    else:
        kp, vp = k_pages[layer], v_pages[layer]
        MP, ps, num_pages = page_table.shape[1], k_pages.shape[2], \
            k_pages.shape[1]
    rc = _kernel().rope_kv_write(
        ptr(q), ptr(k), ptr(v if kp is not None else None), ptr(cos),
        ptr(sin), ptr(kp), ptr(vp), ptr(page_table), ptr(start),
        ptr(lengths), ptr(active), B, T, Hq, k.shape[2], D, MP, ps,
        num_pages, stream())
    raise_on_error("rope_kv_write", rc)


def rope_kv_update_layer_plain(q, k, v, cos, sin, k_pages=None,
                               v_pages=None, page_table=None, positions=None,
                               active=None, layer: int = 0):
    """Plain version: the chain the kernel fuses, ``rotate`` of q and of
    k (written back in place), then the scatter reference of
    ``ops/attention.py``."""
    q.copy_(rope.rotate(q, cos, sin))
    k.copy_(rope.rotate(k, cos, sin))
    if k_pages is not None:
        attention.write_decode_kv_layer(k_pages, v_pages, k[:, 0], v[:, 0],
                                        page_table, positions, active, layer)
    return q, k


def rope_kv_update_layer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         k_pages: Optional[torch.Tensor] = None,
                         v_pages: Optional[torch.Tensor] = None,
                         page_table: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None,
                         layer: int = 0):
    """K1 fused with the rope of its layer body: rotate one decode
    token's q [B, 1, Hq, D] and k [B, 1, Hkv, D] in place by cos/sin
    [B, 1, D/2] float32 (``rope_cos_sin`` of the positions), then write
    the rotated k and v [B, 1, Hkv, D] into layer ``layer`` of the pools
    as ``paged_kv_update_layer`` does (inactive rows, NULL page 0 and
    positions past the table write nothing; every row is rotated).
    Without pools, only the rotation (attend-then-write). Returns (q, k).

    page_table: [B, MP] int32; positions: [B] int32; active: [B] bool."""
    _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer)
    B = q.shape[0]
    require(q.shape[1] == 1, f"a decode step has T = 1, got {q.shape[1]}")
    tensors = [q, k, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("positions", positions, 1, torch.int32)
        check("active", active, 1, torch.bool)
        require(page_table.shape[0] == B and positions.shape[0] == B
                and active.shape[0] == B, "batch sizes disagree")
        tensors += [v, k_pages, v_pages, page_table, positions, active]
    if not on_cuda(tensors):
        return rope_kv_update_layer_plain(q, k, v, cos, sin, k_pages,
                                          v_pages, page_table, positions,
                                          active, int(layer))
    _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, positions,
                 None, active, int(layer))
    rope_kv_update_layer.launches += 1
    return q, k


rope_kv_update_layer.launches = 0


def rope_prefill_kv_update_layer_plain(q, k, v, cos, sin, k_pages=None,
                                       v_pages=None, page_table=None,
                                       start_pos=None, lengths=None,
                                       layer: int = 0):
    """Plain version: ``rotate`` of q and of k (in place), then the
    scatter reference of ``ops/attention.py``."""
    q.copy_(rope.rotate(q, cos, sin))
    k.copy_(rope.rotate(k, cos, sin))
    if k_pages is not None:
        attention.write_prefill_kv_layer(k_pages, v_pages, k, v, page_table,
                                         start_pos, lengths, layer)
    return q, k


def rope_prefill_kv_update_layer(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor,
                                 k_pages: Optional[torch.Tensor] = None,
                                 v_pages: Optional[torch.Tensor] = None,
                                 page_table: Optional[torch.Tensor] = None,
                                 start_pos: Optional[torch.Tensor] = None,
                                 lengths: Optional[torch.Tensor] = None,
                                 layer: int = 0):
    """K2 fused with the rope of its layer body: rotate a window's q
    [B, T, Hq, D] and k [B, T, Hkv, D] in place by cos/sin [B, T, D/2]
    (every token, padding included), then write the rotated k and v into
    layer ``layer`` of the pools as ``paged_prefill_kv_update_layer``
    does (token t of row b at start_pos[b] + t; t >= lengths[b], NULL
    pages and positions past the table dropped; any start). The ragged
    step's windows and decode rows take the same call. Without pools,
    only the rotation. Returns (q, k)."""
    _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer)
    B = q.shape[0]
    tensors = [q, k, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("start_pos", start_pos, 1, torch.int32)
        check("lengths", lengths, 1, torch.int32)
        require(page_table.shape[0] == B and start_pos.shape[0] == B
                and lengths.shape[0] == B, "batch sizes disagree")
        tensors += [v, k_pages, v_pages, page_table, start_pos, lengths]
    if not on_cuda(tensors):
        return rope_prefill_kv_update_layer_plain(
            q, k, v, cos, sin, k_pages, v_pages, page_table, start_pos,
            lengths, int(layer))
    _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, start_pos,
                 lengths, None, int(layer))
    rope_prefill_kv_update_layer.launches += 1
    return q, k


rope_prefill_kv_update_layer.launches = 0


def _latent_plain(ckv, weight, cos, sin, eps: float, interleave: bool):
    """[rms_norm(c) | rope(k_pe)] of ckv [B, T, r + dr], as [B, T, 1,
    r + dr]: the MLA layer body's unfused chain."""
    r = weight.shape[0]
    rot = rope.rotate_interleaved if interleave else rope.rotate
    return torch.cat([rms_norm(ckv[..., :r], weight, eps),
                      rot(ckv[..., r:], cos, sin)], dim=-1)[:, :, None, :]


def _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer) -> None:
    check("ckv", ckv, 3)
    check("weight", weight, 1)
    B, T, W = ckv.shape
    r = weight.shape[0]
    require(0 < r < W and (W - r) % 2 == 0,
            f"ckv width {W} is not kv_lora_rank {r} + an even rope width")
    check("cos", cos, 3, torch.float32)
    check("sin", sin, 3, torch.float32)
    require(tuple(cos.shape) == (B, T, (W - r) // 2)
            and cos.shape == sin.shape,
            f"cos/sin must be [B, T, dr/2] = {(B, T, (W - r) // 2)}, got "
            f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    if k_pages is not None:
        _check_pools(k_pages, v_pages, ckv[:, :, None, :],
                     ckv[:, :, None, :], layer)


def _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
                   page_table, start, lengths, active, layer: int):
    B, T, W = ckv.shape
    r = weight.shape[0]
    require(ckv.dtype == torch.bfloat16 and weight.dtype == torch.bfloat16,
            f"the kernel builds bf16 latents, got {ckv.dtype} / "
            f"{weight.dtype}")
    require(r % 8 == 0, f"the kernel needs kv_lora_rank % 8 == 0, got {r}")
    latent = torch.empty(B, T, 1, W, dtype=ckv.dtype, device=ckv.device)
    tensors = [("ckv", ckv), ("weight", weight), ("latent", latent)]
    if k_pages is None:
        kp = vp = None
        MP = ps = num_pages = 0
    else:
        kp, vp = k_pages[layer], v_pages[layer]
        tensors += [("k_pages", kp), ("v_pages", vp)]
        MP, ps, num_pages = page_table.shape[1], k_pages.shape[2], \
            k_pages.shape[1]
    for name, t in tensors:
        _aligned(name, t)
    rc = _kernel().latent_kv_write(
        ptr(ckv), ptr(weight), ptr(cos), ptr(sin), float(eps),
        int(bool(interleave)), ptr(latent), ptr(kp), ptr(vp),
        ptr(page_table), ptr(start), ptr(lengths), ptr(active), B, T, r,
        W - r, MP, ps, num_pages, stream())
    raise_on_error("latent_kv_write", rc)
    return latent


def latent_kv_update_layer_plain(ckv, weight, cos, sin, eps: float,
                                 interleave: bool, k_pages=None, v_pages=None,
                                 page_table=None, positions=None, active=None,
                                 layer: int = 0):
    """Plain version: ``rms_norm``, the rope of k_pe and a ``cat``, then
    the scatter reference of ``ops/attention.py`` into both pools."""
    latent = _latent_plain(ckv, weight, cos, sin, eps, interleave)
    if k_pages is not None:
        lat = latent[:, 0]
        attention.write_decode_kv_layer(k_pages, v_pages, lat, lat,
                                        page_table, positions, active, layer)
    return latent


def latent_kv_update_layer(ckv: torch.Tensor, weight: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor, eps: float,
                           interleave: bool,
                           k_pages: Optional[torch.Tensor] = None,
                           v_pages: Optional[torch.Tensor] = None,
                           page_table: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None,
                           layer: int = 0) -> torch.Tensor:
    """K1 fused with the MLA latent of its layer body: from one decode
    token's ckv = h @ kv_a [B, 1, r + dr], build the latent row [B, 1, 1,
    r + dr] = [rms_norm(ckv[:r]) * ``weight`` (kv_a_norm, eps) |
    rope(ckv[r:]) by cos/sin [B, 1, dr/2] (adjacent pairs when
    ``interleave``, else halves)], write it into layer ``layer`` of both
    pools as ``paged_kv_update_layer`` does, and return it. Without
    pools, only the row (attend-then-write)."""
    _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer)
    B = ckv.shape[0]
    require(ckv.shape[1] == 1, f"a decode step has T = 1, got "
            f"{ckv.shape[1]}")
    tensors = [ckv, weight, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("positions", positions, 1, torch.int32)
        check("active", active, 1, torch.bool)
        require(page_table.shape[0] == B and positions.shape[0] == B
                and active.shape[0] == B, "batch sizes disagree")
        tensors += [k_pages, v_pages, page_table, positions, active]
    if not on_cuda(tensors):
        return latent_kv_update_layer_plain(
            ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
            page_table, positions, active, int(layer))
    latent = _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages,
                            v_pages, page_table, positions, None, active,
                            int(layer))
    latent_kv_update_layer.launches += 1
    return latent


latent_kv_update_layer.launches = 0


def latent_prefill_kv_update_layer_plain(ckv, weight, cos, sin, eps: float,
                                         interleave: bool, k_pages=None,
                                         v_pages=None, page_table=None,
                                         start_pos=None, lengths=None,
                                         layer: int = 0):
    """Plain version: the latent chain, then the window scatter reference
    of ``ops/attention.py`` into both pools."""
    latent = _latent_plain(ckv, weight, cos, sin, eps, interleave)
    if k_pages is not None:
        attention.write_prefill_kv_layer(k_pages, v_pages, latent, latent,
                                         page_table, start_pos, lengths,
                                         layer)
    return latent


def latent_prefill_kv_update_layer(ckv: torch.Tensor, weight: torch.Tensor,
                                   cos: torch.Tensor, sin: torch.Tensor,
                                   eps: float, interleave: bool,
                                   k_pages: Optional[torch.Tensor] = None,
                                   v_pages: Optional[torch.Tensor] = None,
                                   page_table: Optional[torch.Tensor] = None,
                                   start_pos: Optional[torch.Tensor] = None,
                                   lengths: Optional[torch.Tensor] = None,
                                   layer: int = 0) -> torch.Tensor:
    """K2 fused with the MLA latent: ``latent_kv_update_layer`` for a
    window ckv [B, T, r + dr], written as
    ``paged_prefill_kv_update_layer`` writes (positions start_pos[b] + t,
    t < lengths[b]). Returns the latent [B, T, 1, r + dr], every token's
    (padding included)."""
    _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer)
    B = ckv.shape[0]
    tensors = [ckv, weight, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("start_pos", start_pos, 1, torch.int32)
        check("lengths", lengths, 1, torch.int32)
        require(page_table.shape[0] == B and start_pos.shape[0] == B
                and lengths.shape[0] == B, "batch sizes disagree")
        tensors += [k_pages, v_pages, page_table, start_pos, lengths]
    if not on_cuda(tensors):
        return latent_prefill_kv_update_layer_plain(
            ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
            page_table, start_pos, lengths, int(layer))
    latent = _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages,
                            v_pages, page_table, start_pos, lengths, None,
                            int(layer))
    latent_prefill_kv_update_layer.launches += 1
    return latent


latent_prefill_kv_update_layer.launches = 0
