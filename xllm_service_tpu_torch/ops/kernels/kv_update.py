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

In the attend-then-write path the pool-less forms write their layer's
rotated k and v (or latent row) into a slot of a staging buffer
[L, B, (T,) Hkv, D] that the forward allocates once; the attention
kernels and the all-layer writers read the rows there. A decode step's
last layer runs ``rope_kv_update_all_layers`` /
``latent_kv_update_all_layers``: the same launch also writes every
earlier layer's staged rows into the pools, which is K6's work, so K6
(``paged_kv_update``) no longer runs on a served path. A prefill step
keeps K7 (``paged_prefill_kv_update``) as its own launch, fed from the
staging buffer.

``paged_kv_update_layer``, ``paged_prefill_kv_update_layer`` and
``paged_kv_update`` stay as the unfused writers (the serving path no
longer calls them; they are the fused forms' yardsticks).
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops import attention, rope
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    F, I, P, check, count_launch, on_cuda, ptr, raise_on_error, require,
    stream)
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
        lib.rope_kv_write.argtypes = [P] * 13 + [I] * 10 + [P]
        lib.rope_kv_write.restype = I
        lib.latent_kv_write.argtypes = [P, P, P, P, F, I, P, I] + [P] * 6 \
            + [I] * 9 + [P]
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
    count_launch(paged_kv_update_layer)
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
    count_launch(paged_prefill_kv_update_layer)
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
    count_launch(paged_kv_update)
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
    count_launch(paged_prefill_kv_update)
    return k_pages, v_pages


paged_prefill_kv_update.launches = 0


# ---------------------------------------------------------------------------
# The layer body's writers fused with their neighbours (``rope_kv_write``
# and ``latent_kv_write`` of csrc/kv_update.cu)
# ---------------------------------------------------------------------------

def _aligned(name: str, t: torch.Tensor) -> None:
    require(t.data_ptr() % 16 == 0,
            f"{name} must start on a 16-byte boundary for the kernel")


def _check_stage(name: str, stage, rows: torch.Tensor, layer) -> None:
    """A staging buffer: [L, ...] contiguous, each slot holding as many
    elements as ``rows`` (one layer's rows), of its dtype, with a slot
    for ``layer``."""
    require(isinstance(stage, torch.Tensor) and stage.dim() >= 2
            and stage.is_contiguous(), f"{name} must be a contiguous "
            f"[L, ...] tensor")
    require(stage[0].numel() == rows.numel() and stage.dtype == rows.dtype,
            f"{name} {tuple(stage.shape)} {stage.dtype} does not hold "
            f"rows {tuple(rows.shape)} {rows.dtype} per layer")
    require(0 <= int(layer) < stage.shape[0],
            f"layer {layer} outside the {name}'s {stage.shape[0]} slots")


def _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer,
                k_stage=None, v_stage=None) -> None:
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
    if k_pages is not None or k_stage is not None:
        check("v", v, 4)
        require(v.shape == k.shape and v.dtype == k.dtype,
                f"v {tuple(v.shape)} does not match k {tuple(k.shape)}")
    if k_pages is not None:
        _check_pools(k_pages, v_pages, k, v, layer)
    require((k_stage is None) == (v_stage is None),
            "k_stage and v_stage go together")
    if k_stage is not None:
        _check_stage("k_stage", k_stage, k, layer)
        _check_stage("v_stage", v_stage, v, layer)


def _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, start,
                 lengths, active, layer: int, k_stage=None, v_stage=None,
                 all_layers: bool = False) -> None:
    B, T, Hq, D = q.shape
    tensors = [("q", q), ("k", k), ("cos", cos), ("sin", sin)]
    if k_pages is not None or k_stage is not None:
        tensors.append(("v", v))
    if k_pages is not None:
        tensors += [("k_pages", k_pages), ("v_pages", v_pages)]
    if k_stage is not None:
        tensors += [("k_stage", k_stage), ("v_stage", v_stage)]
    require(q.dtype == torch.bfloat16,
            f"the kernel rotates bf16, got {q.dtype}")
    require(D % 16 == 0, f"the kernel needs head_dim % 16 == 0, got {D}")
    for name, t in tensors:
        _aligned(name, t)
    if k_pages is None:
        MP = ps = num_pages = 0
    else:
        MP, ps, num_pages = page_table.shape[1], k_pages.shape[2], \
            k_pages.shape[1]
    rc = _kernel().rope_kv_write(
        ptr(q), ptr(k), ptr(v if k_pages is not None or k_stage is not None
                             else None), ptr(cos), ptr(sin), ptr(k_pages),
        ptr(v_pages), ptr(k_stage), ptr(v_stage), ptr(page_table),
        ptr(start), ptr(lengths), ptr(active), B, T, Hq, k.shape[2], D, MP,
        ps, num_pages, int(layer), int(all_layers), stream())
    raise_on_error("rope_kv_write", rc)


def _stage_rows(stage, layer: int, rows: torch.Tensor) -> None:
    """Plain: copy one layer's rows into slot ``layer``."""
    stage[layer].view(rows.shape).copy_(rows)


def rope_kv_update_layer_plain(q, k, v, cos, sin, k_pages=None,
                               v_pages=None, page_table=None, positions=None,
                               active=None, layer: int = 0, *, k_stage=None,
                               v_stage=None):
    """Plain version: the chain the kernel fuses, ``rotate`` of q and of
    k (written back in place), then the scatter reference of
    ``ops/attention.py``, or the copy into the staging slot."""
    q.copy_(rope.rotate(q, cos, sin))
    k.copy_(rope.rotate(k, cos, sin))
    if k_pages is not None:
        attention.write_decode_kv_layer(k_pages, v_pages, k[:, 0], v[:, 0],
                                        page_table, positions, active, layer)
    if k_stage is not None:
        _stage_rows(k_stage, layer, k)
        _stage_rows(v_stage, layer, v)
    return q, k


def rope_kv_update_layer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         k_pages: Optional[torch.Tensor] = None,
                         v_pages: Optional[torch.Tensor] = None,
                         page_table: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None,
                         layer: int = 0, *,
                         k_stage: Optional[torch.Tensor] = None,
                         v_stage: Optional[torch.Tensor] = None):
    """K1 fused with the rope of its layer body: rotate one decode
    token's q [B, 1, Hq, D] and k [B, 1, Hkv, D] in place by cos/sin
    [B, 1, D/2] float32 (``rope_cos_sin`` of the positions), then write
    the rotated k and v [B, 1, Hkv, D] into layer ``layer`` of the pools
    as ``paged_kv_update_layer`` does (inactive rows, NULL page 0 and
    positions past the table write nothing; every row is rotated).
    Without pools, only the rotation (attend-then-write), and with
    ``k_stage``/``v_stage`` (staging buffers [L, B, Hkv, D]) the rotated
    k and v of every row also go to their slot ``layer``. Returns
    (q, k).

    page_table: [B, MP] int32; positions: [B] int32; active: [B] bool."""
    _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer, k_stage,
                v_stage)
    require(k_pages is None or k_stage is None,
            "staging is the pool-less form's (rope_kv_update_all_layers "
            "takes both)")
    B = q.shape[0]
    require(q.shape[1] == 1, f"a decode step has T = 1, got {q.shape[1]}")
    tensors = [q, k, cos, sin]
    if k_pages is not None:
        tensors += _decode_rows(B, page_table, positions, active)
        tensors += [v, k_pages, v_pages]
    if k_stage is not None:
        tensors += [v, k_stage, v_stage]
    if not on_cuda(tensors):
        return rope_kv_update_layer_plain(
            q, k, v, cos, sin, k_pages, v_pages, page_table, positions,
            active, int(layer), k_stage=k_stage, v_stage=v_stage)
    _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, positions,
                 None, active, int(layer), k_stage, v_stage)
    count_launch(rope_kv_update_layer)
    return q, k


rope_kv_update_layer.launches = 0


def _decode_rows(B: int, page_table, positions, active):
    """Checks a decode step's row metadata; returns it as a list."""
    check("page_table", page_table, 2, torch.int32)
    check("positions", positions, 1, torch.int32)
    check("active", active, 1, torch.bool)
    require(page_table.shape[0] == B and positions.shape[0] == B
            and active.shape[0] == B, "batch sizes disagree")
    return [page_table, positions, active]


def _all_layers_plain(k_pages, v_pages, k_stage, v_stage, page_table,
                      positions, active, layer: int) -> None:
    """Plain: K6's scatter of staged layers 0..layer into the pools."""
    n = layer + 1
    L, B = k_stage.shape[0], positions.shape[0]
    rows = k_pages.shape[3:]
    attention.write_decode_kv_all_layers(
        k_pages[:n], v_pages[:n], k_stage.view(L, B, *rows)[:n],
        v_stage.view(L, B, *rows)[:n], page_table, positions, active)


def rope_kv_update_all_layers_plain(q, k, v, cos, sin, k_pages, v_pages,
                                    page_table, positions, active,
                                    layer: int, k_stage, v_stage):
    """Plain version: the pool-less writer with staging (``rotate`` of q
    and k, the copy into slot ``layer``), then the scatter reference of
    K6 (``write_decode_kv_all_layers``) of slots 0..layer."""
    rope_kv_update_layer_plain(q, k, v, cos, sin, layer=layer,
                               k_stage=k_stage, v_stage=v_stage)
    _all_layers_plain(k_pages, v_pages, k_stage, v_stage, page_table,
                      positions, active, layer)
    return q, k


def rope_kv_update_all_layers(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, cos: torch.Tensor,
                              sin: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              page_table: torch.Tensor,
                              positions: torch.Tensor, active: torch.Tensor,
                              layer: int, k_stage: torch.Tensor,
                              v_stage: torch.Tensor):
    """K6 folded into the last layer's fused writer (the attend-then-write
    decode step): as ``rope_kv_update_layer`` with staging, rotate q and
    k of layer ``layer`` in place and put the rotated k and v in slot
    ``layer`` of ``k_stage``/``v_stage`` [L, B, Hkv, D], and in the same
    launch write slots 0..layer (this layer's rows from the values just
    rotated) into pool layers 0..layer at ``positions``, as
    ``paged_kv_update`` writes them (inactive rows, NULL page 0 and
    positions past the table write nothing). Returns (q, k).

    Writing before this layer attends is safe: its current-token
    attention reads pool positions below the cache length (= positions)
    only, and the current row from the staging slot."""
    _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer, k_stage,
                v_stage)
    B = q.shape[0]
    require(q.shape[1] == 1, f"a decode step has T = 1, got {q.shape[1]}")
    tensors = [q, k, v, cos, sin, k_pages, v_pages, k_stage, v_stage]
    tensors += _decode_rows(B, page_table, positions, active)
    if not on_cuda(tensors):
        return rope_kv_update_all_layers_plain(
            q, k, v, cos, sin, k_pages, v_pages, page_table, positions,
            active, int(layer), k_stage, v_stage)
    _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, positions,
                 None, active, int(layer), k_stage, v_stage, all_layers=True)
    count_launch(rope_kv_update_all_layers)
    return q, k


rope_kv_update_all_layers.launches = 0


def rope_prefill_kv_update_layer_plain(q, k, v, cos, sin, k_pages=None,
                                       v_pages=None, page_table=None,
                                       start_pos=None, lengths=None,
                                       layer: int = 0, *, k_stage=None,
                                       v_stage=None):
    """Plain version: ``rotate`` of q and of k (in place), then the
    scatter reference of ``ops/attention.py``, or the copy into the
    staging slot."""
    q.copy_(rope.rotate(q, cos, sin))
    k.copy_(rope.rotate(k, cos, sin))
    if k_pages is not None:
        attention.write_prefill_kv_layer(k_pages, v_pages, k, v, page_table,
                                         start_pos, lengths, layer)
    if k_stage is not None:
        _stage_rows(k_stage, layer, k)
        _stage_rows(v_stage, layer, v)
    return q, k


def rope_prefill_kv_update_layer(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor,
                                 k_pages: Optional[torch.Tensor] = None,
                                 v_pages: Optional[torch.Tensor] = None,
                                 page_table: Optional[torch.Tensor] = None,
                                 start_pos: Optional[torch.Tensor] = None,
                                 lengths: Optional[torch.Tensor] = None,
                                 layer: int = 0, *,
                                 k_stage: Optional[torch.Tensor] = None,
                                 v_stage: Optional[torch.Tensor] = None):
    """K2 fused with the rope of its layer body: rotate a window's q
    [B, T, Hq, D] and k [B, T, Hkv, D] in place by cos/sin [B, T, D/2]
    (every token, padding included), then write the rotated k and v into
    layer ``layer`` of the pools as ``paged_prefill_kv_update_layer``
    does (token t of row b at start_pos[b] + t; t >= lengths[b], NULL
    pages and positions past the table dropped; any start). The ragged
    step's windows and decode rows take the same call. Without pools,
    only the rotation, and with ``k_stage``/``v_stage`` (staging buffers
    [L, B, T, Hkv, D]) the rotated k and v also go to their slot
    ``layer``. Returns (q, k)."""
    _check_rope(q, k, v, cos, sin, k_pages, v_pages, layer, k_stage,
                v_stage)
    require(k_pages is None or k_stage is None,
            "staging is the pool-less form's")
    B = q.shape[0]
    tensors = [q, k, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("start_pos", start_pos, 1, torch.int32)
        check("lengths", lengths, 1, torch.int32)
        require(page_table.shape[0] == B and start_pos.shape[0] == B
                and lengths.shape[0] == B, "batch sizes disagree")
        tensors += [v, k_pages, v_pages, page_table, start_pos, lengths]
    if k_stage is not None:
        tensors += [v, k_stage, v_stage]
    if not on_cuda(tensors):
        return rope_prefill_kv_update_layer_plain(
            q, k, v, cos, sin, k_pages, v_pages, page_table, start_pos,
            lengths, int(layer), k_stage=k_stage, v_stage=v_stage)
    _launch_rope(q, k, v, cos, sin, k_pages, v_pages, page_table, start_pos,
                 lengths, None, int(layer), k_stage, v_stage)
    count_launch(rope_prefill_kv_update_layer)
    return q, k


rope_prefill_kv_update_layer.launches = 0


def _latent_plain(ckv, weight, cos, sin, eps: float, interleave: bool):
    """[rms_norm(c) | rope(k_pe)] of ckv [B, T, r + dr], as [B, T, 1,
    r + dr]: the MLA layer body's unfused chain."""
    r = weight.shape[0]
    rot = rope.rotate_interleaved if interleave else rope.rotate
    return torch.cat([rms_norm(ckv[..., :r], weight, eps),
                      rot(ckv[..., r:], cos, sin)], dim=-1)[:, :, None, :]


def _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer,
                  stage=None) -> None:
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
    if stage is not None:
        _check_stage("stage", stage, ckv, layer)


def _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
                   page_table, start, lengths, active, layer: int,
                   stage=None, all_layers: bool = False):
    """Returns the layer's latent rows [B, T, 1, W]: slot ``layer`` of
    ``stage`` when given, else a new tensor."""
    B, T, W = ckv.shape
    r = weight.shape[0]
    require(ckv.dtype == torch.bfloat16 and weight.dtype == torch.bfloat16,
            f"the kernel builds bf16 latents, got {ckv.dtype} / "
            f"{weight.dtype}")
    require(r % 8 == 0 and W % 8 == 0, f"the kernel needs kv_lora_rank "
            f"and the row width % 8 == 0, got {r} and {W}")
    if stage is None:
        out, slot = torch.empty(1, B, T, 1, W, dtype=ckv.dtype,
                                device=ckv.device), 0
    else:
        out, slot = stage, int(layer)
    tensors = [("ckv", ckv), ("weight", weight), ("latent", out)]
    if k_pages is None:
        MP = ps = num_pages = 0
    else:
        tensors += [("k_pages", k_pages), ("v_pages", v_pages)]
        MP, ps, num_pages = page_table.shape[1], k_pages.shape[2], \
            k_pages.shape[1]
    for name, t in tensors:
        _aligned(name, t)
    rc = _kernel().latent_kv_write(
        ptr(ckv), ptr(weight), ptr(cos), ptr(sin), float(eps),
        int(bool(interleave)), ptr(out), slot, ptr(k_pages), ptr(v_pages),
        ptr(page_table), ptr(start), ptr(lengths), ptr(active), B, T, r,
        W - r, MP, ps, num_pages, int(layer), int(all_layers), stream())
    raise_on_error("latent_kv_write", rc)
    return out[slot].view(B, T, 1, W)


def latent_kv_update_layer_plain(ckv, weight, cos, sin, eps: float,
                                 interleave: bool, k_pages=None, v_pages=None,
                                 page_table=None, positions=None, active=None,
                                 layer: int = 0, *, stage=None):
    """Plain version: ``rms_norm``, the rope of k_pe and a ``cat``, then
    the scatter reference of ``ops/attention.py`` into both pools, or
    the copy into the staging slot (returned)."""
    latent = _latent_plain(ckv, weight, cos, sin, eps, interleave)
    if k_pages is not None:
        lat = latent[:, 0]
        attention.write_decode_kv_layer(k_pages, v_pages, lat, lat,
                                        page_table, positions, active, layer)
    if stage is not None:
        _stage_rows(stage, layer, latent)
        return stage[layer].view(latent.shape)
    return latent


def latent_kv_update_layer(ckv: torch.Tensor, weight: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor, eps: float,
                           interleave: bool,
                           k_pages: Optional[torch.Tensor] = None,
                           v_pages: Optional[torch.Tensor] = None,
                           page_table: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None,
                           layer: int = 0, *,
                           stage: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1 fused with the MLA latent of its layer body: from one decode
    token's ckv = h @ kv_a [B, 1, r + dr], build the latent row [B, 1, 1,
    r + dr] = [rms_norm(ckv[:r]) * ``weight`` (kv_a_norm, eps) |
    rope(ckv[r:]) by cos/sin [B, 1, dr/2] (adjacent pairs when
    ``interleave``, else halves)], write it into layer ``layer`` of both
    pools as ``paged_kv_update_layer`` does, and return it. Without
    pools, only the row (attend-then-write), built into slot ``layer``
    of ``stage`` (a staging buffer [L, B, 1, r + dr]) when given."""
    _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer, stage)
    require(k_pages is None or stage is None,
            "staging is the pool-less form's (latent_kv_update_all_layers "
            "takes both)")
    B = ckv.shape[0]
    require(ckv.shape[1] == 1, f"a decode step has T = 1, got "
            f"{ckv.shape[1]}")
    tensors = [ckv, weight, cos, sin]
    if k_pages is not None:
        tensors += _decode_rows(B, page_table, positions, active)
        tensors += [k_pages, v_pages]
    if stage is not None:
        tensors.append(stage)
    if not on_cuda(tensors):
        return latent_kv_update_layer_plain(
            ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
            page_table, positions, active, int(layer), stage=stage)
    latent = _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages,
                            v_pages, page_table, positions, None, active,
                            int(layer), stage)
    count_launch(latent_kv_update_layer)
    return latent


latent_kv_update_layer.launches = 0


def latent_kv_update_all_layers_plain(ckv, weight, cos, sin, eps: float,
                                      interleave: bool, k_pages, v_pages,
                                      page_table, positions, active,
                                      layer: int, stage):
    """Plain version: the latent chain into slot ``layer`` of the
    staging buffer, then the scatter reference of K6 of slots 0..layer
    into both pools."""
    latent = latent_kv_update_layer_plain(ckv, weight, cos, sin, eps,
                                          interleave, layer=layer,
                                          stage=stage)
    _all_layers_plain(k_pages, v_pages, stage, stage, page_table, positions,
                      active, layer)
    return latent


def latent_kv_update_all_layers(ckv: torch.Tensor, weight: torch.Tensor,
                                cos: torch.Tensor, sin: torch.Tensor,
                                eps: float, interleave: bool,
                                k_pages: torch.Tensor, v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                positions: torch.Tensor,
                                active: torch.Tensor, layer: int,
                                stage: torch.Tensor) -> torch.Tensor:
    """K6 folded into the last layer's fused latent writer (the
    attend-then-write decode step of an MLA model): as
    ``latent_kv_update_layer`` with staging, build layer ``layer``'s
    latent row into slot ``layer`` of ``stage`` [L, B, 1, r + dr], and in
    the same launch write slots 0..layer into layers 0..layer of both
    pools at ``positions``, as ``paged_kv_update`` writes the latent rows
    (the layer's own from the values just built). Returns the latent
    [B, 1, 1, r + dr] (the staging slot)."""
    _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer, stage)
    B = ckv.shape[0]
    require(ckv.shape[1] == 1, f"a decode step has T = 1, got "
            f"{ckv.shape[1]}")
    tensors = [ckv, weight, cos, sin, k_pages, v_pages, stage]
    tensors += _decode_rows(B, page_table, positions, active)
    if not on_cuda(tensors):
        return latent_kv_update_all_layers_plain(
            ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
            page_table, positions, active, int(layer), stage)
    latent = _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages,
                            v_pages, page_table, positions, None, active,
                            int(layer), stage, all_layers=True)
    count_launch(latent_kv_update_all_layers)
    return latent


latent_kv_update_all_layers.launches = 0


def latent_prefill_kv_update_layer_plain(ckv, weight, cos, sin, eps: float,
                                         interleave: bool, k_pages=None,
                                         v_pages=None, page_table=None,
                                         start_pos=None, lengths=None,
                                         layer: int = 0, *, stage=None):
    """Plain version: the latent chain, then the window scatter reference
    of ``ops/attention.py`` into both pools, or the copy into the staging
    slot (returned)."""
    latent = _latent_plain(ckv, weight, cos, sin, eps, interleave)
    if k_pages is not None:
        attention.write_prefill_kv_layer(k_pages, v_pages, latent, latent,
                                         page_table, start_pos, lengths,
                                         layer)
    if stage is not None:
        _stage_rows(stage, layer, latent)
        return stage[layer].view(latent.shape)
    return latent


def latent_prefill_kv_update_layer(ckv: torch.Tensor, weight: torch.Tensor,
                                   cos: torch.Tensor, sin: torch.Tensor,
                                   eps: float, interleave: bool,
                                   k_pages: Optional[torch.Tensor] = None,
                                   v_pages: Optional[torch.Tensor] = None,
                                   page_table: Optional[torch.Tensor] = None,
                                   start_pos: Optional[torch.Tensor] = None,
                                   lengths: Optional[torch.Tensor] = None,
                                   layer: int = 0, *,
                                   stage: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """K2 fused with the MLA latent: ``latent_kv_update_layer`` for a
    window ckv [B, T, r + dr], written as
    ``paged_prefill_kv_update_layer`` writes (positions start_pos[b] + t,
    t < lengths[b]). Returns the latent [B, T, 1, r + dr], every token's
    (padding included): slot ``layer`` of ``stage`` (a staging buffer
    [L, B, T, 1, r + dr], the pool-less form) when given."""
    _check_latent(ckv, weight, cos, sin, k_pages, v_pages, layer, stage)
    require(k_pages is None or stage is None,
            "staging is the pool-less form's")
    B = ckv.shape[0]
    tensors = [ckv, weight, cos, sin]
    if k_pages is not None:
        check("page_table", page_table, 2, torch.int32)
        check("start_pos", start_pos, 1, torch.int32)
        check("lengths", lengths, 1, torch.int32)
        require(page_table.shape[0] == B and start_pos.shape[0] == B
                and lengths.shape[0] == B, "batch sizes disagree")
        tensors += [k_pages, v_pages, page_table, start_pos, lengths]
    if stage is not None:
        tensors.append(stage)
    if not on_cuda(tensors):
        return latent_prefill_kv_update_layer_plain(
            ckv, weight, cos, sin, eps, interleave, k_pages, v_pages,
            page_table, start_pos, lengths, int(layer), stage=stage)
    latent = _launch_latent(ckv, weight, cos, sin, eps, interleave, k_pages,
                            v_pages, page_table, start_pos, lengths, None,
                            int(layer), stage)
    count_launch(latent_prefill_kv_update_layer)
    return latent


latent_prefill_kv_update_layer.launches = 0
