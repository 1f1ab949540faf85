"""In-place paged KV writers for one layer (CUDA kernel ``csrc/kv_update.cu``).

Replace the Pallas kernels ``paged_kv_update_layer`` (decode row,
xllm_service_tpu/ops/pallas/kv_update.py:162) and
``paged_prefill_kv_update_layer`` (prefill window, :336). Both run in
the write-then-attend layer body: each layer writes its fresh K/V into
the pool before its attention reads the pool.

The Pallas kernels took the whole [L, P, ps, Hkv, D] pool with the layer
as a scalar-prefetch operand, so that no per-layer slice was
materialized. In PyTorch ``k_pages[layer]`` is a view of the full pool,
free to take, so the kernel writes into that view in place and needs no
aliasing declaration.

Bound on an H100: bytes (each fresh row read once and written once).
"""

from __future__ import annotations

import torch

from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops.kernels import _build
from xllm_service_tpu_torch.ops.kernels._launch import (
    I, P, check, on_cuda, ptr, raise_on_error, require, stream)

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("kv_update")
        lib.kv_write.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.kv_write.restype = I
        _lib = lib
    return _lib


def _check_pools(k_pages, v_pages, k_new, v_new, layer) -> None:
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
    require(0 <= int(layer) < k_pages.shape[0],
            f"layer {layer} outside [0, {k_pages.shape[0]})")


def _launch(k_pages, v_pages, k_new, v_new, page_table, start, lengths,
            active, layer: int, T: int) -> None:
    L, num_pages, ps, Hkv, D = k_pages.shape
    row_bytes = Hkv * D * k_pages.element_size()
    require(row_bytes % 16 == 0,
            f"a pool row of {row_bytes} bytes is not a multiple of 16")
    rc = _kernel().kv_write(
        ptr(k_pages[layer]), ptr(v_pages[layer]), ptr(k_new), ptr(v_new),
        ptr(page_table), ptr(start), ptr(lengths), ptr(active),
        page_table.shape[0], T, page_table.shape[1], ps, num_pages,
        row_bytes, stream())
    raise_on_error("kv_write", rc)


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
