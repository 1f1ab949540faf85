"""KV-migration transport probe: the bandwidth of each PD handoff path.

The counterpart of the JAX package's ``runtime/kv_transfer.py``. Three
paths move a held prefill's page block to a decode engine:

- **direct**: both engines in one process on one device; the gathered
  block stays a device tensor and lands in the decode pools through one
  ``index_copy_`` (``Engine.export_held(device=True)`` then
  ``Engine.import_sequence``);
- **host shuttle**: the cross-process path of the worker's ``/kv/import``
  (device to host, to bytes, back to a tensor, to the device, scatter);
- **pipelined host shuttle**: the chunked form of it (the worker's
  ``_shuttle_send_chunks`` and ``/kv/chunk``): the block is sliced along
  the layers, every device-to-host copy is started first into pinned
  buffers with an event each, and each chunk is uploaded as its event
  completes, so the two directions overlap.

``probe_kv_migration`` times each on two engines of the same pool layout.
It synchronizes with the device (on the CPU there is nothing to wait
for); the HTTP hop itself is not simulated.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from xllm_service_tpu_torch.runtime.engine import Engine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_buffer(t: torch.Tensor) -> torch.Tensor:
    """An empty host tensor like ``t``, pinned when ``t`` is on a GPU (a
    non-blocking copy into pageable memory would be synchronous)."""
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=t.device.type == "cuda")


def start_host_copies(k: torch.Tensor, v: torch.Tensor, chunks: int
                      ) -> List[Tuple[int, int, torch.Tensor, torch.Tensor,
                                      object]]:
    """Slice (k, v) into ``chunks`` spans of layers and start every
    device-to-host copy at once, each into its own host buffer and
    followed by an event. Returns [(lo, hi, k_host, v_host, event)];
    ``event`` is None on the CPU, where the copy is done on return."""
    L = int(k.shape[0])
    bounds = [(i * L // chunks, (i + 1) * L // chunks)
              for i in range(chunks)]
    out = []
    for lo, hi in bounds:
        if hi <= lo:
            continue
        kh, vh = _host_buffer(k[lo:hi]), _host_buffer(v[lo:hi])
        kh.copy_(k[lo:hi], non_blocking=True)
        vh.copy_(v[lo:hi], non_blocking=True)
        ev = None
        if k.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        out.append((lo, hi, kh, vh, ev))
    return out


def probe_kv_migration(src: Engine, dst: Engine, n_pages: int = 16,
                       iters: int = 5) -> Dict[str, float]:
    """Move an ``n_pages`` KV block from ``src`` to ``dst`` by each path,
    ``iters`` timed repetitions after one untimed. The engines must share
    the pool layout. Returns {"bytes", "pages", "direct_gbps",
    "host_gbps", "host_pipelined_gbps"}, ``pages`` the count actually
    moved (clamped to the smaller pool)."""
    ks, vs = src.kv
    kd, vd = dst.kv
    if ks.shape[0:1] + ks.shape[2:] != kd.shape[0:1] + kd.shape[2:]:
        raise ValueError("engines have different KV pool layouts")
    n_pages = min(n_pages, ks.shape[1] - 1, kd.shape[1] - 1)
    if n_pages < 1:
        raise ValueError("pool too small to probe (needs >= 2 pages)")
    src_idx = torch.arange(1, n_pages + 1, device=ks.device)
    dst_idx = torch.arange(1, n_pages + 1, device=kd.device)
    nbytes = 2 * n_pages * (ks.numel() // ks.shape[1]) * ks.element_size()

    def scatter(k: torch.Tensor, v: torch.Tensor) -> None:
        kd.index_copy_(1, dst_idx, k.to(device=kd.device, dtype=kd.dtype))
        vd.index_copy_(1, dst_idx, v.to(device=vd.device, dtype=vd.dtype))
        _sync(kd.device)

    def direct_once() -> None:
        scatter(ks.index_select(1, src_idx), vs.index_select(1, src_idx))

    def host_once() -> None:
        k = ks.index_select(1, src_idx).cpu()
        v = vs.index_select(1, src_idx).cpu()
        # Through bytes, as the wire carries them.
        k2 = torch.frombuffer(bytearray(k.view(torch.uint8).numpy()
                                        .tobytes()),
                              dtype=k.dtype).view(k.shape)
        v2 = torch.frombuffer(bytearray(v.view(torch.uint8).numpy()
                                        .tobytes()),
                              dtype=v.dtype).view(v.shape)
        scatter(k2, v2)

    def host_pipelined_once() -> None:
        kb = ks.index_select(1, src_idx)
        vb = vs.index_select(1, src_idx)
        parts = start_host_copies(kb, vb, max(2, min(int(kb.shape[0]), 8)))
        up_k, up_v = [], []
        for _, _, kh, vh, ev in parts:
            if ev is not None:
                ev.synchronize()
            up_k.append(kh.to(kd.device, non_blocking=True))
            up_v.append(vh.to(kd.device, non_blocking=True))
        scatter(torch.cat(up_k), torch.cat(up_v))

    out: Dict[str, float] = {"bytes": float(nbytes),
                             "pages": float(n_pages)}
    for name, fn in (("direct", direct_once), ("host", host_once),
                     ("host_pipelined", host_pipelined_once)):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters
        out[f"{name}_gbps"] = nbytes / dt / 1e9
    return out
