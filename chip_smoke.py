#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. Device: the card's name and power limit (nvidia-smi).
2. Build: every CUDA kernel of ``xllm_service_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (parallel, one nvcc per source).
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors at the serving shapes of llama3-1b (B=8 decode rows,
   a 4-row prefill window batch, a ragged batch of 7 decode rows and a
   256-token window in a T=256 bucket, page size 128, bf16), in both
   orders of the KV write: the one-layer writers K1/K2 and the pool-only
   attention K3/K4 (write-then-attend), the all-layer writers K6/K7 over
   16 layers (also at the MLA latent row, Hkv=1 and D=576) and the
   attention forms K3' (current token held apart; a row with cache
   length 0 compared like the others) and K4' (fresh window operands)
   of attend-then-write, whose pools hold random stale values where the
   current token or the window would sit. KV writers must be bit-exact;
   attention must agree within atol = rtol = 2e-2 (bf16 outputs; the
   plain version rounds its probabilities to bf16 before P @ V) on
   active rows / valid query rows, with plain, windowed, soft-capped and
   sink cases; a ragged row of length 0 must come out finite. Each
   kernel is timed with CUDA events (>= 20 launches after warm-up)
   beside its plain version, one PyTorch library call computing the
   same function, and its bound (bytes over 3.35 TB/s or operations
   over 989 TFLOP/s, whichever is larger); the ragged kernel K5 also
   beside the split path's two launches for the same work (decode kernel
   on the decode rows, prefill kernel on the window) and alone on its
   decode rows and on its window, with its split count and grid, its
   bound counting the whole [B, T, Hq, D] output written once
   (``bound_ms_valid_rows_only``: the count that takes only the valid
   rows, kept for comparison with older records), and at long decode
   rows (8 x 2048-4096 keys beside a 256-token window,
   ``ragged_paged_attention_long``, held to atol = rtol = 5e-3, the
   reference's RMS beside its error); the blocks with work and the work
   items, as the host rule ``ragged_work`` derives them (not measured),
   go to a ``[kernel]`` line of their own; K6 beside 16 K1 launches for the
   same rows. Then K3'', the MLA decode attention, in
   both forms at DeepSeek-V2-Lite's decode shape (B=8, 16 heads, one
   576-wide latent head, a 27-layer pool; contexts 117-411 with an
   inactive row, and for the current form a row at cache length 0 and
   stale slots), timed beside gather + SDPA over the latent as K and V
   of every head; and K1/K2 bit-exact at the latent row. Then the layer
   body's writers as the serving path runs them, fused with their
   neighbours: K1 and K2 fused with the rope of q and k
   (``rope_kv_update_layer``, ``rope_prefill_kv_update_layer``:
   bit-exact against their plain version, two ``rotate`` + the scatter,
   in decode, prefill, ragged-window and pool-less modes) and with the
   MLA latent row (``latent_kv_update_layer``,
   ``latent_prefill_kv_update_layer`` at DeepSeek-V2-Lite's geometry:
   within 2e-2, the rope columns bit-exact, with pools and without), each
   timed beside the unfused chain it replaces in one CUDA graph
   (``unfused_ms``) and K1 / K2 alone (``writer_only_ms``). K6 folded
   into the last layer's writer: the all-layer modes
   (``rope_kv_update_all_layers`` over llama3-1b's 16 layers,
   ``latent_kv_update_all_layers`` over DeepSeek-V2-Lite's 27) against
   their plain versions (the dense one and the staged layers bit-exact,
   the latent row within 2e-2 with its rope columns exact) and the
   unfused chain they replace (pool-less writer, ``torch.stack``, K6),
   timed beside that chain in one CUDA graph and K6 alone; and K3' and
   K3'' current shown blind to NaN at the slot where the fold writes
   the current rows. The split-KV
   decode kernels (K3, K3', K3'') are also checked and timed at long
   contexts, B = 8 rows of 2048-4096 keys (seeded) and B = 1 row of
   4096 (records ``*_long_b8`` / ``*_long_b1``), and every K3/K3'/K3''
   record carries the split count the wrapper chose (``splits``) and the
   same kernel's time at one split (``unsplit_ms``, checked too); the
   pool-only long records also time the split counts 4-64
   (``split_sweep_ms``). K4, K4'
   and K5's window tiles (the tile code they share), and K3 and K3' at
   1, 3 and the wrappers' splits, are also held at D = 128 (G = 3) and
   D = 256 (G = 4) on a small pool of page size 16,
   and at a long prompt (B = 2 x T = 2048 at q_start 0/2048, page
   tables of 32 pages), in all four argument sets; K4 and K4' are timed
   at the long prompt too (records ``*_long_prompt``, bound by the
   tensor cores' operations, with their share of the bound).
4. Forward: a full-width llama3-1b forward_prefill + forward_decode + a
   ragged forward_prefill through the kernels (bf16 on the GPU), and
   the attend-then-write order (two prefill windows, the second at
   q_start > 0, then a decode step), each against the plain path
   (float32 on the CPU, same weights): logits within a relative L2
   error of 5e-2 (16 bf16 layers against float32). Then DeepSeek-V2-
   Lite at full width in both orders (prefill + decode; prefill x2 +
   decode), its depth cut to 4 layers (the dense one and 3 MoE layers:
   the float32 CPU copy of all 27 would be 63 GB), to the same bound;
   each of its decode forwards must launch K3'' once per layer. Each
   model's largest absolute logit error is kept for phase 5's margins.
5. Serving: the worker the CLI builds (``runtime.worker`` with
   --model llama3-1b --page-size 128 --num-pages 512 --max-model-len 1024
   --max-batch-size 8, prefill buckets 128,256,512, 256 prefill tokens
   per step so the longer prompts prefill in chunks) answers 4
   concurrent requests (2 streamed chats, 2 non-streamed completions,
   prompts of 100-400 tokens, 32 new tokens, temperature 0), with the
   ragged step off and XLLM_WRITE_THEN_ATTEND=1. Launch counts are
   zeroed just before and read just after, and counted per engine step:
   every decode forward must launch the fused rope writer and K3 once
   per layer, every prefill forward the fused prefill writer and K4 once
   per layer, and nothing else (in every phase below as well: the
   unfused K1/K2 never run on a served path). Then one streamed request
   is served again under torch.profiler (device time by kernel, idle
   share, launches per forward, the decode attention kernels', the
   writers' and PyTorch's elementwise and copy kernels' device ms).
5b. Serving, ragged: the same worker, flags and requests with
   XLLM_RAGGED_ATTN=1. At least one mixed iteration must run as one
   ragged forward, each launching the fused prefill writer and the
   ragged kernel once per layer and neither the decode nor the prefill
   attention kernel.
5c. Serving, attend-then-write: the same worker, flags and requests
   with XLLM_WRITE_THEN_ATTEND=0 (ragged off). Every decode forward
   must launch the fused rope writer (no pools: rotation into the
   staging buffer) for every layer but the last, its all-layer mode
   (``rope_kv_update_all_layers``, K6 folded in) for the last, and K3'
   once per layer; every prefill forward the fused prefill writer and
   K4' once per layer and K7 once; K1-K6 never. One request is profiled
   as in phase 5.
5d. Serving DeepSeek-V2-Lite: the worker with --model deepseek-v2-lite
   (all 27 layers, random bf16 weights, 31.4 GB), the same flags and
   requests, in the GPU default order (write-then-attend). Every decode
   forward must launch the fused latent writer and K3'' once per layer,
   every prefill forward the fused latent prefill writer once per layer
   (its attention is plain), and K1-K5 never. One streamed request is
   profiled as in phase 5.
5e. The same with XLLM_WRITE_THEN_ATTEND=0: every decode forward the
   fused latent writer (no pools) for every layer but the last, its
   all-layer mode (``latent_kv_update_all_layers``) for the last, and
   K3'' (current form) once per layer, every prefill forward the fused
   latent prefill writer once per layer and K7 once, K1-K6 never.
   Profiled as 5d.
   Each worker's weights are freed before the next phase.
   Margins: each model's phases serve the same weights, so on the live
   engine of 5c (and 5e) the script reads, at each stream's first
   divergent token between phase 5 and 5b, 5 and 5c (5d and 5e), the
   top-2 logit margin of one prefill forward over the common prefix on
   the card through both paths and, for llama3-1b, under the plain
   float32 path on the CPU (``[margins]``): wider than 10 x phase 4's
   largest logit error for the model is a fault, narrower is drift.
   ``[profile]`` prints the launches per forward of 5, 5c, 5d and 5e.
6. Summary: one line ``{"kernels": [...]}`` (K1-K4 and the fused rope
   writers' launches from phase 5 (K1/K2 now 0), K5 from 5b, K6 (now 0),
   K7, K3', K4' and the dense all-layer mode from 5c, K3'' and the fused
   latent writers from 5d, the current form of K3'' and the latent
   all-layer mode from 5e; a record at another shape takes its kernel's
   count), the card line, then the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
ATTN_TOL = 2e-2
# K5 at long decode rows: outputs ~0.03 RMS, where ATTN_TOL is the size
# of a value (its error there read 0.0020 on an H100).
LONG_ROW_TOL = 5e-3
FORWARD_REL_L2 = 5e-2
CSRC = "xllm_service_tpu_torch/ops/kernels/csrc"
PALLAS = "xllm_service_tpu/ops/pallas"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 30, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed, timed with CUDA events. Host overhead (Python,
    argument checks) is outside the graph, so this is the kernels' own
    time back to back."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask, scale=None):
    """One library call: q [B, Hq, Tq, D]; k/v [B, Hkv, S, D]."""
    import torch
    import torch.nn.functional as F
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True, scale=scale)
    g = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        attn_mask=mask, scale=scale)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

class KernelBench:
    """Serving-shape inputs for llama3-1b and the checks/timings of the
    four kernels."""

    def __init__(self, torch, cfg, device) -> None:
        self.torch = torch
        self.cfg = cfg
        self.dev = torch.device(device)
        self.g = torch.Generator(device=self.dev).manual_seed(1234)
        self.L, self.P, self.ps = 4, 512, 128
        self.Hq, self.Hkv, self.D = cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.MP = 8                                   # 1024 / 128
        shape = (self.L, self.P, self.ps, self.Hkv, self.D)
        self.kp = self.randn(*shape)
        self.vp = self.randn(*shape)
        # Disjoint page tables, as the allocator hands them out.
        perm = torch.randperm(self.P - 1, generator=self.g,
                              device=self.dev)[:8 * self.MP] + 1
        self.pt8 = perm.reshape(8, self.MP).to(torch.int32).contiguous()
        self.layer = 2
        self.results = []

    def randn(self, *shape, dtype=None):
        t = self.torch.randn(shape, generator=self.g, device=self.dev)
        return t.to(dtype or self.torch.bfloat16)

    def i32(self, xs):
        return self.torch.tensor(xs, dtype=self.torch.int32, device=self.dev)

    def record(self, name, source, replaces, err, kernel, plain, library,
               nbytes, flops, peak=PEAK_BF16_FLOPS, **extra):
        """Time ``kernel`` (the wrapper) and ``library`` as device time
        (graph replay), the wrapper also per eager call (device time plus
        its host overhead), and ``plain`` per eager call (it syncs with
        the host, so it cannot be captured). ``library`` None: no one
        PyTorch call computes the same function (``library_ms`` null).
        ``peak``: the operations' rate (the fused writers' float32
        arithmetic runs outside the tensor cores)."""
        ms = graph_ms(kernel)
        lib_ms = graph_ms(library) if library is not None else None
        eager_ms, plain_ms = time_ms(kernel), time_ms(plain)
        b_ms, b_by = bound(nbytes, flops, peak)
        self.results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "library_ms": lib_ms, **extra})
        log(f"[kernel] {name}: max_abs_err={err} ms={ms:.5f} "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={lib_ms} bound_ms={b_ms:.6f} ({b_by}, "
            f"{b_ms / ms:.4f} of it) {json.dumps(extra)}")

    def latent_pools(self):
        """A 4-layer pool pair of the MLA latent row (Hkv=1, D=576) with
        its own disjoint page table."""
        P = 128
        kp, vp = self.randn(4, P, self.ps, 1, 576), \
            self.randn(4, P, self.ps, 1, 576)
        perm = self.torch.randperm(P - 1, generator=self.g,
                                   device=self.dev)[:8 * self.MP] + 1
        return kp, vp, perm.reshape(8, self.MP).to(
            self.torch.int32).contiguous()

    # -- K1 ----------------------------------------------------------------
    def decode_writer(self, kv, pools=None):
        """K1 at llama3-1b's rows, timed; with ``pools`` (k, v, page
        table) at their geometry, checked only."""
        torch = self.torch
        kp, vp, pt8 = pools or (self.kp, self.vp, self.pt8)
        P, Hkv, D = kp.shape[1], kp.shape[3], kp.shape[4]
        B = 8
        row_bytes = Hkv * D * 2
        kn, vn = self.randn(B, Hkv, D), self.randn(B, Hkv, D)
        ctx = [117, 205, 298, 411, 150, 260, 333, 390]
        pos = self.i32([c - 1 for c in ctx])
        pt = pt8.clone()
        pt[5, 2] = 0                      # row 5's page is NULL: dropped
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)      # an inactive row
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        kv.paged_kv_update_layer(ka, va, kn, vn, pt, pos, active, self.layer)
        kv.paged_kv_update_layer_plain(kb, vb, kn, vn, pt, pos, active,
                                       self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError(f"decode KV writer is not bit-exact at "
                                 f"(Hkv, D) = {(Hkv, D)}")
        changed = int((ka != kp).flatten(2).any(-1).sum())
        if changed != 6:                           # rows 5 and 6 dropped
            raise AssertionError(f"decode writer touched {changed} pages")
        if pools is not None:
            log(f"[kernel] paged_kv_update_layer bit-exact at (Hkv, D) = "
                f"{(Hkv, D)}")
            return
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        pt = pt8
        flat = (pt.long().gather(1, (pos.long() // self.ps)[:, None])[:, 0]
                * self.ps + pos.long() % self.ps)
        kf = ka[self.layer].view(P * self.ps, Hkv, D)
        vf = va[self.layer].view(P * self.ps, Hkv, D)

        def lib():
            kf.index_copy_(0, flat, kn)
            vf.index_copy_(0, flat, vn)
        nbytes = B * 2 * 2 * row_bytes + B * (4 + 4 + 1 + 4)
        self.record(
            "paged_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:162", 0.0,
            lambda: kv.paged_kv_update_layer(ka, va, kn, vn, pt, pos, all_on,
                                             self.layer),
            lambda: kv.paged_kv_update_layer_plain(kb, vb, kn, vn, pt, pos,
                                                   all_on, self.layer),
            lib, nbytes, 0.0, superseded_by="rope_kv_update_layer, "
            "latent_kv_update_layer (no served path launches K1 alone)")

    # -- K2 ----------------------------------------------------------------
    def prefill_writer(self, kv, pools=None):
        """K2 at llama3-1b's rows, timed; with ``pools``, checked only."""
        torch = self.torch
        kp, vp, pt8 = pools or (self.kp, self.vp, self.pt8)
        P, Hkv, D = kp.shape[1], kp.shape[3], kp.shape[4]
        B, T = 4, 256
        row_bytes = Hkv * D * 2
        kn, vn = self.randn(B, T, Hkv, D), self.randn(B, T, Hkv, D)
        pt = pt8[:B].contiguous()
        start = self.i32([0, 256, 128, 7])            # last row unaligned
        lens = self.i32([256, 144, 200, 97])
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        kv.paged_prefill_kv_update_layer(ka, va, kn, vn, pt, start, lens,
                                         self.layer)
        kv.paged_prefill_kv_update_layer_plain(kb, vb, kn, vn, pt, start,
                                               lens, self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError(f"prefill KV writer is not bit-exact at "
                                 f"(Hkv, D) = {(Hkv, D)}")
        if pools is not None:
            log(f"[kernel] paged_prefill_kv_update_layer bit-exact at "
                f"(Hkv, D) = {(Hkv, D)}")
            return
        t = torch.arange(T, device=self.dev)
        valid = t[None, :] < lens.long()[:, None]
        pos = start.long()[:, None] + t[None, :]
        flat = (pt.long().gather(1, pos // self.ps) * self.ps
                + pos % self.ps)[valid]
        kr, vr = kn[valid], vn[valid]
        kf = ka[self.layer].view(P * self.ps, Hkv, D)
        vf = va[self.layer].view(P * self.ps, Hkv, D)

        def lib():
            kf.index_copy_(0, flat, kr)
            vf.index_copy_(0, flat, vr)
        n = int(lens.sum())
        nbytes = n * 2 * 2 * row_bytes + B * (4 * self.MP + 8)
        self.record(
            "paged_prefill_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:336", 0.0,
            lambda: kv.paged_prefill_kv_update_layer(ka, va, kn, vn, pt, start,
                                                     lens, self.layer),
            lambda: kv.paged_prefill_kv_update_layer_plain(
                kb, vb, kn, vn, pt, start, lens, self.layer),
            lib, nbytes, 0.0, superseded_by="rope_prefill_kv_update_layer, "
            "latent_prefill_kv_update_layer (no served path launches K2 "
            "alone)")

    # -- K1 / K2 fused with the rope of q and k ----------------------------
    def _rope_inputs(self, rope, B, T, starts):
        """Fresh q [B, T, Hq, D], k/v [B, T, Hkv, D] and llama3-1b's
        cos/sin [B, T, D/2] (its llama3 scaling) at starts[b] + t."""
        torch, cfg = self.torch, self.cfg
        pos = self.i32(starts).long()[:, None] \
            + torch.arange(T, device=self.dev)[None, :]
        cos, sin = rope.rope_cos_sin(pos, self.D, cfg.rope_theta,
                                     cfg.rope_scaling)
        return (self.randn(B, T, self.Hq, self.D),
                self.randn(B, T, self.Hkv, self.D),
                self.randn(B, T, self.Hkv, self.D), cos, sin)

    def _rope_same(self, fused, plain, q, k, v, cos, sin, pools, rest,
                   what):
        """``fused`` and ``plain`` on copies of the same q, k (and pools):
        the rotated q and k and both pools must be bit-exact, and the
        rotation must have changed q."""
        torch = self.torch
        outs = []
        for fn in (fused, plain):
            qc, kc = q.clone(), k.clone()
            pc = [p.clone() for p in pools] if pools else [None, None]
            fn(qc, kc, v, cos, sin, *pc, *rest)
            outs.append([qc, kc] + pc)
        torch.cuda.synchronize()
        for a, b, name in zip(*outs, ("q", "k", "k_pages", "v_pages")):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} is not bit-exact")
        if torch.equal(outs[0][0], q):
            raise AssertionError(f"{what}: q was not rotated")
        log(f"[kernel] {what} bit-exact")

    def rope_decode_writer(self, kv, rope):
        """K1 fused with the rope (``rope_kv_update_layer``) at llama3-1b's
        decode rows (B=8, contexts 117-411, row 6 inactive, row 5's page
        NULL): bit-exact with pools and without (attend-then-write), then
        timed beside the unfused chain it replaces (two ``rotate`` + K1,
        one CUDA graph) and K1 alone."""
        torch = self.torch
        B = 8
        positions = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        q, k, v, cos, sin = self._rope_inputs(rope, B, 1, positions)
        pos = self.i32(positions)
        pt = self.pt8.clone()
        pt[5, 2] = 0
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)
        for pools, rest, mode in (
                ((self.kp, self.vp), (pt, pos, active, self.layer), "decode"),
                (None, (), "pool-less decode")):
            self._rope_same(kv.rope_kv_update_layer,
                            kv.rope_kv_update_layer_plain, q, k, v, cos, sin,
                            pools, rest, f"rope_kv_update_layer ({mode})")
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        ka, va, qa, kq = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        kb, vb, qb, kqb = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        args = (self.pt8, pos, all_on, self.layer)

        def unfused():                    # the unfused chain it replaces
            qr, kr = rope.rotate(qa, cos, sin), rope.rotate(kq, cos, sin)
            kv.paged_kv_update_layer(ka, va, kr[:, 0], v[:, 0], *args)
            return qr
        # q and k read and written, v read, cos/sin read, k and v rows
        # written to the pool, the row metadata read.
        nbytes = (B * (2 * self.Hq + 3 * self.Hkv) * self.D * 2
                  + 2 * B * self.D // 2 * 4 + B * 2 * self.Hkv * self.D * 2
                  + B * (4 + 4 + 1 + 4))
        self.record(
            "rope_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:162", 0.0,
            lambda: kv.rope_kv_update_layer(qa, kq, v, cos, sin, ka, va,
                                            *args),
            lambda: kv.rope_kv_update_layer_plain(qb, kqb, v, cos, sin, kb,
                                                  vb, *args),
            None, nbytes, 6.0 * B * (self.Hq + self.Hkv) * self.D // 2,
            PEAK_FP32_FLOPS, entry="rope_kv_update_layer",
            unfused_ms=graph_ms(unfused),
            writer_only_ms=graph_ms(lambda: kv.paged_kv_update_layer(
                ka, va, kq[:, 0], v[:, 0], *args)))

    def rope_prefill_writer(self, kv, rope):
        """K2 fused with the rope (``rope_prefill_kv_update_layer``):
        bit-exact on the 4 x 256 prefill batch (one start unaligned), a
        ragged batch (7 decode rows at mid-page starts and a 256-token
        window in a T = 256 bucket) and without pools; timed on the
        prefill batch beside the unfused chain (two ``rotate`` + K2) and
        K2 alone."""
        torch = self.torch
        ragged_starts = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333)]
        for B, starts, lens, pools, mode in (
                (4, [0, 256, 128, 7], [256, 144, 200, 97], True, "prefill"),
                (8, ragged_starts + [0], [1] * 7 + [256], True,
                 "ragged window"),
                (4, [0, 256, 128, 7], [256, 144, 200, 97], False,
                 "pool-less prefill")):
            q, k, v, cos, sin = self._rope_inputs(rope, B, 256, starts)
            rest = (self.pt8[:B].contiguous(), self.i32(starts),
                    self.i32(lens), self.layer) if pools else ()
            self._rope_same(kv.rope_prefill_kv_update_layer,
                            kv.rope_prefill_kv_update_layer_plain, q, k, v,
                            cos, sin, (self.kp, self.vp) if pools else None,
                            rest, f"rope_prefill_kv_update_layer ({mode})")
        B, T = 4, 256
        starts, lens = [0, 256, 128, 7], [256, 144, 200, 97]
        q, k, v, cos, sin = self._rope_inputs(rope, B, T, starts)
        ka, va, qa, kq = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        kb, vb, qb, kqb = self.kp.clone(), self.vp.clone(), q.clone(), \
            k.clone()
        args = (self.pt8[:B].contiguous(), self.i32(starts), self.i32(lens),
                self.layer)

        def unfused():                    # the unfused chain it replaces
            qr, kr = rope.rotate(qa, cos, sin), rope.rotate(kq, cos, sin)
            kv.paged_prefill_kv_update_layer(ka, va, kr, v, *args)
            return qr
        n = sum(lens)
        nbytes = (B * T * (2 * self.Hq + 3 * self.Hkv) * self.D * 2
                  + 2 * B * T * self.D // 2 * 4
                  + n * 2 * self.Hkv * self.D * 2 + B * (4 * self.MP + 8))
        self.record(
            "rope_prefill_kv_update_layer", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:336", 0.0,
            lambda: kv.rope_prefill_kv_update_layer(qa, kq, v, cos, sin, ka,
                                                    va, *args),
            lambda: kv.rope_prefill_kv_update_layer_plain(
                qb, kqb, v, cos, sin, kb, vb, *args),
            None, nbytes, 6.0 * B * T * (self.Hq + self.Hkv) * self.D // 2,
            PEAK_FP32_FLOPS, entry="rope_prefill_kv_update_layer",
            unfused_ms=graph_ms(unfused),
            writer_only_ms=graph_ms(lambda: kv.paged_prefill_kv_update_layer(
                ka, va, kq, v, *args)))

    # -- K6 folded into the last layer's fused writer ----------------------
    def _fold_inputs(self, L, Hkv, D, P):
        """A decode step's rows for the all-layer mode: pools [L, P, 128,
        Hkv, D], staging [L, 8, Hkv, D] (random: the earlier layers'
        rows), positions 116-410 with row 6 inactive and row 5's page
        NULL."""
        torch = self.torch
        kp, vp = self.randn(L, P, self.ps, Hkv, D), \
            self.randn(L, P, self.ps, Hkv, D)
        perm = torch.randperm(P - 1, generator=self.g,
                              device=self.dev)[:8 * self.MP] + 1
        pt = perm.reshape(8, self.MP).to(torch.int32).contiguous()
        pt[5, 2] = 0
        positions = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        act = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                           device=self.dev)
        return kp, vp, pt, positions, self.i32(positions), act

    def fold_writers(self, kv, rope, mla_cfg):
        """K6 folded into the last layer's fused writer, the attend-then-
        write decode step: ``rope_kv_update_all_layers`` at llama3-1b's
        16 layers and ``latent_kv_update_all_layers`` at DeepSeek-V2-
        Lite's 27, each held to its plain version (the dense one bit for
        bit; the latent one's staged layers bit for bit and its own
        layer within ATTN_TOL, rope columns exact) and to the unfused
        chain it replaces (the pool-less writer, ``torch.stack`` of every
        layer's rows and K6: the same pool bytes), then timed beside that
        chain in one CUDA graph (``unfused_ms``) and K6 alone
        (``k6_only_ms``)."""
        torch = self.torch
        cfg, B = self.cfg, 8
        # Dense.
        L, Hkv, D = cfg.num_layers, self.Hkv, self.D
        kp, vp, pt, positions, pos, act = self._fold_inputs(L, Hkv, D, 128)
        q, k, v, cos, sin = self._rope_inputs(rope, B, 1, positions)
        k_stage, v_stage = self.randn(L, B, Hkv, D), self.randn(L, B, Hkv, D)
        outs = []
        for fn in (kv.rope_kv_update_all_layers,
                   kv.rope_kv_update_all_layers_plain):
            t = [x.clone() for x in (q, k, kp, vp, k_stage, v_stage)]
            fn(t[0], t[1], v, cos, sin, t[2], t[3], pt, pos, act, L - 1,
               t[4], t[5])
            outs.append(t)
        # The unfused chain: the pool-less writer, a stack of every
        # layer's rows, K6.
        t = [x.clone() for x in (q, k, kp, vp)]
        kv.rope_kv_update_layer(t[0], t[1], v, cos, sin)
        kv.paged_kv_update(t[2], t[3],
                           torch.cat([k_stage[:-1], t[1][None, :, 0]]),
                           torch.cat([v_stage[:-1], v[None, :, 0]]), pt, pos,
                           act)
        torch.cuda.synchronize()
        names = ("q", "k", "k_pages", "v_pages", "k_stage", "v_stage")
        for a, b, n in zip(*outs, names):
            if not torch.equal(a, b):
                raise AssertionError(f"rope_kv_update_all_layers: {n} is "
                                     f"not bit-exact with its plain version")
        for a, b, n in zip(outs[0][:4], t, names):
            if not torch.equal(a, b):
                raise AssertionError(f"rope_kv_update_all_layers: {n} is "
                                     f"not bit-exact with the unfused chain")
        changed = int((outs[0][2] != kp).flatten(3).any(-1).sum())
        if changed != 6 * L:                       # rows 5 and 6 dropped
            raise AssertionError(f"all-layer mode touched {changed} rows, "
                                 f"want {6 * L}")
        log("[kernel] rope_kv_update_all_layers bit-exact with its plain "
            "version and the unfused chain")
        qa, ka, kpa, vpa, ksa, vsa = (x.clone() for x in
                                      (q, k, kp, vp, k_stage, v_stage))
        qb, kb, kpb, vpb, ksb, vsb = (x.clone() for x in
                                      (q, k, kp, vp, k_stage, v_stage))
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        k_list = [x.clone() for x in k_stage[:-1]]
        v_list = [x.clone() for x in v_stage[:-1]]

        def unfused():
            kv.rope_kv_update_layer(qb, kb, v, cos, sin)
            kv.paged_kv_update(kpb, vpb, torch.stack(k_list + [kb[:, 0]]),
                               torch.stack(v_list + [v[:, 0]]), pt, pos,
                               all_on)
        row = Hkv * D * 2
        # q and k read and written, v, cos and sin read, k and v staged,
        # the earlier layers' staged rows read, every layer's row
        # written to both pools, the row metadata read.
        nbytes = (B * (2 * self.Hq + 3 * Hkv) * D * 2 + 2 * B * D // 2 * 4
                  + 2 * B * row + (L - 1) * B * 2 * row + L * B * 2 * row
                  + B * (4 + 4 + 1 + 4))
        self.record(
            "rope_kv_update_all_layers", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:77", 0.0,
            lambda: kv.rope_kv_update_all_layers(
                qa, ka, v, cos, sin, kpa, vpa, pt, pos, all_on, L - 1, ksa,
                vsa),
            lambda: kv.rope_kv_update_all_layers_plain(
                qa, ka, v, cos, sin, kpa, vpa, pt, pos, all_on, L - 1, ksa,
                vsa),
            None, nbytes, 6.0 * B * (self.Hq + Hkv) * D // 2,
            PEAK_FP32_FLOPS, entry="rope_kv_update_all_layers", layers=L,
            unfused_ms=graph_ms(unfused),
            k6_only_ms=graph_ms(lambda: kv.paged_kv_update(
                kpb, vpb, ksb, vsb, pt, pos, all_on)))
        del kp, vp, kpa, vpa, kpb, vpb
        # MLA latent rows.
        L = mla_cfg.num_layers
        r, dr = mla_cfg.kv_lora_rank, mla_cfg.qk_rope_head_dim
        W = r + dr
        kp, vp, pt, positions, pos, act = self._fold_inputs(L, 1, W, 80)
        cos, sin = rope.rope_cos_sin(pos.long()[:, None], dr,
                                     mla_cfg.rope_theta, mla_cfg.rope_scaling)
        ckv = self.randn(B, 1, W)
        weight = (1.0 + 0.1 * self.randn(r, dtype=torch.float32)).to(
            torch.bfloat16)
        args = (ckv, weight, cos, sin, mla_cfg.rms_norm_eps,
                mla_cfg.rope_interleave)
        stage = self.randn(L, B, 1, W)
        outs = []
        for fn in (kv.latent_kv_update_all_layers,
                   kv.latent_kv_update_all_layers_plain):
            t = [x.clone() for x in (kp, vp, stage)]
            fn(*args, t[0], t[1], pt, pos, act, L - 1, t[2])
            outs.append(t)
        torch.cuda.synchronize()
        (gk, gv, gs), (wk, wv, ws) = outs
        if not (torch.equal(gk[:-1], wk[:-1]) and torch.equal(gv[:-1], wv[:-1])
                and torch.equal(gs[:-1], ws[:-1])):
            raise AssertionError("latent_kv_update_all_layers: staged layers "
                                 "not bit-exact")
        if not torch.equal(gs[-1][..., r:], ws[-1][..., r:]):
            raise AssertionError("latent_kv_update_all_layers: rope columns "
                                 "not bit-exact")
        err = max(float((a[-1].float() - b[-1].float()).abs().max())
                  for a, b in ((gk, wk), (gv, wv), (gs, ws)))
        same_rows = torch.equal(gk[-1] != kp[-1], wk[-1] != kp[-1])
        if err > ATTN_TOL or not same_rows:
            raise AssertionError(f"latent_kv_update_all_layers: last layer "
                                 f"{err}")
        log(f"[kernel] latent_kv_update_all_layers: staged layers bit-exact, "
            f"its own layer max_abs_err={err}")
        ka, va, sa = kp.clone(), vp.clone(), stage.clone()
        kb, vb = kp.clone(), vp.clone()
        lat_list = [x.clone() for x in stage[:-1]]

        def unfused_latent():
            lat = kv.latent_kv_update_layer(*args)[:, 0]
            rows = torch.stack(lat_list + [lat])
            kv.paged_kv_update(kb, vb, rows, rows, pt, pos, all_on)
        row = W * 2
        nbytes = (B * W * 2 * 2 + r * 2 + 2 * B * dr // 2 * 4
                  + (L - 1) * B * row + L * B * 2 * row + B * (4 + 4 + 1 + 4))
        self.record(
            "latent_kv_update_all_layers", f"{CSRC}/kv_update.cu",
            f"{PALLAS}/kv_update.py:77", err,
            lambda: kv.latent_kv_update_all_layers(
                *args, ka, va, pt, pos, all_on, L - 1, sa),
            lambda: kv.latent_kv_update_all_layers_plain(
                *args, ka, va, pt, pos, all_on, L - 1, sa),
            None, nbytes, B * (3.0 * r + 3.0 * dr), PEAK_FP32_FLOPS,
            entry="latent_kv_update_all_layers", layers=L,
            unfused_ms=graph_ms(unfused_latent),
            k6_only_ms=graph_ms(lambda: kv.paged_kv_update(
                kb, vb, sa, sa, pt, pos, all_on)),
            shape=f"B=8 (Hkv, D) = (1, {W}) x {L} layers")

    def poison_current_slot(self, pa, mla_scale):
        """Why the fold may write before the last layer attends: with NaN
        in the pool slot at each row's cache length (where the fold
        writes the current rows), K3' and K3'' current give the same
        bits as without."""
        torch = self.torch
        B = 8
        cache = self.i32([116, 204, 297, 410, 149, 259, 0, 389])
        flat = (self.pt8.long().gather(1, (cache.long() // self.ps)[:, None])
                [:, 0] * self.ps + cache.long() % self.ps)
        q = self.randn(B, self.Hq, self.D)
        k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
            self.randn(B, self.Hkv, self.D)
        kp, vp = self.kp.clone(), self.vp.clone()
        want = pa.paged_decode_attention_current(
            q, kp, vp, self.pt8, cache, k_cur, v_cur, self.layer)
        for pool in (kp, vp):
            pool[self.layer].view(-1, self.Hkv, self.D)[flat] = float("nan")
        got = pa.paged_decode_attention_current(
            q, kp, vp, self.pt8, cache, k_cur, v_cur, self.layer)
        lat = self.randn(4, 128, self.ps, 1, 576)
        qm, cur = self.randn(B, 16, 576), self.randn(B, 1, 576)
        pt_m = (torch.randperm(127, generator=self.g, device=self.dev)[
            :8 * self.MP] + 1).reshape(8, self.MP).to(torch.int32)
        want_m = pa.paged_decode_attention_mla_current(
            qm, lat, pt_m, cache, cur, 1, mla_scale)
        flat_m = (pt_m.long().gather(1, (cache.long() // self.ps)[:, None])
                  [:, 0] * self.ps + cache.long() % self.ps)
        lat[1].view(-1, 576)[flat_m] = float("nan")
        got_m = pa.paged_decode_attention_mla_current(
            qm, lat, pt_m, cache, cur, 1, mla_scale)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got_m, want_m)):
            raise AssertionError("a NaN at the cache-length slot reached "
                                 "K3' or K3'' current")
        log("[kernel] K3' and K3'' current unchanged by NaN at the "
            "cache-length slot")

    # -- K1 / K2 fused with the MLA latent row -----------------------------
    def _latent_close(self, fused, plain, args, pools, rest, what, r):
        """``fused`` and ``plain`` on copies of the same pools: the latent
        rows (returned and written to both pools) within ATTN_TOL, their
        rope columns bit-exact, and the same pool rows written. Returns
        the largest absolute error."""
        torch = self.torch
        outs = []
        for fn in (fused, plain):
            pc = [p.clone() for p in pools] if pools else [None, None]
            outs.append([fn(*args, *pc, *rest)] + pc)
        torch.cuda.synchronize()
        (got, gk, gv), (want, wk, wv) = outs
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: latent not finite")
        if not torch.equal(got[..., r:], want[..., r:]):
            raise AssertionError(f"{what}: rope columns not bit-exact")
        err = float((got.float() - want.float()).abs().max())
        if pools:
            for a, b, p0 in ((gk, wk, pools[0]), (gv, wv, pools[1])):
                if not torch.equal((a != p0).flatten(3).any(-1),
                                   (b != p0).flatten(3).any(-1)):
                    raise AssertionError(f"{what}: other pool rows written")
                err = max(err, float((a.float() - b.float()).abs().max()))
        if err > ATTN_TOL:
            raise AssertionError(f"{what}: max abs error {err}")
        log(f"[kernel] {what}: max_abs_err={err}")
        return err

    def latent_writers(self, kv, rope, mla_cfg):
        """K1 and K2 fused with the MLA latent row (``latent_kv_update_
        layer``, ``latent_prefill_kv_update_layer``) at DeepSeek-V2-Lite's
        geometry (ckv = h @ kv_a of width 512 + 64, yarn cos/sin,
        adjacent-pair rope): the decode rows (B=8, row 6 inactive, row 5's
        page NULL) and the 4 x 256 prefill batch, with pools and without,
        within ATTN_TOL (the norm's sum runs in another order; the rope
        columns bit-exact); each timed beside the unfused chain (rms_norm,
        rope, cat, then K1 / K2; one CUDA graph) and K1 / K2 alone."""
        torch = self.torch
        kp, vp, pt8 = self.latent_pools()
        r, dr = mla_cfg.kv_lora_rank, mla_cfg.qk_rope_head_dim
        W = r + dr
        weight = (1.0 + 0.1 * self.randn(r, dtype=torch.float32)).to(
            torch.bfloat16)
        eps, inter = mla_cfg.rms_norm_eps, mla_cfg.rope_interleave
        layer = 1
        decode_pos = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333, 390)]
        for name, B, T, starts, lens in (
                ("latent_kv_update_layer", 8, 1, decode_pos, None),
                ("latent_prefill_kv_update_layer", 4, 256, [0, 256, 128, 7],
                 [256, 144, 200, 97])):
            fused = getattr(kv, name)
            plain = getattr(kv, name + "_plain")
            pos = self.i32(starts).long()[:, None] \
                + torch.arange(T, device=self.dev)[None, :]
            cos, sin = rope.rope_cos_sin(pos, dr, mla_cfg.rope_theta,
                                         mla_cfg.rope_scaling)
            ckv = self.randn(B, T, W)
            args = (ckv, weight, cos, sin, eps, inter)
            pt = pt8[:B].clone()
            if lens is None:
                pt[5, 2] = 0
                act = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                                   device=self.dev)
                rest = (pt, self.i32(starts), act, layer)
                n = int(act.sum())
            else:
                rest = (pt, self.i32(starts), self.i32(lens), layer)
                n = sum(lens)
            err = max(self._latent_close(fused, plain, args, p, re,
                                         f"{name} ({mode})", r)
                      for p, re, mode in (((kp, vp), rest, "pools"),
                                          (None, (), "pool-less")))
            if lens is None:                  # timed with every row on
                rest = (pt8[:B].contiguous(), self.i32(starts),
                        torch.ones(B, dtype=torch.bool, device=self.dev),
                        layer)
                n = B
            writer = (kv.paged_kv_update_layer if lens is None
                      else kv.paged_prefill_kv_update_layer)
            ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            fresh = kv.latent_prefill_kv_update_layer_plain(*args)
            if lens is None:
                fresh = fresh[:, 0]

            def unfused(args=args, writer=writer, rest=rest, T=T):
                lat = kv.latent_prefill_kv_update_layer_plain(*args)
                lat = lat[:, 0] if T == 1 else lat
                writer(ka, va, lat, lat, *rest)
            nbytes = (B * T * W * 2 * 2 + r * 2 + 2 * B * T * dr // 2 * 4
                      + n * 2 * W * 2
                      + B * (4 + 4 + 1 + 4 if lens is None
                             else 4 * self.MP + 8))
            self.record(
                name, f"{CSRC}/kv_update.cu",
                f"{PALLAS}/kv_update.py:{162 if lens is None else 336}", err,
                lambda f=fused, a=args, re=rest: f(*a, ka, va, *re),
                lambda p=plain, a=args, re=rest: p(*a, kb, vb, *re),
                None, nbytes, B * T * (3.0 * r + 3.0 * dr), PEAK_FP32_FLOPS,
                entry=name,
                unfused_ms=graph_ms(unfused),
                writer_only_ms=graph_ms(
                    lambda w=writer, f=fresh, re=rest: w(ka, va, f, f, *re)),
                shape=f"B={B} T={T} (Hkv, D) = (1, {W})")
        del kp, vp

    # -- K3 ----------------------------------------------------------------
    def decode_attention(self, pa, attention):
        torch = self.torch
        B = 8
        q = self.randn(B, self.Hq, self.D)
        ctx_list = [117, 205, 298, 411, 150, 260, 0, 390]   # row 6 inactive
        ctx = self.i32(ctx_list)
        act = ctx > 0
        sinks = self.randn(self.Hq, dtype=torch.float32)
        worst = 0.0
        for extras in ({}, {"sliding_window": 100},
                       {"logits_soft_cap": 30.0, "scale": 0.1},
                       {"sinks": sinks, "sliding_window": 64}):
            got = pa.paged_decode_attention(q, self.kp, self.vp, self.pt8,
                                            ctx, self.layer, **extras)
            want = pa.paged_decode_attention_plain(
                q, self.kp, self.vp, self.pt8, ctx, self.layer, **extras)
            torch.cuda.synchronize()
            g, w = got[act].float(), want[act].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode attention not finite {extras}")
            if not torch.allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL):
                raise AssertionError(
                    f"decode attention disagrees ({list(extras)}): "
                    f"{float((g - w).abs().max())}")
            if bool(got[~act].float().abs().max() != 0):
                raise AssertionError("inactive decode row not zero")
            worst = max(worst, float((g - w).abs().max()))
        S = self.MP * self.ps
        mask = (torch.arange(S, device=self.dev)[None, :]
                < ctx.long()[:, None])[:, None, None, :]
        mask[~act] = True                 # SDPA needs a key per row

        def lib():
            k = attention.gather_pages(self.kp[self.layer], self.pt8)
            v = attention.gather_pages(self.vp[self.layer], self.pt8)
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        mask)
        keys = sum(ctx_list)
        row = self.Hkv * self.D * 2
        nbytes = keys * 2 * row + 2 * int(act.sum()) * self.Hq * self.D * 2 \
            + B * (4 + 4 * self.MP)
        flops = 4.0 * keys * self.Hq * self.D
        self.split_record(
            "paged_decode_attention", "paged_decode_attention",
            f"{CSRC}/paged_decode_attention.cu",
            lambda n: pa.paged_decode_attention(
                q, self.kp, self.vp, self.pt8, ctx, self.layer, num_splits=n),
            lambda: pa.paged_decode_attention_plain(
                q, self.kp, self.vp, self.pt8, ctx, self.layer),
            lib, nbytes, flops,
            pa.gqa_splits(B, self.Hkv, self.MP, self.ps, 0, False), act,
            worst)

    # Split counts timed at the long shapes beside the wrapper's own.
    SPLIT_SWEEP = (4, 8, 12, 16, 24, 32, 48, 64)

    def split_record(self, name, entry, source, run, plain, lib, nbytes,
                     flops, splits, valid, worst=0.0, sweep=False, **extra):
        """A split decode kernel at one shape: ``run(None)`` (the
        wrapper's own split count, ``splits``) and ``run(1)`` (one split,
        one block per row and kv head: the unsplit yardstick, through the
        same kernel) checked against ``plain()`` on the ``valid`` rows
        (the others must be zero), then recorded with the second's device
        time beside the first's; with ``sweep``, also the device time at
        each of SPLIT_SWEEP (``split_sweep_ms``)."""
        want = plain()
        errs = [self.close(f"{name} S={s}", run(n), want, valid)
                for s, n in ((splits, None), (1, 1))]
        unsplit_ms = graph_ms(lambda: run(1))
        if sweep:
            extra["split_sweep_ms"] = {
                n: graph_ms(lambda n=n: run(n)) for n in self.SPLIT_SWEEP}
        self.record(name, source, f"{PALLAS}/paged_attention.py:154",
                    max([worst] + errs), lambda: run(None), plain, lib,
                    nbytes, flops, entry=entry, splits=splits,
                    unsplit_ms=unsplit_ms, **extra)

    def long_decode_rows(self, P):
        """The long decode shapes, over a pool of ``P`` pages of 128:
        (label, contexts, page table) for B = 8 rows of 2048-4096 keys
        (seeded) and B = 1 row of 4096, 32 pages a row."""
        rng = random.Random(6)
        ctx8 = [rng.randrange(2048, 4097) for _ in range(8)]
        perm = self.torch.randperm(P - 1, generator=self.g,
                                   device=self.dev)[:8 * 32] + 1
        pt = perm.reshape(8, 32).to(self.torch.int32).contiguous()
        return [("B=8 ctx 2048-4096", "long_b8", ctx8, pt),
                ("B=1 ctx 4096", "long_b1", [4096], pt[:1].contiguous())]

    def decode_attention_long(self, pa, attention):
        """K3 and K3' at the long shapes: contexts (cache lengths one
        less, with the current token's K/V apart), every row compared."""
        torch = self.torch
        for label, tag, ctx_list, pt in self.long_decode_rows(self.P):
            B, MP = len(ctx_list), pt.shape[1]
            q = self.randn(B, self.Hq, self.D)
            k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
                self.randn(B, self.Hkv, self.D)
            ctx = self.i32(ctx_list)
            cache = self.i32([c - 1 for c in ctx_list])
            valid = torch.ones(B, dtype=torch.bool, device=self.dev)
            S = MP * self.ps
            pos = torch.arange(S + 1, device=self.dev)[None, :]
            keys = sum(ctx_list)
            nbytes = keys * 2 * self.Hkv * self.D * 2 \
                + 2 * B * self.Hq * self.D * 2 + B * (4 + 4 * MP)
            flops = 4.0 * keys * self.Hq * self.D

            def gathered(pool):
                return attention.gather_pages(pool[self.layer], pt)

            def lib(mask=(pos[:, :S] < ctx.long()[:, None])[:, None, None]):
                return sdpa(q[:, :, None], gathered(self.kp).transpose(1, 2),
                            gathered(self.vp).transpose(1, 2), mask)

            def lib_cur(mask=((pos < cache.long()[:, None])
                              | (pos == S))[:, None, None]):
                k = torch.cat([gathered(self.kp), k_cur[:, None]], dim=1)
                v = torch.cat([gathered(self.vp), v_cur[:, None]], dim=1)
                return sdpa(q[:, :, None], k.transpose(1, 2),
                            v.transpose(1, 2), mask)
            self.split_record(
                f"paged_decode_attention_{tag}", "paged_decode_attention",
                f"{CSRC}/paged_decode_attention.cu",
                lambda n: pa.paged_decode_attention(
                    q, self.kp, self.vp, pt, ctx, self.layer, num_splits=n),
                lambda: pa.paged_decode_attention_plain(
                    q, self.kp, self.vp, pt, ctx, self.layer),
                lib, nbytes, flops,
                pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, False), valid,
                sweep=True, shape=label)
            self.split_record(
                f"paged_decode_attention_current_{tag}",
                "paged_decode_attention_current",
                f"{CSRC}/paged_decode_attention.cu",
                lambda n: pa.paged_decode_attention_current(
                    q, self.kp, self.vp, pt, cache, k_cur, v_cur, self.layer,
                    num_splits=n),
                lambda: pa.paged_decode_attention_current_plain(
                    q, self.kp, self.vp, pt, cache, k_cur, v_cur,
                    self.layer),
                lib_cur, nbytes, flops,
                pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, True), valid,
                shape=label)

    # -- K4 ----------------------------------------------------------------
    def prefill_attention(self, pf, attention):
        torch = self.torch
        B, T = 4, 256
        q = self.randn(B, T, self.Hq, self.D)
        pt = self.pt8[:B].contiguous()
        q_start = self.i32([0, 256, 128, 0])
        lens_list = [256, 144, 200, 97]
        lens = self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            worst = max(worst, self.close(
                f"prefill attention ({list(extras)})",
                pf.paged_prefill_attention(q, self.kp, self.vp, pt, q_start,
                                           lens, self.layer, **extras),
                pf.paged_prefill_attention_plain(
                    q, self.kp, self.vp, pt, q_start, lens, self.layer,
                    **extras), valid))
        S = self.MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        starts = [0, 256, 128, 0]
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        row = self.Hkv * self.D * 2
        n_rows = sum(lens_list)
        nbytes = keys * 2 * row + 2 * n_rows * self.Hq * self.D * 2 \
            + B * (8 + 4 * self.MP)
        flops = 4.0 * pairs * self.Hq * self.D
        self.record(
            "paged_prefill_attention", f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", worst,
            lambda: pf.paged_prefill_attention(q, self.kp, self.vp, pt,
                                               q_start, lens, self.layer),
            lambda: pf.paged_prefill_attention_plain(
                q, self.kp, self.vp, pt, q_start, lens, self.layer),
            lib, nbytes, flops)


    # -- K5 ----------------------------------------------------------------
    def ragged_attention(self, ra, pa, pf, attention):
        """The ragged serving mix: 7 decode rows (length 1 at context - 1,
        contexts 117-411, mid-page) and a 256-token continuation window
        at q_start 128, in one B=8 x T=256 bucket; checked in the four
        argument sets and with a padding row, timed beside the split
        path and SDPA, and alone on its decode rows and on its window."""
        B, T = 8, 256
        ctx = [117, 205, 298, 411, 150, 260, 333]
        starts = [c - 1 for c in ctx] + [128]
        lens_list = [1] * 7 + [256]
        pt = self.pt8
        self._ragged_case(
            ra, pa, pf, attention, "ragged_paged_attention", starts,
            lens_list, pt, T, checks=True,
            # The kernel on each half of the batch alone (the other
            # half's rows at length 0): which rows set its time.
            parts={"decode_rows_only": lens_list[:7] + [0],
                   "window_only": [0] * 7 + [256]})

    def ragged_attention_long(self, ra, pa, pf, attention):
        """K5 at long decode rows, which no served phase reaches: B = 8
        decode rows of 2048-4096 keys (seeded) beside one 256-token
        window at q_start 512, in a T = 256 bucket, 32 pages a row."""
        rng = random.Random(8)
        ctx = [rng.randrange(2048, 4097) for _ in range(8)]
        starts = [c - 1 for c in ctx] + [512]
        lens_list = [1] * 8 + [256]
        perm = self.torch.randperm(self.P - 1, generator=self.g,
                                   device=self.dev)[:9 * 32] + 1
        pt = perm.reshape(9, 32).to(self.torch.int32).contiguous()
        self._ragged_case(
            ra, pa, pf, attention, "ragged_paged_attention_long", starts,
            lens_list, pt, 256, checks=False,
            parts={"decode_rows_only": lens_list[:8] + [0]},
            shape="B=9: 8 decode rows ctx 2048-4096 + a 256-token window",
            # Its decode rows' outputs are ~0.03 RMS (a mean over 2048+
            # random values): ATTN_TOL would let a dropped split pass.
            tol=LONG_ROW_TOL)

    def ragged_attention_wide(self, ra):
        """K5 at the largest bucket its row table holds, 256 rows (the
        engine refuses a larger one at start-up): decode rows, windows
        of 2-16 tokens and padding rows mixed, T = 16, checked in the
        four argument sets."""
        torch = self.torch
        B, T = 256, 16
        rng = random.Random(9)
        lens_list = [rng.choice([1, 1, 0, rng.randrange(2, T + 1)])
                     for _ in range(B)]
        starts = [rng.randrange(0, self.MP * self.ps - T) for _ in range(B)]
        pt = torch.randint(1, self.P, (B, self.MP), generator=self.g,
                           device=self.dev).to(torch.int32)
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(self.randn(self.Hq,
                                               dtype=torch.float32)):
            args = (q, self.kp, self.vp, pt, q_start, lens, self.layer)
            worst = max(worst, self.close(
                f"ragged_paged_attention B={B} ({list(extras)})",
                ra.ragged_paged_attention(*args, **extras),
                ra.ragged_paged_attention_plain(*args, **extras), valid))
        log(f"[kernel] ragged_paged_attention at B={B} x T={T} "
            f"({lens_list.count(1)} decode rows): all four argument sets "
            f"within {ATTN_TOL}, max abs err {worst}")

    def _ragged_nbytes(self, starts, lens_list, T, MP):
        """K5's bytes: the live keys' K and V, the valid query rows of q
        and the whole [B, T, Hq, D] output (padding rows are written as
        zeros), each once, and the row metadata; also the count that
        takes the output for the valid rows only, as older records
        did."""
        B = len(lens_list)
        keys = sum(s + n for s, n in zip(starts, lens_list) if n > 0)
        row = self.Hkv * self.D * 2
        head_rows = self.Hq * self.D * 2
        n_rows = sum(lens_list)
        meta = B * (8 + 4 * MP)
        full = keys * 2 * row + n_rows * head_rows + B * T * head_rows
        return full + meta, keys * 2 * row + 2 * n_rows * head_rows + meta

    def _ragged_flops(self, starts, lens_list):
        """The products' operations: 4 D per (query, key) pair a head."""
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        return 4.0 * pairs * self.Hq * self.D

    def _ragged_case(self, ra, pa, pf, attention, name, starts, lens_list,
                     pt, T, checks, parts, shape=None, tol=ATTN_TOL):
        torch = self.torch
        B, MP = len(lens_list), pt.shape[1]
        q = self.randn(B, T, self.Hq, self.D)
        q_start, lens = self.i32(starts), self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        cases = [({}, lens_list)]
        if checks:
            # The last case makes row 6 a padding row of length 0.
            cases = [(extras, lens_list) for extras in self.arg_sets(sinks)]
            cases.append(({}, lens_list[:6] + [0] + lens_list[7:]))
        cases += [({}, p) for p in parts.values()]
        worst = 0.0
        for extras, lens_case in cases:
            lc = self.i32(lens_case)
            valid = (torch.arange(T, device=self.dev)[None, :]
                     < lc.long()[:, None])
            args = (q, self.kp, self.vp, pt, q_start, lc, self.layer)
            want = ra.ragged_paged_attention_plain(*args, **extras)
            worst = max(worst, self.close(
                f"{name} ({list(extras)}, lengths {lens_case})",
                ra.ragged_paged_attention(*args, **extras), want, valid,
                tol))
            if lens_case is lens_list and not extras:
                # The scale the error is read against: the reference's
                # RMS over its decode rows and over all its valid rows.
                dec_rows = valid.clone()
                dec_rows[self.i32(lens_case).long() != 1] = False
                ref_rms = {
                    "decode_rows": float(want[dec_rows].float().pow(2)
                                         .mean().sqrt()),
                    "valid_rows": float(want[valid].float().pow(2)
                                        .mean().sqrt())}
        S = MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        # The split path's two launches for the same work: the decode
        # kernel on the decode rows, the prefill kernel on the windows.
        dec = [b for b, n in enumerate(lens_list) if n == 1]
        win = [b for b, n in enumerate(lens_list) if n > 1]
        q_dec = q[dec, 0].contiguous()
        ctx_t = self.i32([starts[b] + 1 for b in dec])
        pt_dec, pt_win = pt[dec].contiguous(), pt[win].contiguous()
        q_win = q[win].contiguous()
        win_start = self.i32([starts[b] for b in win])
        win_len = self.i32([lens_list[b] for b in win])

        def split_decode():
            pa.paged_decode_attention(q_dec, self.kp, self.vp, pt_dec, ctx_t,
                                      self.layer)

        def split_window():
            pf.paged_prefill_attention(q_win, self.kp, self.vp, pt_win,
                                       win_start, win_len, self.layer)

        def split():
            split_decode()
            split_window()
        splits = pa.gqa_splits(B, self.Hkv, MP, self.ps, 0, False)
        blocks = ra.ragged_blocks(B, T, self.Hq, self.Hkv, self.D, splits)
        # The split path, and each of its launches alone: K3 on the
        # decode rows, K4 on the windows.
        extra = {"split_ms": graph_ms(split),
                 "split_decode_k3_ms": graph_ms(split_decode),
                 "split_window_k4_ms": graph_ms(split_window),
                 "splits": splits, "grid_blocks": blocks,
                 "tolerance": tol, "ref_rms": ref_rms}

        def work_record(tag, lens_case):
            w = ra.ragged_work(starts, lens_case, T, self.Hq, self.Hkv,
                               self.D, MP, self.ps, 0, splits)
            log(f"[kernel] {name} {tag.rstrip('_') or 'mix'}: derived by "
                f"the host rule ragged_work, not measured: "
                f"{w.live_blocks(blocks, self.D)} of {blocks} blocks with "
                f"work; {len(w.windows)} window tiles, {len(w.splits)} "
                f"decode splits, {len(w.zeros)} zero ranges")
            nbytes, _ = self._ragged_nbytes(starts, lens_case, T, MP)
            extra[f"{tag}bound_ms"] = bound(
                nbytes, self._ragged_flops(starts, lens_case))[0]
        work_record("", lens_list)
        for tag, lens_case in parts.items():
            lc = self.i32(lens_case)
            extra[f"{tag}_ms"] = graph_ms(
                lambda lc=lc: ra.ragged_paged_attention(
                    q, self.kp, self.vp, pt, q_start, lc, self.layer))
            work_record(f"{tag}_", lens_case)
        del extra["bound_ms"]             # the record's own bound_ms
        flops = self._ragged_flops(starts, lens_list)
        nbytes, nbytes_valid = self._ragged_nbytes(starts, lens_list, T, MP)
        extra["bound_ms_valid_rows_only"] = bound(nbytes_valid, flops)[0]
        if shape:
            extra.update(entry="ragged_paged_attention", shape=shape)
        self.record(
            name, f"{CSRC}/ragged_paged_attention.cu",
            f"{PALLAS}/ragged_attention.py:191", worst,
            lambda: ra.ragged_paged_attention(q, self.kp, self.vp, pt,
                                              q_start, lens, self.layer),
            lambda: ra.ragged_paged_attention_plain(
                q, self.kp, self.vp, pt, q_start, lens, self.layer),
            lib, nbytes, flops, **extra)

    # -- K6 / K7 ------------------------------------------------------------
    def all_layer_writers(self, kv, L, Hkv, D, record):
        """K6 (a decode step: 8 rows, contexts 117-411, row 6 inactive)
        and K7 (the 4 x 256 prefill window batch, one start unaligned)
        over the ``L`` layers of a pool of (Hkv, D) rows: bit-exact
        against the plain version; with ``record``, timed as well."""
        torch = self.torch
        P, MP = 128, self.MP
        shape = (L, P, self.ps, Hkv, D)
        kp, vp = self.randn(*shape), self.randn(*shape)
        perm = torch.randperm(P - 1, generator=self.g,
                              device=self.dev)[:8 * MP] + 1
        pt8 = perm.reshape(8, MP).to(torch.int32).contiguous()
        rows = [self._decode_writer_all(kv, kp, vp, pt8),
                self._prefill_writer_all(kv, kp, vp, pt8)]
        if not record:
            log(f"[kernel] all-layer writers bit-exact at (L, Hkv, D) = "
                f"{(L, Hkv, D)}")
            return
        for name, replaces, kernel, plain, lib, nbytes, extra in rows:
            extra = {k: graph_ms(f) for k, f in extra.items()}
            if name == "paged_kv_update":
                extra["superseded_by"] = (
                    "rope_kv_update_all_layers, latent_kv_update_all_layers "
                    "(no served path launches K6 alone)")
            self.record(name, f"{CSRC}/kv_update.cu", replaces, 0.0, kernel,
                        plain, lib, nbytes, 0.0, layers=L, **extra)

    def _same(self, a, b, what, geometry):
        self.torch.cuda.synchronize()
        if not (self.torch.equal(a[0], b[0]) and self.torch.equal(a[1], b[1])):
            raise AssertionError(f"{what} is not bit-exact at (L, Hkv, D) = "
                                 f"{geometry}")

    def _decode_writer_all(self, kv, kp, vp, pt8):
        torch = self.torch
        L, P, ps, Hkv, D = kp.shape
        B = 8
        ctx = [117, 205, 298, 411, 150, 260, 333, 390]
        pos = self.i32([c - 1 for c in ctx])
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)
        kn, vn = self.randn(L, B, Hkv, D), self.randn(L, B, Hkv, D)
        pt = pt8.clone()
        pt[5, 2] = 0                      # row 5's page is NULL: dropped
        ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        kv.paged_kv_update(ka, va, kn, vn, pt, pos, active)
        kv.paged_kv_update_plain(kb, vb, kn, vn, pt, pos, active)
        self._same((ka, va), (kb, vb), "all-layer decode KV writer",
                   (L, Hkv, D))
        changed = int((ka != kp).flatten(3).any(-1).sum())
        if changed != 6 * L:                      # rows 5 and 6 dropped
            raise AssertionError(f"all-layer decode writer touched "
                                 f"{changed} rows, want {6 * L}")
        act_rows = active.nonzero()[:, 0]
        flat = (pt8.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
                * ps + pos.long() % ps)[act_rows]
        kn_a = kn[:, act_rows].contiguous()
        vn_a = vn[:, act_rows].contiguous()
        kf = ka.view(L, P * ps, Hkv, D)
        vf = va.view(L, P * ps, Hkv, D)

        def lib():
            kf.index_copy_(1, flat, kn_a)
            vf.index_copy_(1, flat, vn_a)

        def one_layer_writer_x_layers():   # what K6 replaces: L K1 launches
            for li in range(L):
                kv.paged_kv_update_layer(ka, va, kn[li], vn[li], pt8, pos,
                                         active, li)
        nbytes = int(active.sum()) * L * 2 * 2 * Hkv * D * 2 \
            + B * (4 + 4 + 1 + 4)
        return ("paged_kv_update", f"{PALLAS}/kv_update.py:77",
                lambda: kv.paged_kv_update(ka, va, kn, vn, pt8, pos, active),
                lambda: kv.paged_kv_update_plain(kb, vb, kn, vn, pt8, pos,
                                                 active),
                lib, nbytes,
                {"one_layer_writer_x_layers_ms": one_layer_writer_x_layers})

    def _prefill_writer_all(self, kv, kp, vp, pt8):
        torch = self.torch
        L, P, ps, Hkv, D = kp.shape
        B, T = 4, 256
        kn, vn = self.randn(L, B, T, Hkv, D), self.randn(L, B, T, Hkv, D)
        pt = pt8[:B].contiguous()
        start = self.i32([0, 256, 128, 7])            # last row unaligned
        lens = self.i32([256, 144, 200, 97])
        ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        kv.paged_prefill_kv_update(ka, va, kn, vn, pt, start, lens)
        kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt, start, lens)
        self._same((ka, va), (kb, vb), "all-layer prefill KV writer",
                   (L, Hkv, D))
        t = torch.arange(T, device=self.dev)
        valid = t[None, :] < lens.long()[:, None]
        pos = start.long()[:, None] + t[None, :]
        flat = (pt.long().gather(1, pos // ps) * ps + pos % ps)[valid]
        kr, vr = kn[:, valid].contiguous(), vn[:, valid].contiguous()
        kf = ka.view(L, P * ps, Hkv, D)
        vf = va.view(L, P * ps, Hkv, D)

        def lib():
            kf.index_copy_(1, flat, kr)
            vf.index_copy_(1, flat, vr)
        nbytes = int(lens.sum()) * L * 2 * 2 * Hkv * D * 2 \
            + B * (4 * self.MP + 8)
        return ("paged_prefill_kv_update", f"{PALLAS}/kv_update.py:244",
                lambda: kv.paged_prefill_kv_update(ka, va, kn, vn, pt, start,
                                                   lens),
                lambda: kv.paged_prefill_kv_update_plain(kb, vb, kn, vn, pt,
                                                         start, lens),
                lib, nbytes, {})

    # -- K3' ---------------------------------------------------------------
    def decode_attention_current(self, pa, attention):
        """K3' at the decode shape: cache lengths 116-410 and an inactive
        row with cache length 0 (it attends to its current token alone),
        all rows compared. The pool slot at each cache length holds a
        random value unlike k_cur/v_cur (stale in this order)."""
        torch = self.torch
        B = 8
        q = self.randn(B, self.Hq, self.D)
        k_cur, v_cur = self.randn(B, self.Hkv, self.D), \
            self.randn(B, self.Hkv, self.D)
        cache_list = [116, 204, 297, 410, 149, 259, 0, 389]
        cache = self.i32(cache_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        worst = 0.0
        for extras in ({}, {"sliding_window": 100},
                       {"logits_soft_cap": 30.0, "scale": 0.1},
                       {"sinks": sinks, "sliding_window": 64},
                       {"sliding_window": 1}):
            got = pa.paged_decode_attention_current(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, **extras)
            want = pa.paged_decode_attention_current_plain(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, **extras)
            torch.cuda.synchronize()
            g, w = got.float(), want.float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode attention (current) not "
                                     f"finite {list(extras)}")
            if not torch.allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL):
                raise AssertionError(
                    f"decode attention (current) disagrees "
                    f"({list(extras)}): {float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
        S = self.MP * self.ps
        pos = torch.arange(S + 1, device=self.dev)[None, :]
        mask = ((pos < cache.long()[:, None]) | (pos == S))[:, None, None, :]

        def lib():
            k = torch.cat([attention.gather_pages(self.kp[self.layer],
                                                  self.pt8),
                           k_cur[:, None]], dim=1)
            v = torch.cat([attention.gather_pages(self.vp[self.layer],
                                                  self.pt8),
                           v_cur[:, None]], dim=1)
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        mask)
        keys = sum(cache_list) + B           # the current keys included
        row = self.Hkv * self.D * 2
        nbytes = keys * 2 * row + 2 * B * self.Hq * self.D * 2 \
            + B * (4 + 4 * self.MP)
        flops = 4.0 * keys * self.Hq * self.D
        self.split_record(
            "paged_decode_attention_current",
            "paged_decode_attention_current",
            f"{CSRC}/paged_decode_attention.cu",
            lambda n: pa.paged_decode_attention_current(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer, num_splits=n),
            lambda: pa.paged_decode_attention_current_plain(
                q, self.kp, self.vp, self.pt8, cache, k_cur, v_cur,
                self.layer),
            lib, nbytes, flops,
            pa.gqa_splits(B, self.Hkv, self.MP, self.ps, 0, True),
            torch.ones(B, dtype=torch.bool, device=self.dev), worst)

    # -- K4' ---------------------------------------------------------------
    def prefill_attention_fresh(self, pf, attention):
        """K4' at the 4 x 256 prefill shape with q_start 0/256/128/0: the
        window's K/V as fresh operands; the pool's window slots hold
        random values unlike them (stale in this order)."""
        torch = self.torch
        B, T = 4, 256
        q = self.randn(B, T, self.Hq, self.D)
        k_fresh, v_fresh = self.randn(B, T, self.Hkv, self.D), \
            self.randn(B, T, self.Hkv, self.D)
        pt = self.pt8[:B].contiguous()
        starts = [0, 256, 128, 0]
        lens_list = [256, 144, 200, 97]
        q_start, lens = self.i32(starts), self.i32(lens_list)
        sinks = self.randn(self.Hq, dtype=torch.float32)
        valid = (torch.arange(T, device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            args = (q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                    self.layer)
            worst = max(worst, self.close(
                f"prefill attention (fresh) ({list(extras)})",
                pf.paged_prefill_attention_fresh(*args, **extras),
                pf.paged_prefill_attention_fresh_plain(*args, **extras),
                valid))
        S = self.MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = (kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None])
        mask = mask[:, None]
        idx = (q_start.long()[:, None] + torch.arange(T, device=self.dev))[
            :, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def lib():
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            k.scatter_(1, idx, k_fresh)
            v.scatter_(1, idx, v_fresh)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        row = self.Hkv * self.D * 2
        n_rows = sum(lens_list)
        nbytes = keys * 2 * row + 2 * n_rows * self.Hq * self.D * 2 \
            + B * (8 + 4 * self.MP)
        flops = 4.0 * pairs * self.Hq * self.D
        self.record(
            "paged_prefill_attention_fresh",
            f"{CSRC}/paged_prefill_attention.cu",
            f"{PALLAS}/prefill_attention.py:272", worst,
            lambda: pf.paged_prefill_attention_fresh(
                q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                self.layer),
            lambda: pf.paged_prefill_attention_fresh_plain(
                q, k_fresh, v_fresh, self.kp, self.vp, pt, q_start, lens,
                self.layer),
            lib, nbytes, flops)

    # -- K4, K4', K5 beyond the serving shape -------------------------------
    @staticmethod
    def arg_sets(sinks):
        """The attention kernels' four argument sets: plain; window;
        soft-cap and scale; sinks and window."""
        return ({}, {"sliding_window": 100},
                {"logits_soft_cap": 30.0, "scale": 0.1},
                {"sinks": sinks, "sliding_window": 64})

    def close(self, what, got, want, valid, tol=ATTN_TOL) -> float:
        """Valid query rows within ``tol`` (atol = rtol) of the plain
        version, padded rows exactly zero, everything finite; returns the
        max abs error."""
        torch = self.torch
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what} not finite")
        g, w = got[valid].float(), want[valid].float()
        err = float((g - w).abs().max())
        if not torch.allclose(g, w, atol=tol, rtol=tol):
            raise AssertionError(f"{what} disagrees: {err}")
        if bool((~valid).any()) and bool(got[~valid].float().abs().max()
                                         != 0):
            raise AssertionError(f"{what}: padded rows not zero")
        return err

    def tile_kernels(self, pf, ra, kp, vp, pt, q, k_fresh, v_fresh, q_start,
                     lens, layer, label) -> float:
        """K4, K4' (pool slots of the window stale) and K5 on one input,
        in all four argument sets."""
        torch = self.torch
        sinks = self.randn(q.shape[2], dtype=torch.float32)
        valid = (torch.arange(q.shape[1], device=self.dev)[None, :]
                 < lens.long()[:, None])
        worst = 0.0
        for extras in self.arg_sets(sinks):
            args = (kp, vp, pt, q_start, lens, layer)
            fresh = (q, k_fresh, v_fresh) + args
            for kname, kernel, plain, a in (
                    ("K4", pf.paged_prefill_attention,
                     pf.paged_prefill_attention_plain, (q,) + args),
                    ("K4'", pf.paged_prefill_attention_fresh,
                     pf.paged_prefill_attention_fresh_plain, fresh),
                    ("K5", ra.ragged_paged_attention,
                     ra.ragged_paged_attention_plain, (q,) + args)):
                worst = max(worst, self.close(
                    f"{kname} {label} ({list(extras)})", kernel(*a, **extras),
                    plain(*a, **extras), valid))
        log(f"[kernel] K4, K4', K5 {label}: all four argument sets within "
            f"{ATTN_TOL}, max abs err {worst}")
        return worst

    def head_dims(self, pf, ra, pa):
        """K4, K4' and K5's window tiles at D = 128 (G = 3: 126 of a
        tile's 128 rows used) and D = 256 (G = 4) on a small pool of
        page size 16 (a 64-key chunk spans four pages): rows at q_start
        0/100/37 of lengths 160/90/1 in a T = 160 bucket (K5 serves the
        last as a decode row), windows that start and end mid-chunk.
        Then K3 and K3' on the same pools: contexts 300/0/45 (cache
        lengths one less), at the wrappers' split count, one split and
        three, in all four argument sets."""
        torch = self.torch
        B, T, ps, MP, P = 3, 160, 16, 20, 80
        for D, Hkv, G in ((128, 2, 3), (256, 2, 4)):
            kp, vp = self.randn(2, P, ps, Hkv, D), self.randn(2, P, ps, Hkv, D)
            perm = torch.randperm(P - 1, generator=self.g,
                                  device=self.dev)[:B * MP] + 1
            pt = perm.reshape(B, MP).to(torch.int32).contiguous()
            q = self.randn(B, T, Hkv * G, D)
            k_fresh, v_fresh = self.randn(B, T, Hkv, D), \
                self.randn(B, T, Hkv, D)
            self.tile_kernels(pf, ra, kp, vp, pt, q, k_fresh, v_fresh,
                              self.i32([0, 100, 37]), self.i32([160, 90, 1]),
                              1, f"at D={D} G={G}")
            qd = self.randn(B, Hkv * G, D)
            k_cur, v_cur = self.randn(B, Hkv, D), self.randn(B, Hkv, D)
            ctx, cache = self.i32([300, 0, 45]), self.i32([299, 0, 44])
            every = torch.ones(B, dtype=torch.bool, device=self.dev)
            sinks = self.randn(Hkv * G, dtype=torch.float32)
            for extras in self.arg_sets(sinks):
                for n in (None, 1, 3):
                    what = f"at D={D} G={G} S={n} {list(extras)}"
                    self.close(
                        f"decode attention {what}",
                        pa.paged_decode_attention(qd, kp, vp, pt, ctx, 1,
                                                  num_splits=n, **extras),
                        pa.paged_decode_attention_plain(qd, kp, vp, pt, ctx,
                                                        1, **extras),
                        ctx > 0)
                    self.close(
                        f"decode attention (current) {what}",
                        pa.paged_decode_attention_current(
                            qd, kp, vp, pt, cache, k_cur, v_cur, 1,
                            num_splits=n, **extras),
                        pa.paged_decode_attention_current_plain(
                            qd, kp, vp, pt, cache, k_cur, v_cur, 1, **extras),
                        every)

    def prefill_long(self, pf, ra, attention):
        """K4 and K4' at a long prompt, B = 2 x T = 2048 at q_start
        0/2048 (the second row's first 2048 keys in the pool), page tables
        of 32 pages per row from the 512-page pool: checked in all four
        argument sets (K5's window tiles too) and timed; there the bound
        is the tensor cores' operations."""
        torch = self.torch
        B, T, MP = 2, 2048, 32
        perm = torch.randperm(self.P - 1, generator=self.g,
                              device=self.dev)[:B * MP] + 1
        pt = perm.reshape(B, MP).to(torch.int32).contiguous()
        q = self.randn(B, T, self.Hq, self.D)
        k_fresh, v_fresh = self.randn(B, T, self.Hkv, self.D), \
            self.randn(B, T, self.Hkv, self.D)
        starts, lens_list = [0, 2048], [2048, 2048]
        q_start, lens = self.i32(starts), self.i32(lens_list)
        worst = self.tile_kernels(pf, ra, self.kp, self.vp, pt, q, k_fresh,
                                  v_fresh, q_start, lens, self.layer,
                                  "long prompt")
        S = MP * self.ps
        kv_pos = torch.arange(S, device=self.dev)[None, None, :]
        q_pos = q_start.long()[:, None, None] + torch.arange(
            T, device=self.dev)[None, :, None]
        mask = ((kv_pos <= q_pos) & (kv_pos < (q_start + lens).long()[
            :, None, None]))[:, None]
        idx = (q_start.long()[:, None] + torch.arange(T, device=self.dev))[
            :, :, None, None].expand(-1, -1, self.Hkv, self.D)

        def lib(fresh):
            k = attention.gather_pages(self.kp[self.layer], pt)
            v = attention.gather_pages(self.vp[self.layer], pt)
            if fresh:
                k.scatter_(1, idx, k_fresh)
                v.scatter_(1, idx, v_fresh)
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), mask)
        keys = sum(s + n for s, n in zip(starts, lens_list))
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts,
                                                             lens_list))
        nbytes = keys * 2 * self.Hkv * self.D * 2 \
            + 2 * sum(lens_list) * self.Hq * self.D * 2 + B * (8 + 4 * MP)
        flops = 4.0 * pairs * self.Hq * self.D
        args = (self.kp, self.vp, pt, q_start, lens, self.layer)
        for name, kernel, plain, a, fresh in (
                ("paged_prefill_attention", pf.paged_prefill_attention,
                 pf.paged_prefill_attention_plain, (q,) + args, False),
                ("paged_prefill_attention_fresh",
                 pf.paged_prefill_attention_fresh,
                 pf.paged_prefill_attention_fresh_plain,
                 (q, k_fresh, v_fresh) + args, True)):
            self.record(f"{name}_long_prompt",
                        f"{CSRC}/paged_prefill_attention.cu",
                        f"{PALLAS}/prefill_attention.py:272", worst,
                        lambda a=a, kernel=kernel: kernel(*a),
                        lambda a=a, plain=plain: plain(*a),
                        lambda fresh=fresh: lib(fresh), nbytes, flops,
                        entry=name, shape="B=2 T=2048 q_start 0/2048")


    # -- K3'' -------------------------------------------------------------
    def mla_decode_attention(self, pa, attention, mla_cfg, scale):
        """K3'' in both forms at DeepSeek-V2-Lite's decode shape: B=8, 16
        heads, one latent head of 576, a 27-layer pool of page size 128.
        Pool-only: contexts 117-411, row 6 inactive (context 0, zeros).
        Current: cache lengths one less, row 6 at cache length 0 (its
        current row alone); the pool is random everywhere, so the slot
        at each cache length holds a stale row unlike the current one.
        Every row compared. Then both forms at the long shapes (B = 8 x
        2048-4096 keys, B = 1 x 4096)."""
        torch = self.torch
        Hq, D = mla_cfg.num_heads, mla_cfg.kv_cache_dim
        L, P = mla_cfg.num_layers, 512
        pool = self.randn(L, P, self.ps, 1, D)
        layer = L // 2
        ctx_list = [117, 205, 298, 411, 150, 260, 0, 390]
        shapes = [("B=8 ctx 117-411", "", ctx_list, self.pt8)] + \
            self.long_decode_rows(P)
        for label, tag, ctx_list, pt in shapes:
            B, MP = len(ctx_list), pt.shape[1]
            q = self.randn(B, Hq, D)
            cur = self.randn(B, 1, D)
            cache_list = [max(c - 1, 0) for c in ctx_list]
            ctx, cache = self.i32(ctx_list), self.i32(cache_list)
            S = MP * self.ps
            pos = torch.arange(S + 1, device=self.dev)[None, :]
            sfx = f"_{tag}" if tag else ""
            for name, run, plain, keys, mask, lib_kv, valid, splits in (
                    ("paged_decode_attention_mla",
                     lambda n: pa.paged_decode_attention_mla(
                         q, pool, pt, ctx, layer, scale, num_splits=n),
                     lambda: pa.paged_decode_attention_mla_plain(
                         q, pool, pt, ctx, layer, scale),
                     sum(ctx_list),
                     (pos[:, :S] < ctx.long()[:, None]) | (pos[:, :S] == 0),
                     lambda: attention.gather_pages(pool[layer], pt),
                     ctx > 0, pa.mla_splits(B, MP, self.ps, False)),
                    ("paged_decode_attention_mla_current",
                     lambda n: pa.paged_decode_attention_mla_current(
                         q, pool, pt, cache, cur, layer, scale,
                         num_splits=n),
                     lambda: pa.paged_decode_attention_mla_current_plain(
                         q, pool, pt, cache, cur, layer, scale),
                     sum(cache_list) + B,
                     (pos < cache.long()[:, None]) | (pos == S),
                     lambda: torch.cat([attention.gather_pages(pool[layer],
                                                               pt),
                                        cur[:, None]], dim=1),
                     torch.ones(B, dtype=torch.bool, device=self.dev),
                     pa.mla_splits(B, MP, self.ps, True))):
                m = mask[:, None, None, :]

                def lib(m=m, lib_kv=lib_kv):
                    # The latent as K and V of every head (an SDPA
                    # yardstick; the port never calls it). An inactive
                    # row's mask keeps key 0 so that SDPA has a key.
                    kv = lib_kv().transpose(1, 2)
                    return sdpa(q[:, :, None], kv, kv, m, scale=scale)
                nbytes = keys * D * 2 + 2 * B * Hq * D * 2 + B * (4 + 4 * MP)
                flops = 4.0 * keys * Hq * D
                self.split_record(
                    name + sfx, name,
                    f"{CSRC}/paged_decode_attention_mla.cu", run, plain, lib,
                    nbytes, flops, splits, valid,
                    sweep=bool(tag) and name.endswith("_mla"), layers=L,
                    pool_pages=P, shape=label)
        del pool


# ---------------------------------------------------------------------------
# Phase 4: full-width forward, kernels (GPU bf16) vs plain (CPU float32)
# ---------------------------------------------------------------------------

def forward_check(torch, cfg, device) -> float:
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = tf.init_params(cfg, gen, dev)
    cpu_params = {k: (v.float().cpu() if k != "layers" else
                      {n: t.float().cpu() for n, t in v.items()})
                  for k, v in params.items()}
    P, ps, B, T = 8, 128, 2, 128
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = random.Random(7)
    tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(T)]
                           for _ in range(B)])
    start = torch.zeros(B, dtype=torch.int32)
    lens = torch.tensor([128, 77], dtype=torch.int32)
    # Then a ragged batch: row 0 decodes at position 129 (mid-page), row 1
    # continues with a 40-token window from position 78.
    rg_tokens = torch.zeros(B, 64, dtype=torch.long)
    rg_tokens[1, :40] = torch.tensor([rng.randrange(3, 259)
                                      for _ in range(40)])
    rg_start = torch.tensor([129, 78], dtype=torch.int32)
    rg_lens = torch.tensor([1, 40], dtype=torch.int32)
    # The attend-then-write order's second windows: 40 and 30 tokens at
    # q_start = the first windows' lengths.
    aw_tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(64)]
                              for _ in range(B)])
    aw_lens = torch.tensor([40, 30], dtype=torch.int32)
    results = []
    for device, p, dtype in ((dev, params, tf.torch_dtype(cfg)),
                             (torch.device("cpu"), cpu_params,
                              torch.float32)):
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        pre, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                     start.to(device), lens.to(device), kv,
                                     pt.to(device))
        nxt = pre.argmax(-1) if not results else results[0][0].argmax(-1)
        dec, kv = tf.forward_decode(
            p, cfg, nxt.to(device), lens.to(device),
            torch.ones(B, dtype=torch.bool, device=device), kv,
            pt.to(device))
        rg_tokens[0, 0] = (dec if not results else results[0][1]).argmax(
            -1)[0].item()
        rag, kv = tf.forward_prefill(p, cfg, rg_tokens.to(device),
                                     rg_start.to(device), rg_lens.to(device),
                                     kv, pt.to(device), ragged=True)
        # Attend-then-write, on a fresh pool: a first window, a second
        # at q_start 128 / 77 (unaligned), then a decode step.
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        first, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                       start.to(device), lens.to(device), kv,
                                       pt.to(device), write_then_attend=False)
        second, kv = tf.forward_prefill(p, cfg, aw_tokens.to(device),
                                        lens.to(device), aw_lens.to(device),
                                        kv, pt.to(device),
                                        write_then_attend=False)
        nxt = second.argmax(-1) if not results else results[0][4].argmax(-1)
        aw_dec, kv = tf.forward_decode(
            p, cfg, nxt.to(device), (lens + aw_lens).to(device),
            torch.ones(B, dtype=torch.bool, device=device), kv,
            pt.to(device), write_then_attend=False)
        results.append(tuple(x.float().cpu() for x in (
            pre, dec, rag, first, second, aw_dec)))
    worst, err = logit_errors(torch, results)
    log(f"[forward] llama3-1b rel L2 (GPU kernels bf16 vs CPU plain fp32): "
        f"write-then-attend prefill/decode/ragged {worst[:3]}, "
        f"attend-then-write prefill/prefill/decode {worst[3:]}; largest "
        f"logit error {err}")
    if max(worst) > FORWARD_REL_L2:
        raise AssertionError(f"forward logits rel L2 {max(worst)} > "
                             f"{FORWARD_REL_L2}")
    return max(worst), err


def logit_errors(torch, results):
    """Per forward, the relative L2 error of the kernel path's logits
    (results[0]) against the plain path's (results[1]); and the largest
    absolute logit error of all of them."""
    rels, err = [], 0.0
    for got, want in zip(results[0], results[1]):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("kernel-path logits not finite")
        rels.append(float((got - want).norm() / want.norm()))
        err = max(err, float((got - want).abs().max()))
    return rels, err


def cpu_float(params):
    """A float32 CPU copy of a parameter dict (stacks of layers too)."""
    return {k: ({n: t.cpu().float() for n, t in v.items()}
                if isinstance(v, dict) else v.cpu().float())
            for k, v in params.items()}


def mla_forward_check(torch, kernels, cfg, device) -> float:
    """DeepSeek-V2-Lite at full width (hidden 2048, 16 heads, the
    576-wide latent, 64 routed + 2 shared experts, random bf16 weights
    from a seed), its depth cut to 4 layers (the dense layer and 3 MoE
    layers) because the float32 CPU copy that the plain path runs on
    would take 63 GB at all 27. Write-then-attend: a prefill (rows of 128
    and 77 tokens), then a decode step; attend-then-write: the same
    prefill, a second window at q_start 128 / 77 (unaligned), then a
    decode step. Each against the plain path (float32 on the CPU, same
    weights): relative L2 of the logits <= 5e-2. Each decode forward on
    the GPU must launch K3'' once per layer: the latent form of K1 (the
    latent row built and written) + K3'' (write-then-attend), the latent
    form without pools + K3'' current form + one K6 (attend-then-write)."""
    from xllm_service_tpu_torch.models import transformer as tf
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = tf.init_params(cfg, gen, dev)
    cpu_params = cpu_float(params)
    L, P, ps, B, T = cfg.num_layers, 8, 128, 2, 128
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    rng = random.Random(11)
    tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(T)]
                           for _ in range(B)])
    start = torch.zeros(B, dtype=torch.int32)
    lens = torch.tensor([128, 77], dtype=torch.int32)
    aw_tokens = torch.tensor([[rng.randrange(3, 259) for _ in range(64)]
                              for _ in range(B)])
    aw_lens = torch.tensor([40, 30], dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.bool)
    results = []

    def decode(p, device, nxt, pos, kv, wta):
        kernels.reset_launch_counts()
        out, kv = tf.forward_decode(p, cfg, nxt.to(device), pos.to(device),
                                    ones.to(device), kv, pt.to(device),
                                    write_then_attend=wta)
        n = kernels.launch_counts()
        want = {k: 0 for k in n}
        if wta:
            want.update(latent_kv_update_layer=L,
                        paged_decode_attention_mla=L)
        else:
            want.update(latent_kv_update_layer=L - 1,
                        latent_kv_update_all_layers=1,
                        paged_decode_attention_mla_current=L)
        if device.type == "cuda" and n != want:
            raise AssertionError(f"MLA decode forward launches {n}, want "
                                 f"{want}")
        return out, kv

    for device, p, dtype in ((dev, params, tf.torch_dtype(cfg)),
                             (torch.device("cpu"), cpu_params,
                              torch.float32)):
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        pre, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                     start.to(device), lens.to(device), kv,
                                     pt.to(device))
        nxt = pre.argmax(-1) if not results else results[0][0].argmax(-1)
        dec, kv = decode(p, device, nxt, lens, kv, True)
        kv = tf.init_kv_cache(cfg, P, ps, device, dtype=dtype)
        first, kv = tf.forward_prefill(p, cfg, tokens.to(device),
                                       start.to(device), lens.to(device), kv,
                                       pt.to(device), write_then_attend=False)
        second, kv = tf.forward_prefill(p, cfg, aw_tokens.to(device),
                                        lens.to(device), aw_lens.to(device),
                                        kv, pt.to(device),
                                        write_then_attend=False)
        nxt = second.argmax(-1) if not results else results[0][3].argmax(-1)
        aw_dec, kv = decode(p, device, nxt, lens + aw_lens, kv, False)
        results.append(tuple(x.float().cpu() for x in (
            pre, dec, first, second, aw_dec)))
        del kv
    del params, cpu_params
    rels, err = logit_errors(torch, results)
    log(f"[forward] deepseek-v2-lite ({L} layers) rel L2 (GPU kernels bf16 "
        f"vs CPU plain fp32): write-then-attend prefill/decode {rels[:2]}, "
        f"attend-then-write prefill/prefill/decode {rels[2:]}; largest "
        f"logit error {err}")
    if max(rels) > FORWARD_REL_L2:
        raise AssertionError(f"MLA forward logits rel L2 {max(rels)} > "
                             f"{FORWARD_REL_L2}")
    return max(rels), err


def free_device_memory(torch) -> None:
    """Collect what a finished phase left (the worker and its engine sit
    in reference cycles) and return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: serving through the worker
# ---------------------------------------------------------------------------

def _prompt(rng: random.Random, n: int) -> str:
    words = ["page", "table", "kernel", "token", "decode", "prefill",
             "cache", "head", "warp", "block", "query", "value"]
    out = ""
    while len(out) < n:
        out += rng.choice(words) + " "
    return out[:n]


def _request(addr, path, body, stream, result):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    result["status"] = r.status
    if not stream:
        result["body"] = json.loads(r.read())
        result["latency_s"] = time.perf_counter() - t0
        conn.close()
        return
    frames, times, buf = [], [], b""
    while True:
        chunk = r.read1(65536) if hasattr(r, "read1") else r.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            frames.append(frame.decode())
            times.append(time.perf_counter() - t0)
    conn.close()
    result["frames"] = frames
    result["times"] = times
    result["latency_s"] = time.perf_counter() - t0


def profile_request(torch, addr: str, body: dict) -> dict:
    """One streamed request under torch.profiler: device time by kernel
    and the device's busy share of the request's wall time (the profiler
    adds host time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    res: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _request(addr, "/v1/chat/completions", body, True, res)
        torch.cuda.synchronize()
    if res.get("status") != 200:
        raise AssertionError(f"profiled request failed: {res}")
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    wall_ms = res["latency_s"] * 1e3
    busy_ms = sum(r[0] for r in rows)
    # The decode attention kernels' own device time (K3/K3' and K3''),
    # the layer body's fused writers', and PyTorch's elementwise kernels
    # and copies (cat, casts, index copies).
    k3 = {kind: sum(ms for ms, _, k in rows if f"{kernel}<" in k)
          for kind, kernel in (
              ("gqa", "paged_decode_attention_kernel"),
              ("mla", "paged_decode_attention_mla_kernel"))}
    writers = {name: sum(ms for ms, _, k in rows if k.startswith(name + "("))
               for name in ("rope_kv_write_kernel", "latent_kv_write_kernel",
                            "kv_write_kernel")}
    def is_copy(k):
        return "CatArrayBatchedCopy" in k or "copy_kernel" in k
    elementwise = sum(ms for ms, _, k in rows
                      if "elementwise_kernel" in k and not is_copy(k))
    copies = sum(ms for ms, _, k in rows if is_copy(k))
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "decode_attention_device_ms": k3,
           "writer_device_ms": writers,
           "elementwise_device_ms": elementwise,
           "cat_copy_device_ms": copies,
           "kernel_launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "count": n, "name": k[:90]}
                   for ms, n, k in rows[:14]]}
    log(f"[profile] {json.dumps(out)}")
    return out


class StepLog:
    """Wraps a live engine's ``step``: per iteration its kind, forwards,
    wall time (host clock; a step ends in the host read of its sampled
    tokens, so it includes the device's work) and hand-written kernel
    launches, and the tokens of each request, keyed by prompt length."""

    def __init__(self, engine, kernels) -> None:
        self.rows, self.tokens, self.prompts = [], {}, {}
        inner, add = engine.step, engine.add_request

        def add_request(req):
            self.prompts[len(req.token_ids)] = list(req.token_ids)
            return add(req)
        engine.add_request = add_request

        def step():
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            outs = inner()
            ms = (time.perf_counter() - t0) * 1e3
            after = kernels.launch_counts()
            self.rows.append({
                "kind": engine.last_step_kind,
                "ragged": engine.last_step_ragged,
                "forwards": engine.last_step_attn_dispatches, "ms": ms,
                "launches": {k: after[k] - before[k] for k in after}})
            for o in outs:
                self.tokens.setdefault(o.num_prompt_tokens, []).extend(
                    o.new_token_ids)
            return outs
        engine.step = step

    def clear(self) -> None:
        self.rows, self.tokens = [], {}


# The kernels of each order, by launches per forward. The layer body's
# writers run fused with the rope of q and k (dense) or with the latent
# row (MLA) in both orders; the unfused one-layer writers K1/K2 never run
# on a served path.
ONE_LAYER_KERNELS = ("rope_kv_update_layer", "rope_prefill_kv_update_layer",
                     "paged_decode_attention", "paged_prefill_attention",
                     "ragged_paged_attention")
ATTEND_THEN_WRITE_KERNELS = ("paged_kv_update", "paged_prefill_kv_update",
                             "paged_decode_attention_current",
                             "paged_prefill_attention_fresh",
                             "rope_kv_update_all_layers")
MLA_KERNELS = ("latent_kv_update_layer", "latent_prefill_kv_update_layer",
               "paged_decode_attention_mla",
               "paged_decode_attention_mla_current")
# The unfused writers: K1/K2, and K6, which the last layer's fused writer
# does in an attend-then-write decode step.
UNFUSED_WRITERS = ("paged_kv_update_layer", "paged_prefill_kv_update_layer",
                   "paged_kv_update")


def step_launches_wanted(row, layers: int, mla: bool,
                         write_then_attend: bool) -> dict:
    """The hand-written launches one step must make: one ragged forward
    (the fused prefill writer and the ragged kernel once per layer), or a
    decode forward and/or a prefill forward (a split mixed step runs
    both), each with its fused writer once per layer, in either order;
    an attend-then-write decode forward's last layer takes the writer's
    all-layer mode (K6 folded in), a prefill forward adds K7."""
    dec = int(row["kind"] in ("decode", "mixed"))
    pre = int(row["kind"] in ("prefill", "mixed"))
    want = {k: 0 for k in row["launches"]}
    if row["ragged"]:
        want.update(rope_prefill_kv_update_layer=layers,
                    ragged_paged_attention=layers)
    elif mla:
        want.update(latent_kv_update_layer=layers * dec,
                    latent_prefill_kv_update_layer=layers * pre)
        if write_then_attend:
            want.update(paged_decode_attention_mla=layers * dec)
        else:
            want.update(latent_kv_update_layer=(layers - 1) * dec,
                        latent_kv_update_all_layers=dec,
                        paged_decode_attention_mla_current=layers * dec,
                        paged_prefill_kv_update=pre)
    else:
        want.update(rope_kv_update_layer=layers * dec,
                    rope_prefill_kv_update_layer=layers * pre)
        if write_then_attend:
            want.update(paged_decode_attention=layers * dec,
                        paged_prefill_attention=layers * pre)
        else:
            want.update(rope_kv_update_layer=(layers - 1) * dec,
                        rope_kv_update_all_layers=dec,
                        paged_decode_attention_current=layers * dec,
                        paged_prefill_attention_fresh=layers * pre,
                        paged_prefill_kv_update=pre)
    return want


def serve(torch, kernels, model: str, device: str, ragged: bool,
          write_then_attend: bool = True, tag: str = "",
          on_engine=None) -> dict:
    """Phase 5 (ragged off), 5b (ragged on), 5c (attend-then-write), 5d
    and 5e (DeepSeek-V2-Lite in either order): 4 concurrent requests
    through the worker; checks the replies and which kernels ran.
    ``on_engine(engine, tokens)``, if given, runs on the live engine once
    the requests are served (``tokens``: each request's, by prompt
    length); its result is ``out["on_engine"]``."""
    from xllm_service_tpu_torch.runtime import worker
    args = worker.parse_args([
        "--model", model, "--device", device,
        "--page-size", "128", "--num-pages", "512",
        "--max-model-len", "1024", "--max-batch-size", "8",
        "--prefill-buckets", "128,256,512", "--max-prefill-tokens", "256"])
    # The engine reads the switches once, when its config is built.
    env = {"XLLM_RAGGED_ATTN": "1" if ragged else "0",
           "XLLM_WRITE_THEN_ATTEND": "1" if write_then_attend else "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        w = worker.build_worker(args).start()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    layers = w.engine.cfg.num_layers
    mla = w.engine.cfg.mla
    torch.cuda.reset_peak_memory_stats()
    steplog = StepLog(w.engine, kernels)
    try:
        rng = random.Random(0)
        warm = {}
        _request(w.name, "/v1/completions",
                 {"prompt": _prompt(rng, 64), "max_tokens": 4,
                  "temperature": 0.0}, False, warm)
        if warm["status"] != 200:
            raise AssertionError(f"warm-up request failed: {warm}")
        plan = [
            ("/v1/chat/completions", True, 380),
            ("/v1/completions", False, 250),
            ("/v1/chat/completions", True, 120),
            ("/v1/completions", False, 330),
        ]
        bodies = []
        for path, stream, n in plan:
            body = {"max_tokens": 32, "temperature": 0.0, "ignore_eos": True,
                    "stream": stream}
            if path.endswith("chat/completions"):
                body["messages"] = [{"role": "user",
                                     "content": _prompt(rng, n)}]
            else:
                body["prompt"] = _prompt(rng, n)
            if stream:
                # With logprobs every token gets its own frame, even one
                # whose text is empty (random weights mostly sample ids
                # past the byte tokenizer's range), so frames time tokens.
                body["stream_options"] = {"include_usage": True}
                body["logprobs"] = True
            bodies.append(body)
        steps0 = w.engine.step_count
        ragged0 = w.engine.ragged_steps
        kernels.reset_launch_counts()
        steplog.clear()
        results = [{} for _ in plan]
        threads = [threading.Thread(target=_request,
                                    args=(w.name, p, b, s, r))
                   for (p, s, _), b, r in zip(plan, bodies, results)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        steps = w.engine.step_count - steps0
        ragged_steps = w.engine.ragged_steps - ragged0
        rows = list(steplog.rows)
        tokens = {n: list(t) for n, t in steplog.tokens.items()}
        prof = None
        if not ragged:
            n0 = len(steplog.rows)
            prof = profile_request(torch, w.name, bodies[0])
            fwd = sum(r["forwards"] for r in steplog.rows[n0:])
            prof["forwards"] = fwd
            prof["kernel_launches_per_forward"] = (
                prof["kernel_launches"] / fwd if fwd else None)
        prompts = dict(steplog.prompts)
        on_engine_out = on_engine(w.engine, tokens) if on_engine else None
    finally:
        w.stop()
    engine_ragged, engine_wta = w.engine.ragged, w.engine.write_then_attend
    del w, steplog
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ttfts, decode_rates, total_tokens = [], [], 0
    for (path, stream, n), r in zip(plan, results):
        if r.get("status") != 200:
            raise AssertionError(f"{path} returned {r.get('status')}: {r}")
        if stream:
            frames = r["frames"]
            if frames[-1] != "data: [DONE]":
                raise AssertionError(f"stream did not end in [DONE]: "
                                     f"{frames[-2:]}")
            objs = [json.loads(f[len("data: "):]) for f in frames[:-1]]
            tok_t = [r["times"][i] for i, o in enumerate(objs)
                     if o["choices"] and o["choices"][0].get("logprobs")]
            usage = objs[-1]["usage"]
            if usage["completion_tokens"] != 32 or len(tok_t) != 32:
                raise AssertionError(f"stream usage {usage}, "
                                     f"{len(tok_t)} token frames")
            ttfts.append(tok_t[0] * 1e3)
            decode_rates.append(31 / (tok_t[-1] - tok_t[0]))
            total_tokens += usage["completion_tokens"]
        else:
            usage = r["body"]["usage"]
            if usage["completion_tokens"] != 32 or \
                    r["body"]["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"completion body {r['body']}")
            total_tokens += usage["completion_tokens"]
    if engine_ragged != ragged or engine_wta != write_then_attend:
        raise AssertionError(
            f"engine.ragged={engine_ragged}, write_then_attend="
            f"{engine_wta}; want {ragged}, {write_then_attend}")
    # Every step exactly (step_launches_wanted): the fused writer once per
    # layer per forward, in every path; write-then-attend, K3 x layers per
    # decode forward and K4 x layers per prefill forward, or one ragged
    # forward with K5 x layers; attend-then-write, K3' x layers per decode
    # forward with the last layer's writer in its all-layer mode, K4' x
    # layers + K7 per prefill forward; MLA, K3'' (pool-only or current
    # form) x layers per decode forward, its prefill attention plain, the
    # all-layer mode / K7 in attend-then-write. No other kernel, so the
    # unfused writers K1/K2 and K6 never.
    need = set()
    for row in rows:
        if ragged and row["kind"] == "mixed" and not row["ragged"]:
            raise AssertionError(f"a mixed iteration ran split: {row}")
        want = step_launches_wanted(row, layers, mla, write_then_attend)
        dec = int(row["kind"] in ("decode", "mixed"))
        pre = int(row["kind"] in ("prefill", "mixed"))
        forwards = 1 if row["ragged"] else dec + pre
        if row["launches"] != want or row["forwards"] != forwards:
            raise AssertionError(f"step launches: {row}, want {want}")
        need |= {k for k, n in want.items() if n}
    if ragged and ragged_steps < 1:
        raise AssertionError("no ragged iteration ran")
    if any(counts[k] for k in UNFUSED_WRITERS):
        raise AssertionError(f"an unfused writer ran: {counts}")
    need = sorted(need)
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({counts})")
    mixed = [r for r in rows if r["kind"] == "mixed"]
    decode_rows = [r for r in rows if r["kind"] == "decode"]
    out = {"model": model, "layers": layers, "ragged": ragged,
           "write_then_attend": write_then_attend,
           "launches": counts, "engine_steps": steps,
           "ragged_steps": ragged_steps,
           "ttft_ms_streams": ttfts,
           "decode_tokens_per_s_streams": decode_rates,
           "completion_tokens": total_tokens, "wall_s": wall,
           "tokens_per_s_aggregate": total_tokens / wall,
           "forwards_per_request": sum(r["forwards"] for r in rows)
           / len(plan),
           "mixed_steps": len(mixed),
           "forwards_per_mixed_step": (sum(r["forwards"] for r in mixed)
                                       / len(mixed) if mixed else None),
           "kernel_launches_per_mixed_step": (
               sum(sum(r["launches"].values()) for r in mixed) / len(mixed)
               if mixed else None),
           "mixed_step_ms": sorted(r["ms"] for r in mixed),
           "kernel_launches_per_decode_step": (
               sum(sum(r["launches"].values()) for r in decode_rows)
               / len(decode_rows) if decode_rows else None),
           "decode_step_ms_median": _median(
               [r["ms"] for r in rows if r["kind"] == "decode"]),
           "prefill_step_ms_median": _median(
               [r["ms"] for r in rows if r["kind"] == "prefill"]),
           "max_memory_allocated_gib": peak_gb,
           "profile": prof}
    log(f"[serve{tag}] {json.dumps(out)}")
    out["tokens"], out["prompts"] = tokens, prompts
    out["on_engine"] = on_engine_out
    return out


def _last_logits(torch, params, cfg, ids, device, dtype, path):
    """The logits after ``ids`` from one prefill forward of the whole
    sequence, on ``device`` through ``path`` (ragged, write_then_attend)."""
    from xllm_service_tpu_torch.models import transformer as tf
    ps, T = 128, len(ids)
    pages = -(-T // ps)
    kv = tf.init_kv_cache(cfg, pages + 1, ps, device, dtype=dtype)
    table = torch.arange(1, pages + 1, dtype=torch.int32,
                         device=device)[None]
    logits, _ = tf.forward_prefill(
        params, cfg, torch.tensor([ids], device=device),
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.tensor([T], dtype=torch.int32, device=device), kv, table,
        ragged=path["ragged"],
        write_then_attend=path["ragged"] or path["write_then_attend"])
    return logits[0].float().cpu()


def divergence_margins(torch, engine, pairs, err, cpu_params=None):
    """At each stream's first divergent token between two served paths,
    the top-2 logit margin of one forward over the common prefix (the
    prompt and the tokens both streams share): on the card through each
    path, and with ``cpu_params`` under the plain float32 path on the
    CPU. ``pairs``: (tag, tokens_a, path_a, tokens_b, path_b, prompts),
    tokens by prompt length. A divergence whose reference margin (the
    CPU's where there is one, else the smaller card margin) is wider
    than 10 x ``err`` (phase 4's largest logit error for the model) is
    a fault; a narrower one is drift."""
    from xllm_service_tpu_torch.models import transformer as tf
    dtype = tf.torch_dtype(engine.cfg)
    out = []
    for tag, tok_a, path_a, tok_b, path_b, prompts in pairs:
        for n in sorted(tok_a):
            a, b = tok_a[n], tok_b.get(n, [])
            i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                continue
            ids = prompts[n] + a[:i]
            rec = {"pair": tag, "prompt_tokens": n, "position": i,
                   "served": [a[i], b[i]]}
            for side, path in (("a", path_a), ("b", path_b)):
                top = torch.topk(_last_logits(torch, engine.params,
                                              engine.cfg, ids, engine.device,
                                              dtype, path), 2)
                rec[f"margin_{side}"] = float(top.values[0] - top.values[1])
                rec[f"top2_{side}"] = top.indices.tolist()
            ref = min(rec["margin_a"], rec["margin_b"])
            if cpu_params is not None:
                top = torch.topk(_last_logits(
                    torch, cpu_params, engine.cfg, ids, torch.device("cpu"),
                    torch.float32, {"ragged": False,
                                    "write_then_attend": False}), 2)
                rec["margin_cpu_fp32"] = ref = float(top.values[0]
                                                     - top.values[1])
                rec["top2_cpu_fp32"] = top.indices.tolist()
            rec["limit"] = 10 * err
            rec["verdict"] = "fault" if ref > 10 * err else "drift"
            out.append(rec)
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    if not (ROOT / "xllm_service_tpu_torch").is_dir():
        log("chip_smoke: run it from a checkout of the repository (the "
            "xllm_service_tpu_torch package is not beside this script)")
        return 2
    sys.path.insert(0, str(ROOT))
    from xllm_service_tpu_torch.config import ModelConfig
    from xllm_service_tpu_torch.models import transformer
    from xllm_service_tpu_torch.ops import attention, kernels, rope
    from xllm_service_tpu_torch.ops.kernels import (_build, kv_update,
                                                    paged_attention,
                                                    prefill_attention,
                                                    ragged_attention)

    t_start = time.perf_counter()
    # 1. Device.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "wgmma")):
                log(f"[ptxas] {name}: {line.strip()}")

    # 3. Kernels against their plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_1b()
    bench = KernelBench(torch, cfg, "cuda")
    bench.decode_writer(kv_update)
    bench.prefill_writer(kv_update)
    bench.rope_decode_writer(kv_update, rope)
    bench.rope_prefill_writer(kv_update, rope)
    bench.decode_attention(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    bench.ragged_attention(ragged_attention, paged_attention,
                           prefill_attention, attention)
    bench.ragged_attention_long(ragged_attention, paged_attention,
                                prefill_attention, attention)
    bench.ragged_attention_wide(ragged_attention)
    bench.all_layer_writers(kv_update, cfg.num_layers, cfg.num_kv_heads,
                            cfg.head_dim, record=True)
    bench.all_layer_writers(kv_update, 4, 1, 576, record=False)  # MLA row
    bench.decode_attention_current(paged_attention, attention)
    bench.decode_attention_long(paged_attention, attention)
    bench.prefill_attention_fresh(prefill_attention, attention)
    bench.head_dims(prefill_attention, ragged_attention, paged_attention)
    bench.prefill_long(prefill_attention, ragged_attention, attention)
    mla_cfg = ModelConfig.deepseek_v2_lite()
    bench.mla_decode_attention(paged_attention, attention, mla_cfg,
                               transformer._mla_scale(mla_cfg))
    bench.latent_writers(kv_update, rope, mla_cfg)
    bench.fold_writers(kv_update, rope, mla_cfg)
    bench.poison_current_slot(paged_attention, transformer._mla_scale(mla_cfg))
    latent = bench.latent_pools()                 # K1/K2 at the latent row
    bench.decode_writer(kv_update, latent)
    bench.prefill_writer(kv_update, latent)
    del bench.kp, bench.vp, latent
    free_device_memory(torch)

    # 4. Forward pass: llama3-1b, then DeepSeek-V2-Lite cut to 4 layers.
    rel, err = forward_check(torch, cfg, "cuda")
    free_device_memory(torch)
    rel_mla, err_mla = mla_forward_check(
        torch, kernels, dataclasses.replace(mla_cfg, num_layers=4), "cuda")
    free_device_memory(torch)

    # 5. Serving, split path; 5b. serving, ragged step; 5c. serving,
    # attend-then-write; 5d/5e. DeepSeek-V2-Lite, 27 layers, in the GPU
    # default order and in attend-then-write.
    # Each phase's path; every llama3-1b phase serves the same weights
    # (the engine's seed), and so does every DeepSeek one. The margins of
    # the streams' first divergent tokens are read on the live engine of
    # each model's last phase (5c, 5e).
    split_wta = {"ragged": False, "write_then_attend": True}
    ragged_path = {"ragged": True, "write_then_attend": True}
    split_atw = {"ragged": False, "write_then_attend": False}
    served = serve(torch, kernels, "llama3-1b", "cuda", ragged=False)
    free_device_memory(torch)
    served_b = serve(torch, kernels, "llama3-1b", "cuda", ragged=True,
                     tag="b")
    free_device_memory(torch)
    tok_a, tok_b = served.pop("tokens"), served_b.pop("tokens")
    served_c = serve(
        torch, kernels, "llama3-1b", "cuda", ragged=False,
        write_then_attend=False, tag="c",
        on_engine=lambda eng, tok_c: divergence_margins(
            torch, eng, [("ragged", tok_a, split_wta, tok_b, ragged_path,
                          served["prompts"]),
                         ("attend_then_write", tok_a, split_wta, tok_c,
                          split_atw, served["prompts"])],
            err, cpu_float(eng.params)))
    free_device_memory(torch)
    served_d = serve(torch, kernels, "deepseek-v2-lite", "cuda",
                     ragged=False, tag="d")
    free_device_memory(torch)
    tok_d = served_d.pop("tokens")
    served_e = serve(
        torch, kernels, "deepseek-v2-lite", "cuda", ragged=False,
        write_then_attend=False, tag="e",
        on_engine=lambda eng, tok_e: divergence_margins(
            torch, eng, [("deepseek_orders", tok_d, split_wta, tok_e,
                          split_atw, served_d["prompts"])], err_mla))
    free_device_memory(torch)
    same = {}
    for tag, tok_x, tok_y in (("ragged", tok_a, tok_b),
                              ("attend_then_write", tok_a,
                               served_c.pop("tokens"))):
        pairs = [(x, y) for n in tok_x for x, y in zip(tok_x[n],
                                                       tok_y.get(n, []))]
        same[tag] = (sum(x == y for x, y in pairs) / len(pairs)
                     if pairs else None)
    log(f"[serve] {card}: split vs ragged: TTFT ms "
        f"{served['ttft_ms_streams']} vs {served_b['ttft_ms_streams']}; "
        f"decode tokens/s per stream {served['decode_tokens_per_s_streams']}"
        f" vs {served_b['decode_tokens_per_s_streams']}; engine steps "
        f"{served['engine_steps']} vs {served_b['engine_steps']}; forwards "
        f"per request {served['forwards_per_request']} vs "
        f"{served_b['forwards_per_request']}; kernel launches per mixed "
        f"iteration {served['kernel_launches_per_mixed_step']} vs "
        f"{served_b['kernel_launches_per_mixed_step']}; share of equal "
        f"tokens {same['ragged']}")
    log(f"[serve] {card}: write-then-attend (5) vs attend-then-write (5c): "
        f"TTFT ms {served['ttft_ms_streams']} vs "
        f"{served_c['ttft_ms_streams']}; decode tokens/s per stream "
        f"{served['decode_tokens_per_s_streams']} vs "
        f"{served_c['decode_tokens_per_s_streams']}; hand-written kernel "
        f"launches per decode step "
        f"{served['kernel_launches_per_decode_step']} vs "
        f"{served_c['kernel_launches_per_decode_step']}; median decode "
        f"step ms {served['decode_step_ms_median']} vs "
        f"{served_c['decode_step_ms_median']}; share of equal tokens "
        f"{same['attend_then_write']}")
    p5, p5c = served["profile"], served_c["profile"]
    log(f"[profile] {card}: one profiled stream, write-then-attend (5) vs "
        f"attend-then-write (5c): device kernel launches "
        f"{p5['kernel_launches']} vs {p5c['kernel_launches']} in "
        f"{p5['forwards']} vs {p5c['forwards']} forwards "
        f"({p5['kernel_launches_per_forward']} vs "
        f"{p5c['kernel_launches_per_forward']} per forward); device busy ms "
        f"{p5['device_busy_ms']} vs {p5c['device_busy_ms']}; idle share "
        f"{p5['idle_share']} vs {p5c['idle_share']}")
    tok_e = served_e.pop("tokens")
    pairs = [(x, y) for n in tok_d for x, y in zip(tok_d[n],
                                                   tok_e.get(n, []))]
    same["deepseek_orders"] = (sum(x == y for x, y in pairs) / len(pairs)
                               if pairs else None)
    p5d, p5e = served_d["profile"], served_e["profile"]
    log(f"[serve] {card}: deepseek-v2-lite write-then-attend (5d) vs "
        f"attend-then-write (5e): TTFT ms {served_d['ttft_ms_streams']} vs "
        f"{served_e['ttft_ms_streams']}; decode tokens/s per stream "
        f"{served_d['decode_tokens_per_s_streams']} vs "
        f"{served_e['decode_tokens_per_s_streams']}; median decode step ms "
        f"{served_d['decode_step_ms_median']} vs "
        f"{served_e['decode_step_ms_median']}; device busy ms per profiled "
        f"stream {p5d['device_busy_ms']} vs {p5e['device_busy_ms']}, of it "
        f"K3'' {p5d['decode_attention_device_ms']['mla']} vs "
        f"{p5e['decode_attention_device_ms']['mla']}; idle "
        f"share {p5d['idle_share']} vs {p5e['idle_share']}; share of equal "
        f"tokens {same['deepseek_orders']}")

    log(f"[profile] {card}: one profiled stream, kernel launches per "
        f"forward: llama3-1b 5 {p5['kernel_launches_per_forward']}, 5c "
        f"{p5c['kernel_launches_per_forward']}; deepseek-v2-lite 5d "
        f"{p5d['kernel_launches_per_forward']}, 5e "
        f"{p5e['kernel_launches_per_forward']}; PyTorch elementwise device "
        f"ms 5 {p5['elementwise_device_ms']}, 5c "
        f"{p5c['elementwise_device_ms']}, 5d {p5d['elementwise_device_ms']}, "
        f"5e {p5e['elementwise_device_ms']}; cat/copy device ms 5 "
        f"{p5['cat_copy_device_ms']}, 5c {p5c['cat_copy_device_ms']}, 5d "
        f"{p5d['cat_copy_device_ms']}, 5e {p5e['cat_copy_device_ms']}")
    margins = served_c["on_engine"] + served_e["on_engine"]
    for phase in (served, served_b, served_c, served_d, served_e):
        phase.pop("prompts")
        phase.pop("on_engine")
    log(f"[margins] {card}: top-2 logit margin at each stream's first "
        f"divergent token between served paths (limit: 10 x phase 4's "
        f"largest logit error, llama3-1b {err}, deepseek-v2-lite "
        f"{err_mla}): {json.dumps(margins)}")

    # 6. Summary.
    for r in bench.results:
        name = r.get("entry", r["name"])       # a record at another shape
        phase = (served_b if name == "ragged_paged_attention" else
                 served_c if name in ATTEND_THEN_WRITE_KERNELS else
                 served_e if name in ("paged_decode_attention_mla_current",
                                      "latent_kv_update_all_layers")
                 else served_d if name in MLA_KERNELS else
                 served)
        r["launches"] = phase["launches"][name]
    summary = {"card": card, "build_s": build_s, "forward_rel_l2": rel,
               "forward_rel_l2_deepseek": rel_mla,
               "forward_max_abs_logit_err": err,
               "forward_max_abs_logit_err_deepseek": err_mla,
               "divergence_margins": margins,
               "serve": served, "serve_ragged": served_b,
               "serve_attend_then_write": served_c,
               "serve_deepseek": served_d,
               "serve_deepseek_attend_then_write": served_e,
               "equal_token_share": same,
               "seconds": time.perf_counter() - t_start}
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": bench.results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
