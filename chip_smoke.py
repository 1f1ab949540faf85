#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. Device: the card's name and power limit (nvidia-smi).
2. Build: every CUDA kernel of ``xllm_service_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (parallel, one nvcc per source).
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors at the serving shapes of llama3-1b (B=8 decode rows,
   a 4-row prefill window batch, page size 128, bf16). KV writers must
   be bit-exact; attention must agree within atol = rtol = 2e-2 (bf16
   outputs; the plain version rounds its probabilities to bf16 before
   P @ V) on active rows / valid query rows, with plain, windowed,
   soft-capped and sink cases. Each kernel is timed with CUDA events
   (>= 20 launches after warm-up) beside its plain version, one PyTorch
   library call computing the same function, and its bound (bytes over
   3.35 TB/s or operations over 989 TFLOP/s, whichever is larger).
4. Forward: a full-width llama3-1b forward_prefill + forward_decode
   through the kernels (bf16 on the GPU) against the plain path (float32
   on the CPU, same weights): logits within a relative L2 error of 5e-2
   (16 bf16 layers against float32).
5. Serving: the worker the CLI builds (``runtime.worker`` with
   --model llama3-1b --page-size 128 --num-pages 512 --max-model-len 1024
   --max-batch-size 8, prefill buckets 128,256,512, 256 prefill tokens
   per step so the longer prompts prefill in chunks) answers 4
   concurrent requests (2 streamed chats, 2 non-streamed completions,
   prompts of 100-400 tokens, 32 new tokens, temperature 0). Launch
   counts are zeroed just before and read just after: every kernel must
   have run.
6. Summary: one line ``{"kernels": [...]}``, the card line, then the last
   line ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import json
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
ATTN_TOL = 2e-2
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask):
    """One library call: q [B, Hq, Tq, D]; k/v [B, Hkv, S, D]."""
    import torch
    import torch.nn.functional as F
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        attn_mask=mask)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

class KernelBench:
    """Serving-shape inputs for llama3-1b and the checks/timings of the
    four kernels."""

    def __init__(self, torch, cfg, device) -> None:
        self.torch = torch
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
               nbytes, flops):
        """Time ``kernel`` (the wrapper) and ``library`` as device time
        (graph replay), the wrapper also per eager call (device time plus
        its host overhead), and ``plain`` per eager call (it syncs with
        the host, so it cannot be captured)."""
        ms, lib_ms = graph_ms(kernel), graph_ms(library)
        eager_ms, plain_ms = time_ms(kernel), time_ms(plain)
        b_ms, b_by = bound(nbytes, flops)
        self.results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
        log(f"[kernel] {name}: max_abs_err={err} ms={ms:.5f} "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={lib_ms:.5f} bound_ms={b_ms:.6f} ({b_by})")

    # -- K1 ----------------------------------------------------------------
    def decode_writer(self, kv):
        torch = self.torch
        B = 8
        row_bytes = self.Hkv * self.D * 2
        kn, vn = self.randn(B, self.Hkv, self.D), self.randn(B, self.Hkv,
                                                             self.D)
        ctx = [117, 205, 298, 411, 150, 260, 333, 390]
        pos = self.i32([c - 1 for c in ctx])
        pt = self.pt8.clone()
        pt[5, 2] = 0                      # row 5's page is NULL: dropped
        active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                              device=self.dev)      # an inactive row
        ka, va = self.kp.clone(), self.vp.clone()
        kb, vb = self.kp.clone(), self.vp.clone()
        kv.paged_kv_update_layer(ka, va, kn, vn, pt, pos, active, self.layer)
        kv.paged_kv_update_layer_plain(kb, vb, kn, vn, pt, pos, active,
                                       self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError("decode KV writer is not bit-exact")
        changed = int((ka != self.kp).flatten(2).any(-1).sum())
        if changed != 6:                           # rows 5 and 6 dropped
            raise AssertionError(f"decode writer touched {changed} pages")
        all_on = torch.ones(B, dtype=torch.bool, device=self.dev)
        pt = self.pt8
        flat = (pt.long().gather(1, (pos.long() // self.ps)[:, None])[:, 0]
                * self.ps + pos.long() % self.ps)
        kf = ka[self.layer].view(self.P * self.ps, self.Hkv, self.D)
        vf = va[self.layer].view(self.P * self.ps, self.Hkv, self.D)

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
            lib, nbytes, 0.0)

    # -- K2 ----------------------------------------------------------------
    def prefill_writer(self, kv):
        torch = self.torch
        B, T = 4, 256
        row_bytes = self.Hkv * self.D * 2
        kn, vn = self.randn(B, T, self.Hkv, self.D), \
            self.randn(B, T, self.Hkv, self.D)
        pt = self.pt8[:B].contiguous()
        start = self.i32([0, 256, 128, 7])            # last row unaligned
        lens = self.i32([256, 144, 200, 97])
        ka, va = self.kp.clone(), self.vp.clone()
        kb, vb = self.kp.clone(), self.vp.clone()
        kv.paged_prefill_kv_update_layer(ka, va, kn, vn, pt, start, lens,
                                         self.layer)
        kv.paged_prefill_kv_update_layer_plain(kb, vb, kn, vn, pt, start,
                                               lens, self.layer)
        torch.cuda.synchronize()
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            raise AssertionError("prefill KV writer is not bit-exact")
        t = torch.arange(T, device=self.dev)
        valid = t[None, :] < lens.long()[:, None]
        pos = start.long()[:, None] + t[None, :]
        flat = (pt.long().gather(1, pos // self.ps) * self.ps
                + pos % self.ps)[valid]
        kr, vr = kn[valid], vn[valid]
        kf = ka[self.layer].view(self.P * self.ps, self.Hkv, self.D)
        vf = va[self.layer].view(self.P * self.ps, self.Hkv, self.D)

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
            lib, nbytes, 0.0)

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
        self.record(
            "paged_decode_attention", f"{CSRC}/paged_decode_attention.cu",
            f"{PALLAS}/paged_attention.py:154", worst,
            lambda: pa.paged_decode_attention(q, self.kp, self.vp, self.pt8,
                                              ctx, self.layer),
            lambda: pa.paged_decode_attention_plain(
                q, self.kp, self.vp, self.pt8, ctx, self.layer),
            lib, nbytes, flops)

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
        for extras in ({}, {"sliding_window": 100},
                       {"logits_soft_cap": 30.0, "scale": 0.1},
                       {"sinks": sinks, "sliding_window": 64}):
            got = pf.paged_prefill_attention(q, self.kp, self.vp, pt,
                                             q_start, lens, self.layer,
                                             **extras)
            want = pf.paged_prefill_attention_plain(
                q, self.kp, self.vp, pt, q_start, lens, self.layer, **extras)
            torch.cuda.synchronize()
            g, w = got[valid].float(), want[valid].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"prefill attention not finite {extras}")
            if not torch.allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL):
                raise AssertionError(
                    f"prefill attention disagrees ({list(extras)}): "
                    f"{float((g - w).abs().max())}")
            if bool(got[~valid].float().abs().max() != 0):
                raise AssertionError("padded prefill rows not zero")
            worst = max(worst, float((g - w).abs().max()))
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
        results.append((pre.float().cpu(), dec.float().cpu()))
    worst = 0.0
    for got, want in zip(results[0], results[1]):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("kernel-path logits not finite")
        rel = float((got - want).norm() / want.norm())
        worst = max(worst, rel)
    log(f"[forward] llama3-1b prefill+decode rel L2 (GPU kernels bf16 vs "
        f"CPU plain fp32): {worst:.5f}")
    if worst > FORWARD_REL_L2:
        raise AssertionError(f"forward logits rel L2 {worst} > "
                             f"{FORWARD_REL_L2}")
    return worst


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
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "kernel_launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "count": n, "name": k[:90]}
                   for ms, n, k in rows[:14]]}
    log(f"[profile] {json.dumps(out)}")
    return out


def serve(torch, kernels, model: str, device: str) -> dict:
    from xllm_service_tpu_torch.runtime import worker
    args = worker.parse_args([
        "--model", model, "--device", device,
        "--page-size", "128", "--num-pages", "512",
        "--max-model-len", "1024", "--max-batch-size", "8",
        "--prefill-buckets", "128,256,512", "--max-prefill-tokens", "256"])
    w = worker.build_worker(args).start()
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
        kernels.reset_launch_counts()
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
        prof = profile_request(torch, w.name, bodies[0])
    finally:
        w.stop()
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
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({counts})")
    out = {"launches": counts, "engine_steps": steps,
           "ttft_ms_streams": ttfts,
           "decode_tokens_per_s_streams": decode_rates,
           "completion_tokens": total_tokens, "wall_s": wall,
           "tokens_per_s_aggregate": total_tokens / wall,
           "profile": prof}
    log(f"[serve] {json.dumps(out)}")
    return out


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
    from xllm_service_tpu_torch.ops import attention, kernels
    from xllm_service_tpu_torch.ops.kernels import (_build, kv_update,
                                                    paged_attention,
                                                    prefill_attention)

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
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    # 3. Kernels against their plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_1b()
    bench = KernelBench(torch, cfg, "cuda")
    bench.decode_writer(kv_update)
    bench.prefill_writer(kv_update)
    bench.decode_attention(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    del bench.kp, bench.vp
    torch.cuda.empty_cache()

    # 4. Forward pass.
    rel = forward_check(torch, cfg, "cuda")
    torch.cuda.empty_cache()

    # 5. Serving.
    served = serve(torch, kernels, "llama3-1b", "cuda")

    # 6. Summary.
    for r in bench.results:
        r["launches"] = served["launches"][r["name"]]
    summary = {"card": card, "build_s": build_s, "forward_rel_l2": rel,
               "serve": served}
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": bench.results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
