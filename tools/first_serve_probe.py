#!/usr/bin/env python3
"""Where a first serve's slow prefill steps go, on one GPU.

    python3 tools/first_serve_probe.py [--serves 3] [--no-kernels]

Runs ``chip_smoke.py``'s phases in its order up to phase 5 (phase 3's
kernel bench unless ``--no-kernels``, then phase 4's forward checks),
then serves phase 5 (llama3-1b, write-then-attend, graphs on) ``--serves``
times in the same process. Every ``Engine.step`` and every pass of
Python's cyclic garbage collector is timed on one clock. Per serve it
prints one ``[probe]`` line: the objects the collector tracks before
it, the streams' TTFT, the prefill step's median ms, each step over 20
ms with the collector passes that ran inside it, and the ms of every
generation-2 pass. Then the card's name and power limit. Builds the
kernels as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xllm_service_tpu_torch.config import ModelConfig  # noqa: E402
from xllm_service_tpu_torch.models import transformer  # noqa: E402
from xllm_service_tpu_torch.ops import attention, kernels, rope  # noqa: E402
from xllm_service_tpu_torch.ops.kernels import (  # noqa: E402
    _build, kv_update, paged_attention, prefill_attention, ragged_attention)
from xllm_service_tpu_torch.runtime import engine as engine_mod  # noqa: E402


def kernel_bench(cfg) -> None:
    """Phase 3's checks and timings, in ``chip_smoke.main``'s order."""
    bench = cs.KernelBench(torch, cfg, "cuda")
    bench.decode_writer(kv_update)
    bench.prefill_writer(kv_update)
    bench.rope_decode_writer(kv_update, rope)
    bench.rope_prefill_writer(kv_update, rope)
    bench.decode_attention(paged_attention, attention)
    bench.decode_attention_null_lead(paged_attention, attention)
    bench.prefill_attention(prefill_attention, attention)
    bench.ragged_attention(ragged_attention, paged_attention,
                           prefill_attention, attention)
    bench.ragged_attention_long(ragged_attention, paged_attention,
                                prefill_attention, attention)
    bench.ragged_attention_wide(ragged_attention)
    bench.ragged_attention_rows(ragged_attention)
    bench.all_layer_writers(kv_update, cfg.num_layers, cfg.num_kv_heads,
                            cfg.head_dim, record=True)
    bench.decode_attention_current(paged_attention, attention)
    bench.decode_attention_long(paged_attention, attention)
    bench.prefill_attention_fresh(prefill_attention, attention)
    bench.cached_start(prefill_attention, ragged_attention, paged_attention,
                       kv_update, attention)
    bench.head_dims(prefill_attention, ragged_attention, paged_attention)
    bench.prefill_long(prefill_attention, ragged_attention, attention)
    mla_cfg = ModelConfig.deepseek_v2_lite()
    bench.mla_decode_attention(paged_attention, attention, mla_cfg,
                               transformer._mla_scale(mla_cfg))
    bench.latent_writers(kv_update, rope, mla_cfg)
    bench.fold_writers(kv_update, rope, mla_cfg)
    del bench
    cs.free_device_memory(torch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--serves", type=int, default=3)
    p.add_argument("--no-kernels", dest="kernels", action="store_false")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cs.log("first_serve_probe: no CUDA device is available")
        return 2
    _build.build_all()
    passes, steps, started = [], [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            passes.append((info["generation"], started["t"],
                           time.perf_counter()))
    gc.callbacks.append(on_gc)
    step = engine_mod.Engine.step

    def timed_step(self):
        t0 = time.perf_counter()
        try:
            return step(self)
        finally:
            steps.append((self.last_step_kind, t0, time.perf_counter()))
    engine_mod.Engine.step = timed_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_1b()
    if args.kernels:
        kernel_bench(cfg)
    cs.forward_check(torch, cfg, "cuda")
    cs.free_device_memory(torch)
    cs.mla_forward_check(torch, kernels, dataclasses.replace(
        ModelConfig.deepseek_v2_lite(), num_layers=4), "cuda")
    cs.free_device_memory(torch)
    for i in range(args.serves):
        passes.clear()
        steps.clear()
        tracked = len(gc.get_objects())
        out = cs.serve(torch, kernels, "llama3-1b", "cuda", ragged=False,
                       tag=f"probe{i}")
        slow = [(kind, (b - a) * 1e3,
                 [(g, (e - s) * 1e3) for g, s, e in passes
                  if s >= a and e <= b])
                for kind, a, b in steps if (b - a) * 1e3 > 20]
        print(f"[probe] serve {i}: " + json.dumps({
            "tracked_objects": tracked,
            "ttft_ms": out["ttft_ms_streams"],
            "prefill_step_ms_median": out["prefill_step_ms_median"],
            "steps_over_20_ms": slow,
            "gen2_pass_ms": [(e - s) * 1e3 for g, s, e in passes
                             if g == 2]}), flush=True)
        cs.free_device_memory(torch)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
