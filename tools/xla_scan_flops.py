#!/usr/bin/env python3
"""XLA's ``cost_analysis()`` FLOPs of the JAX engine's warmup programs
beside the analytic count of the PyTorch port (``models/cost.py``).

    JAX_PLATFORMS=cpu python3 tools/xla_scan_flops.py [--layers N]

The JAX engine (``xllm_service_tpu``) fills its roofline table at warmup
from ``.lower().compile().cost_analysis()``; its forward runs the layer
stack as one ``lax.scan``, and XLA's count takes the scan body once. The
script warms up the tiny float32 model (``extended=False``: the first
prefill and decode shapes) at 1 and at ``--layers`` layers and prints,
per program key, XLA's FLOPs and the port's GEMM and attention FLOPs at
the same shape. Runs on the CPU in a few seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    from xllm_service_tpu.config import EngineConfig, ModelConfig
    from xllm_service_tpu.runtime.engine import Engine
    from xllm_service_tpu_torch.config import ModelConfig as PortConfig
    from xllm_service_tpu_torch.models import cost
    ecfg = EngineConfig(page_size=16, num_pages=64, max_model_len=256,
                        max_batch_size=4, max_prefill_tokens=64,
                        prefill_buckets=(32, 64))
    for layers in sorted({1, args.layers}):
        jcfg = dataclasses.replace(ModelConfig.tiny(), dtype="float32",
                                   num_layers=layers)
        pcfg = dataclasses.replace(PortConfig.tiny(), dtype="float32",
                                   num_layers=layers)
        eng = Engine(jcfg, ecfg)
        eng.warmup(extended=False)
        for program, table in sorted(eng.roofline.items()):
            for key, row in sorted(table.items()):
                if program in ("prefill", "ragged"):
                    B, T, mp = (int(x) for x in key[1:].replace(
                        "xT", " ").replace("xmp", " ").split())
                else:
                    B, T, mp = ecfg.max_batch_size, 1, int(key[2:])
                port = cost.forward_cost_parts(pcfg, program, B, T, mp,
                                               ecfg.page_size,
                                               ecfg.decode_steps)
                print(json.dumps({
                    "layers": layers, "program": program, "key": key,
                    "xla_flops": row["flops"],
                    "port_gemm_flops": port["gemm_flops"],
                    "port_attn_flops": port["attn_flops"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
