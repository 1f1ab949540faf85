#!/usr/bin/env python3
"""The ragged kernel (K5) in two grid designs on one GPU, in turns.

    python3 tools/k5_grid_ab.py

- ``persistent``: ``csrc/ragged_paged_attention.cu`` as the port builds
  it (a fixed grid of persistent blocks walking a work list each block
  builds from the row lengths);
- ``static``: ``tools/k5_static_grid.cu`` (the same items, no work list:
  Hkv x B x (nqt + SP) blocks, each taking one item by its row's
  length), as built for two blocks per SM at D = 64;
- ``static_one_block_per_sm``: the same source at one block per SM
  (``-DK5_MIN_BLOCKS=1``: 255 registers a thread).

Each is checked against the plain version (valid rows within 2e-2,
padding rows zero) and timed (CUDA graph replay, ``chip_smoke.graph_ms``)
at ``chip_smoke.py`` phase 3's serving mix (7 decode rows of 117-411
keys beside a 256-token window, B = 8 x T = 256, llama3-1b's heads), its
decode rows alone, its window alone, and 8 decode rows of 2048-4096 keys
beside a 256-token window, in two rounds. Prints one JSON line per round
and design, then the card's name and power limit. Builds into
``build/k5_grid_ab/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import random
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xllm_service_tpu_torch.config import ModelConfig  # noqa: E402
from xllm_service_tpu_torch.ops.kernels import _build  # noqa: E402
from xllm_service_tpu_torch.ops.kernels import ragged_attention as ra  # noqa: E402
from xllm_service_tpu_torch.ops.kernels._launch import F, I, P  # noqa: E402

STATIC = {"static": [], "static_one_block_per_sm": ["-DK5_MIN_BLOCKS=1"]}


def build_static():
    """The static design's libraries, one nvcc each, in parallel."""
    out = ROOT / "build" / "k5_grid_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{_build.CSRC}",
         "-o", str(out / f"{name}.so"), str(ROOT / "tools" /
                                           "k5_static_grid.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in STATIC.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.ragged_paged_attention.argtypes = [P] * 11 + [I] * 10 + [F, F, P]
        lib.ragged_paged_attention.restype = I
        libs[name] = lib
    return libs


@contextlib.contextmanager
def kernel_of(lib):
    """The wrapper launching ``lib``'s kernel (None: the port's own)."""
    own = ra._kernel()
    ra._lib = lib or own
    try:
        yield
    finally:
        ra._lib = own


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    designs = {"persistent": None, **build_static()}
    bench = cs.KernelBench(torch, ModelConfig.llama3_1b(), "cuda")
    dev, Hq, D = "cuda", bench.Hq, bench.D
    starts = [c - 1 for c in (117, 205, 298, 411, 150, 260, 333)] + [128]
    mix = [1] * 7 + [256]
    rng = random.Random(8)
    long_starts = [rng.randrange(2048, 4097) - 1 for _ in range(8)] + [512]
    perm = torch.randperm(bench.P - 1, generator=bench.g,
                          device=dev)[:9 * 32] + 1
    cases = {  # name: (q, page table, q_start, lengths)
        "mix": (256, bench.pt8, starts, mix),
        "decode_rows_only": (256, bench.pt8, starts, mix[:7] + [0]),
        "window_only": (256, bench.pt8, starts, [0] * 7 + [256]),
        "long": (256, perm.reshape(9, 32).to(torch.int32).contiguous(),
                 long_starts, [1] * 8 + [256]),
    }
    args = {}
    for name, (T, pt, st, lens) in cases.items():
        q = bench.randn(len(lens), T, Hq, D)
        args[name] = (q, bench.kp, bench.vp, pt, bench.i32(st),
                      bench.i32(lens), bench.layer)
    for design, lib in designs.items():
        with kernel_of(lib):
            for name, a in args.items():
                valid = (torch.arange(a[0].shape[1], device=dev)[None, :]
                         < a[5].long()[:, None])
                bench.close(f"{design} {name}",
                            ra.ragged_paged_attention(*a),
                            ra.ragged_paged_attention_plain(*a), valid)
    for rnd in range(2):
        for design, lib in designs.items():
            with kernel_of(lib):
                ms = {name: cs.graph_ms(
                    lambda a=a: ra.ragged_paged_attention(*a))
                    for name, a in args.items()}
            print(json.dumps({"round": rnd, "design": design, **ms}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
