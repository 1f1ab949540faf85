"""Run some of ``chip_smoke.py``'s phases alone on one NVIDIA GPU.

    python3 tools/chip_phases.py 3,16,14,15 [--root <checkout>] [--out <dir>]

``--root`` runs the phases of another checkout's ``chip_smoke.py`` and
package (a tree unpacked from ``git archive`` into a directory that
.gitignore lists, e.g. the parent commit's, for a comparison in one
call: A, B, B, A); its kernels are built in that checkout.

The kernels are built first (phase 2); then, in this order, the phases
named:

- ``3``: the Gemma rows of phase 3 alone (``*_gemma3``: the fused rope
  writers, K3, K3', K4, K4' and K5 at Gemma-3-12B's shapes with its
  1024-token window; ``*_gemma2``: K3 and K4 with Gemma-2-9B's soft-cap);
- ``16``: ``gemma_phase``;
- ``14``: ``epd_phase`` (its margins limit 0.5, as phase 4 is not run);
- ``15``: ``obs_phase``;
- ``6``: ``cluster_phase``;
- ``6b``: ``routed_cluster_phase``, on the weights of a worker built as
  phase 7's first (phase 7 itself is not run);
- ``10``: ``pd_phase``, ``11``: ``fetch_phase``, ``12``:
  ``lifecycle_phase`` (their margins limit 0.5, as phase 4 is not run);
- ``17``: ``parallel_phase`` (tp = 2, sp = 2 and ep = 2 on the card over
  gloo; margins limit 0.5) with the ``*_tp2`` K3/K4 records
  (``parallel_kernel_rows``).

Each phase's checks hold as in ``chip_smoke.py``. The seconds of each
phase, the card and every result go to
``<dir>/chip_phases_<phases>[_<checkout>].json`` (``--out``, default
``build/chip_phases`` of this checkout); the last line printed is the
card and the seconds. The script needs the card (it fails without one).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if "--root" in sys.argv:
    ROOT = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xllm_service_tpu_torch.ops import kernels  # noqa: E402
from xllm_service_tpu_torch.ops.kernels import _build  # noqa: E402


def routed(card: str) -> dict:
    """Phase 6b on the weights of phase 7's first worker (built, then
    stopped)."""
    from xllm_service_tpu_torch.runtime import worker
    w, _ = cs._start(worker, cs.PREFIX_ARGS,
                     {"XLLM_RAGGED_ATTN": "0", "XLLM_WRITE_THEN_ATTEND": "1",
                      "XLLM_CUDA_GRAPHS": "1"})
    params = w.engine.params
    w.stop()
    del w
    cs.free_device_memory(torch)
    return cs.routed_cluster_phase(torch, kernels, card, params)


def main() -> int:
    if not torch.cuda.is_available():
        cs.log("chip_phases: no CUDA device is available")
        return 2
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else ["16"]
    t_start = time.perf_counter()
    marks, out = {}, {}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"[device] {card}")
    t0 = time.perf_counter()
    _build.build_all()
    marks["build"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {"3": lambda: {"records": cs.gemma_kernel_rows(torch)},
            "16": lambda: {"gemma": cs.gemma_phase(torch, kernels, card)},
            "14": lambda: {"epd": cs.epd_phase(torch, kernels, card, 0.5)},
            "15": lambda: {"obs": cs.obs_phase(torch, kernels, card)},
            "6": lambda: {"cluster": cs.cluster_phase(torch, kernels, card)},
            "6b": lambda: {"cluster_cache_aware": routed(card)},
            "10": lambda: {"pd": cs.pd_phase(torch, kernels, card, 0.5)},
            "11": lambda: {"fetch": cs.fetch_phase(torch, kernels, card,
                                                   0.5)},
            "12": lambda: {"lifecycle": cs.lifecycle_phase(
                torch, kernels, card, 0.5)},
            "17": lambda: {"tp2_records": cs.parallel_kernel_rows(torch),
                           "parallel": cs.parallel_phase(
                               torch, kernels, card, 0.5, 0.5)}}
    for phase in phases:
        t0 = time.perf_counter()
        out.update(runs[phase]())
        marks[phase] = time.perf_counter() - t0
        cs.free_device_memory(torch)
    if "epd" in out:
        out["epd"].pop("records", None)
    cs.guard_no_jax_modules()
    marks["total"] = time.perf_counter() - t_start
    here = Path(__file__).resolve().parents[1] / "build" / "chip_phases"
    if "--out" in sys.argv:
        here = Path(sys.argv[sys.argv.index("--out") + 1]).resolve()
    here.mkdir(parents=True, exist_ok=True)
    tag = "_".join(phases) + ("_" + ROOT.name if "--root" in sys.argv
                              else "")
    with open(here / f"chip_phases_{tag}.json", "w", encoding="utf-8") as f:
        json.dump({"card": card, "root": str(ROOT), "marks": marks, **out},
                  f, default=str)
    print(json.dumps({"card": card, "root": str(ROOT), "marks": marks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
