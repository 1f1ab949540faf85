"""Builds the CUDA kernels of this package with ``nvcc`` at first use.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --split-compile=0
         -o build/torch_kernels/<name>-<hash>.so <name>.cu

The output lands in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the sources (headers included) and the flags, so a
changed source rebuilds and an unchanged one is loaded as it is. All
missing libraries compile in parallel, one ``nvcc`` per source, and
each ``nvcc`` optimizes its kernels on parallel threads
(``--split-compile=0``: the attention sources instantiate tens of
kernels each, over head dims, group widths and both KV write orders, and
compile in about half the time that way). Nothing
here runs at import: the CPU tests import every module of the package,
and a CPU has no ``nvcc``.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

from xllm_service_tpu_torch.utils.locks import make_lock

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
              "-Xptxas=-v")

_lock = make_lock("kernels.build", 97)
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler messages of the last build (register and shared-memory use
# per kernel from ``-Xptxas=-v``), by source name.
build_logs: Dict[str, str] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of this package build only "
            "where the CUDA toolkit is installed")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel;
    returns {source name: library path}. Raises with the compiler's
    output if one fails."""
    paths = {src.stem: _lib_path(src) for src in sources()}
    todo = [src for src in sources() if not paths[src.stem].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = paths[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            continue
        os.replace(tmp, paths[src.stem])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib
