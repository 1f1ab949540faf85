"""Chained MurmurHash3 block digests of the prefix cache.

A KV page of ``block_size`` tokens is keyed by a 128-bit chained hash:
``digest(block_i) = murmur3_x64_128(digest(block_{i-1}) || le32(tokens_i))``,
the scheme the reference master's cache index keys on, so the digests a
worker ships on its heartbeat name the blocks the master scores. A copy
of the JAX package's ``utils/hashing.py``: the pure-Python path, and the
repo-root native helper ``csrc/xllm_native.cpp``, built once on demand
with the system C++ compiler into ``build/torch_native/`` and loaded
through ctypes. Both paths give the same bytes; without a compiler (or
with ``XLLM_DISABLE_NATIVE=1``) the pure path serves.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Any, List, Optional, Sequence

from xllm_service_tpu_torch.utils.locks import make_lock

_MASK64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128_py(data: bytes, seed: int = 0) -> bytes:
    """Pure-Python MurmurHash3_x64_128: 16 bytes (h1 || h2, little
    endian). The seed is masked to 32 bits, as the native path takes
    it."""
    length = len(data)
    nblocks = length // 16
    seed &= 0xFFFFFFFF
    h1 = seed
    h2 = seed
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F

    for i in range(nblocks):
        k1, k2 = struct.unpack_from("<QQ", data, i * 16)
        k1 = (k1 * c1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & _MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCE729) & _MASK64
        k2 = (k2 * c2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & _MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64

    tail = data[nblocks * 16:]
    k1 = 0
    k2 = 0
    tl = len(tail)
    for i in range(min(tl, 16) - 1, 7, -1):
        k2 ^= tail[i] << ((i - 8) * 8)
    if tl > 8:
        k2 = (k2 * c2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & _MASK64
        h2 ^= k2
    for i in range(min(tl, 8) - 1, -1, -1):
        k1 ^= tail[i] << (i * 8)
    if tl > 0:
        k1 = (k1 * c1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & _MASK64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return struct.pack("<QQ", h1, h2)


# ---------------------------------------------------------------------------
# The native helper, built on demand from csrc/xllm_native.cpp.
# ---------------------------------------------------------------------------

_native_lock = make_lock("hashing.native", 95)
_native_lib: Optional[ctypes.CDLL] = None
_native_tried = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _build_native() -> Optional[str]:
    root = _repo_root()
    src = os.path.join(root, "csrc", "xllm_native.cpp")
    if not os.path.exists(src):
        return None
    out_dir = os.path.join(root, "build", "torch_native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libxllm_native.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    cxx = os.environ.get("CXX", "g++")
    # A process-unique name renamed into place: a concurrent process never
    # loads a half-written library.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        # No compiler, or it failed: the pure path serves.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return so


def _load_native() -> Optional[ctypes.CDLL]:
    global _native_lib, _native_tried
    with _native_lock:
        if _native_tried:
            return _native_lib
        _native_tried = True
        if os.environ.get("XLLM_DISABLE_NATIVE"):
            return None
        so = _build_native()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.xllm_murmur3_x64_128.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32,
                ctypes.c_void_p]
            lib.xllm_prefix_block_hashes.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_uint32, ctypes.c_void_p]
            lib.xllm_prefix_block_hashes.restype = ctypes.c_int32
            _native_lib = lib
        except OSError:
            _native_lib = None
        return _native_lib


def native_available() -> bool:
    return _load_native() is not None


def murmur3_x64_128(data: bytes, seed: int = 0) -> bytes:
    lib = _load_native()
    if lib is None:
        return murmur3_x64_128_py(data, seed)
    out = ctypes.create_string_buffer(16)
    lib.xllm_murmur3_x64_128(data, len(data), seed & 0xFFFFFFFF, out)
    return out.raw


def _as_i32(t: int) -> int:
    # Token ids hash as little-endian int32; out-of-range ids wrap the
    # same way on both paths.
    return ((t & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def prefix_block_hashes_py(tokens: Sequence[int], block_size: int,
                           seed: int = 0) -> List[bytes]:
    """``prefix_block_hashes`` on the pure-Python path."""
    out: List[bytes] = []
    prev = b""
    for b in range(len(tokens) // block_size):
        blk = tokens[b * block_size:(b + 1) * block_size]
        prev = murmur3_x64_128_py(
            prev + struct.pack(f"<{len(blk)}i", *[_as_i32(t) for t in blk]),
            seed)
        out.append(prev)
    return out


def prefix_block_hashes(tokens: Sequence[int], block_size: int,
                        seed: int = 0) -> List[bytes]:
    """Chained digests of every complete ``block_size`` block of
    ``tokens``; a trailing partial block has none (the cache tracks full
    pages only)."""
    n_blocks = len(tokens) // block_size
    if n_blocks == 0:
        return []
    lib = _load_native()
    if lib is None:
        return prefix_block_hashes_py(tokens, block_size, seed)
    n = n_blocks * block_size
    arr = (ctypes.c_int32 * n)(*[_as_i32(t) for t in tokens[:n]])
    buf = ctypes.create_string_buffer(16 * n_blocks)
    lib.xllm_prefix_block_hashes(arr, n, block_size, seed & 0xFFFFFFFF, buf)
    raw = buf.raw
    return [raw[i * 16:(i + 1) * 16] for i in range(n_blocks)]


def prompt_digest(tokens: Sequence[int], seed: int = 0) -> str:
    """Whole-prompt content digest (hex) for the master's poison ledger:
    unlike ``prefix_block_hashes`` it covers the trailing partial block
    too, so two prompts quarantine together iff they are token-identical.
    The same int32 packing as the block hashes."""
    data = struct.pack(f"<{len(tokens)}i", *[_as_i32(t) for t in tokens])
    return murmur3_x64_128(data, seed).hex()


def image_digest(spec: Any, seed: int = 0) -> str:
    """Content digest of one ``mm_inputs`` descriptor (hex, 128-bit
    murmur3 over the descriptor's bytes, not the decoded pixels): the key
    of the encode plane's embedding cache and of the master's cache-hit
    term, which both derive it from the same descriptor."""
    if isinstance(spec, dict) and spec.get("type") in ("image", "video"):
        spec = spec.get("data")
    if isinstance(spec, str):
        payload = spec.encode("utf-8")
    elif isinstance(spec, dict) and "pixels_b64" in spec:
        payload = (str(spec.get("shape")).encode("ascii") + b"|"
                   + spec["pixels_b64"].encode("ascii"))
    else:
        payload = repr(spec).encode("utf-8", "replace")
    return murmur3_x64_128_py(payload, seed).hex()
