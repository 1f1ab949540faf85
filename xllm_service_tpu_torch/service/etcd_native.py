"""Launcher for the native coordination server (``csrc/xllm_etcd.cpp``).

A copy of the JAX package's ``service/etcd_native.py``: the same
behaviour and names, importing only this package (and no device code).

The reference FATALs without a reachable etcd cluster
(scheduler/etcd_client/etcd_client.cpp:24-33); this rebuild ships its own
etcd-v3-JSON-gateway-compatible server binary instead, so (a) deployments
get a coordination plane without an external etcd install, and (b) the
``EtcdStore`` contract suite always runs against a *genuinely separate
implementation* over real sockets — an independently-written C++ server,
not the Python mock that shares its author's assumptions.
``XLLM_ETCD_ADDR`` still points the same tests at a
stock etcd when one is available.

Build is on-demand (g++, same pattern as the native httpd/hash modules)
into ``build/native/xllm_etcd``; the server prints ``LISTENING <port>``
once bound, so port 0 (ephemeral) works for parallel test runs.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

from xllm_service_tpu_torch.utils.locks import make_lock

_build_lock = make_lock("etcd_native.build", 97)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def build_binary() -> Optional[str]:
    """Compile (if stale) and return the server binary path, or None when
    the toolchain/source is unavailable."""
    root = _repo_root()
    src = os.path.join(root, "csrc", "xllm_etcd.cpp")
    if not os.path.exists(src):
        return None
    out_dir = os.path.join(root, "build", "native")
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "xllm_etcd")
    with _build_lock:
        if os.path.exists(binary) \
                and os.path.getmtime(binary) >= os.path.getmtime(src):
            return binary
        cxx = os.environ.get("CXX", "g++")
        tmp = f"{binary}.{os.getpid()}.tmp"
        cmd = [cxx, "-O2", "-std=c++17", "-pthread", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=180)
            os.replace(tmp, binary)
        except Exception:  # noqa: BLE001 — no toolchain / compile
            # failure: None falls back to the in-process store, which
            # the caller reports
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    return binary


class NativeEtcdServer:
    """One xllm_etcd OS process on an ephemeral loopback port."""

    def __init__(self, port: int = 0) -> None:
        self._port = port
        self._proc: Optional[subprocess.Popen] = None
        self.address: str = ""

    def start(self) -> "NativeEtcdServer":
        binary = build_binary()
        if binary is None:
            raise RuntimeError("xllm_etcd binary unavailable (no g++?)")
        self._proc = subprocess.Popen(
            [binary, str(self._port)], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        line = self._proc.stdout.readline().decode("ascii", "replace")
        if not line.startswith("LISTENING "):
            self.stop()
            raise RuntimeError(f"xllm_etcd failed to bind: {line!r}")
        self.address = f"127.0.0.1:{int(line.split()[1])}"
        return self

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait(timeout=10)
            self._proc = None
