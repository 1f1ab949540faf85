"""The ranks of a sharded worker: one process per rank, rank 0 leading.

A worker whose mesh (``parallel/mesh.py``) has n > 1 ranks is n
processes. Rank 0 is the worker: it owns the scheduler, the page
allocator, the prefix cache and the HTTP plane, and its engine runs
every step. Ranks 1 .. n-1 are followers: each holds its shard of the
weights and its share of the KV pools in an engine of its own, and runs
``follow``: it receives every call rank 0's engine makes on its step
runners (``Mirror``), the staging of a step's int tensors (tokens,
positions, page tables, sampling tensors and seeds, the logit bias) and
the launch, as one small pickled header broadcast over the world, and
makes the same call on its own runners. Every rank thus runs the same
forward on the same inputs, so every collective inside it meets its
peers; every rank samples from the same gathered logits with the same
generator state, and rank 0 reads the tokens.

Why processes and not a single controller: JAX's GSPMD compiles one
program for the whole mesh and drives every device from one process.
PyTorch has no such compiler for a hand-written forward; its
collectives are calls each participant makes (``torch.distributed``),
so each rank must run the forward itself. One process per rank also
keeps each rank's CUDA context, allocator and kernel launches apart,
which is how NCCL expects its ranks, and the one-card machine runs two
such processes over gloo.

Ranks start in one of two ways: a worker given ``--dist-coordinator``,
``--dist-num-processes`` and ``--dist-process-id`` joins a world the
caller started (process id > 0 runs ``run_follower``), or a worker
whose mesh has several ranks and no ``--dist-*`` starts its followers
itself (``start_followers``: ``python -m
xllm_service_tpu_torch.runtime.ranks <launch file> <rank>``, each on a
device of ``plan_devices``), and stops them when it stops.

A step that fails on any rank leaves the world out of step: rank 0 may
have broadcast the launch and raised before the collective its
followers wait in, or a follower may have raised and left. So a sharded
worker does not contain a step fault as a single-rank one does (no
reset, no bisection probes, which would start collectives the
followers' pending ones would pair with): it fails every request,
stops its engine loop and tears the world down (``abort``). Rank 0
polls the followers it started and treats one that exited as such a
fault; between steps it broadcasts a keep-alive every
``mesh.KEEPALIVE_S``, so that every collective can wait a bounded time
(``mesh.TIMEOUT``) for a peer.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.parallel.mesh import (KEEPALIVE_S, Mesh, MeshSpec,
                                                  default_backend, free_port,
                                                  make_mesh)

logger = logging.getLogger(__name__)

# The directory holding this package (its checkout's root).
_ROOT = str(Path(__file__).resolve().parents[2])

# The runner calls that change a runner's device state or run a step,
# by runner: what a follower repeats. Reads of host-side state
# (``active_table_matches``, ``programs``) stay on rank 0.
MIRRORED: Dict[str, Tuple[str, ...]] = {
    "decode": ("stage_active_table", "stage_sampling", "stage_bias",
               "stage_rope_delta", "invalidate_staged", "stage_counts",
               "stage_carries", "prepare", "launch"),
    "prefill": ("stage", "stage_mm", "prepare", "launch"),
    "control": ("reset", "report", "all_reduce_ms", "forward_logits",
                "ring_logits"),
}


class Mirror:
    """Rank 0's stand-in for one of its engine's runners: a call of a
    ``MIRRORED`` method is broadcast to the followers, then made here;
    anything else is the runner's own."""

    def __init__(self, runner, name: str, mesh: Mesh) -> None:
        object.__setattr__(self, "_runner", runner)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_mesh", mesh)

    def __getattr__(self, attr: str):
        value = getattr(self._runner, attr)
        if attr not in MIRRORED[self._name]:
            return value

        def call(*args, **kwargs):
            self._mesh.broadcast_object((self._name, attr, args, kwargs))
            return value(*args, **kwargs)
        return call

    def __setattr__(self, attr: str, value) -> None:
        setattr(self._runner, attr, value)


class Control:
    """Calls every rank makes at once outside the engine's steps (rank 0
    through ``control``): the counters of a measured window, and
    forwards of the rank's shard on a scratch pool, whose logits rank 0
    compares with an unsharded forward."""

    def __init__(self, engine, mesh: Mesh) -> None:
        self.engine, self.mesh = engine, mesh

    def reset(self) -> None:
        """Zero the kernel launch counts, the collectives' counts and
        seconds, and the prefill attention's branch counts."""
        from xllm_service_tpu_torch.ops import attention, kernels
        kernels.reset_launch_counts()
        self.mesh.counts.clear()
        self.mesh.staged_s.clear()
        for k in attention.PREFILL_BRANCH_CALLS:
            attention.PREFILL_BRANCH_CALLS[k] = 0

    def report(self) -> Optional[List[Dict[str, Any]]]:
        """Every rank's counters (``reset`` zeroed them), in rank order,
        gathered over the world to rank 0; None on the others."""
        from xllm_service_tpu_torch.ops import attention, kernels
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        return self.mesh.gather_object({
            "rank": self.mesh.rank, "launches": kernels.launch_counts(),
            "collectives": dict(self.mesh.counts),
            "staged_s": dict(self.mesh.staged_s),
            "prefill_branch": dict(attention.PREFILL_BRANCH_CALLS)})

    def all_reduce_ms(self, shapes: List[Tuple[int, ...]],
                      iters: int = 20) -> Dict[str, float]:
        """Host ms of one tp all-reduce of a bf16 tensor of each shape
        on the engine's device (staged through the host under gloo),
        the median of ``iters`` after one warm-up, the device idle
        before each. Leaves the collectives' counters as they were."""
        dev = self.engine.device
        saved = self.mesh.snapshot()
        out = {}
        for shape in shapes:
            x = torch.ones(shape, dtype=torch.bfloat16, device=dev)
            times = []
            for i in range(iters + 1):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                self.mesh.all_reduce(x, "tp")
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            out["x".join(map(str, shape))] = sorted(times)[len(times) // 2]
        self.mesh.counts.clear()
        self.mesh.counts.update(saved[0])
        self.mesh.staged_s.clear()
        self.mesh.staged_s.update(saved[1])
        return out

    def _scratch(self, n: int, page_size: int):
        from xllm_service_tpu_torch.models import transformer
        e = self.engine
        pages = -(-n // page_size)
        kv = transformer.init_kv_cache(e.shard_cfg, pages + 1, page_size,
                                       e.device)
        table = torch.arange(1, pages + 1, dtype=torch.int32,
                             device=e.device)[None]
        return kv, table

    def forward_logits(self, ids: List[int], next_id: int,
                       page_size: int = 128):
        """The logits after ``ids`` (one prefill of the whole sequence)
        and after ``next_id`` at position len(ids) (one decode), through
        this rank's shard in the engine's write order: [V] float32 numpy
        each."""
        from xllm_service_tpu_torch.models import transformer
        e, dev = self.engine, self.engine.device
        T = len(ids)
        kv, table = self._scratch(T + 1, page_size)
        i32 = dict(dtype=torch.int32, device=dev)
        logits, kv = transformer.forward_prefill(
            e.params, e.shard_cfg, torch.tensor([ids], device=dev),
            torch.zeros(1, **i32), torch.tensor([T], **i32), kv, table,
            write_then_attend=e.write_then_attend, mesh=self.mesh)
        dec, _ = transformer.forward_decode(
            e.params, e.shard_cfg, torch.tensor([next_id], device=dev),
            torch.tensor([T], **i32),
            torch.ones(1, dtype=torch.bool, device=dev), kv, table,
            write_then_attend=e.write_then_attend, mesh=self.mesh)
        return logits[0].float().cpu().numpy(), dec[0].float().cpu().numpy()

    def ring_logits(self, ids: List[int], T: int, page_size: int = 128):
        """The logits after ``ids`` from one ring prefill of the sequence
        padded to ``T`` positions: [V] float32 numpy."""
        from xllm_service_tpu_torch.models import transformer
        e, dev = self.engine, self.engine.device
        kv, table = self._scratch(T + 1, page_size)
        tokens = torch.zeros((1, T), dtype=torch.long, device=dev)
        tokens[0, :len(ids)] = torch.tensor(ids, device=dev)
        logits, _ = transformer.forward_prefill_ring(
            e.params, e.shard_cfg, tokens,
            torch.tensor([len(ids)], dtype=torch.int32, device=dev), kv,
            table, self.mesh)
        return logits[0].float().cpu().numpy()


def control(engine, attr: str, *args, **kwargs):
    """Rank 0: make ``Control.<attr>`` on every rank of ``engine``'s mesh;
    returns rank 0's result."""
    engine.mesh.broadcast_object(("control", attr, args, kwargs))
    return getattr(Control(engine, engine.mesh), attr)(*args, **kwargs)


def stop_followers(mesh: Mesh) -> None:
    """Release the followers from ``follow`` (rank 0)."""
    if mesh.world > 1 and mesh.rank == 0:
        mesh.broadcast_object(None)


_KEEPALIVE = "keepalive"


def keepalive_due(mesh: Mesh) -> bool:
    """Rank 0: the world has broadcast nothing for ``KEEPALIVE_S``."""
    return mesh.world > 1 and mesh.rank == 0 and \
        time.monotonic() - mesh.last_broadcast >= KEEPALIVE_S


def keepalive(mesh: Mesh) -> None:
    """Rank 0, between steps: broadcast a keep-alive when one is due
    (a follower's wait stays under the collectives' timeout)."""
    if keepalive_due(mesh):
        mesh.broadcast_object(_KEEPALIVE, tally=False)


def lost_follower(procs: List[subprocess.Popen], wait_s: float = 0.0
                  ) -> str:
    """Rank 0: '' while every follower it started runs, else which one
    exited and how. ``wait_s``: how long to watch for an exit (after a
    collective failed, the peer's exit may not be reaped yet)."""
    deadline = time.monotonic() + wait_s
    while True:
        for rank, p in enumerate(procs, 1):
            code = p.poll()
            if code is not None:
                return f"rank {rank} exited with code {code}"
        if not procs or time.monotonic() >= deadline:
            return ""
        time.sleep(0.02)


def abort(mesh: Mesh, procs: List[subprocess.Popen]) -> None:
    """Rank 0, after a step failed: end the followers it started and
    leave the world without a stop broadcast (a follower may be waiting
    in a collective of the failed step). Followers of a world the
    caller started see the world go (gloo) or time out (nccl)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    stop_processes(procs)
    mesh.close()


def follow(engine, mesh: Mesh) -> int:
    """A follower's loop: make each call rank 0 broadcasts on this
    engine's runners, until rank 0 stops it. Returns the calls made.
    A call that raises ends the loop with that error (the world is out
    of step; rank 0 tears it down)."""
    runners = {"decode": engine.graphs, "prefill": engine.prefill_graphs,
               "control": Control(engine, mesh)}
    n = 0
    while True:
        msg = mesh.broadcast_object()
        if msg is None:
            return n
        if msg == _KEEPALIVE:
            continue
        name, attr, args, kwargs = msg
        getattr(runners[name], attr)(*args, **kwargs)
        n += 1


@dataclasses.dataclass
class Launch:
    """What a follower needs to build its engine: the model and engine
    configs, the mesh, each rank's device, the backend and the
    rendezvous, and where the full weights come from (``params`` given
    on the CPU, a ``model_dir`` checkpoint, else random from the
    engine's default seed on the rank's device, as rank 0's engine
    makes them)."""
    model_cfg: ModelConfig
    engine_cfg: EngineConfig
    spec: MeshSpec
    devices: List[str]
    backend: str
    init_method: str
    model_dir: str = ""
    params: Optional[Dict[str, Any]] = None
    murmur_seed: int = 0


def plan_devices(world: int, device, backend: str,
                 device_count: Optional[int] = None) -> List[str]:
    """Each rank's device when one worker starts every rank: on CUDA,
    the cards from the given one on, round robin over the visible
    cards; on the CPU, the CPU. NCCL with fewer cards than ranks (two
    ranks on one card) raises before any rank starts."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use "
                             "--dist-backend gloo on the CPU")
        return ["cpu"] * world
    n = torch.cuda.device_count() if device_count is None else device_count
    if n < 1:
        raise RuntimeError("no CUDA device is visible")
    if backend == "nccl" and world > n:
        raise ValueError(
            f"{world} ranks on {n} card(s) would put two ranks on one "
            f"card, which NCCL refuses; use --dist-backend gloo")
    base = dev.index or 0
    return [f"cuda:{(base + r) % n}" for r in range(world)]


def start_followers(launch: Launch) -> Tuple[List[subprocess.Popen], str]:
    """Start ranks 1 .. n-1 as child processes of this one (which is
    rank 0; they write to its stderr). Returns the processes and the
    launch file (remove it after the mesh is made)."""
    fd, path = tempfile.mkstemp(prefix="xllm_ranks_", suffix=".pt")
    os.close(fd)
    torch.save({f.name: getattr(launch, f.name)
                for f in dataclasses.fields(launch)}, path)
    # The children import this checkout's package, wherever they start.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xllm_service_tpu_torch.runtime.ranks",
         path, str(rank), str(os.getpid())],
        stdout=subprocess.DEVNULL, env=env)
        for rank in range(1, launch.spec.num_devices)]
    return procs, path


def stop_processes(procs: List[subprocess.Popen],
                   timeout: float = 30.0) -> None:
    """Wait for the followers to leave, then end any that did not."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def start_mesh(spec: MeshSpec, model_cfg: ModelConfig,
               engine_cfg: EngineConfig, device, backend: str = "",
               params: Optional[Dict[str, Any]] = None, model_dir: str = "",
               murmur_seed: int = 0) -> Tuple[Mesh, List[subprocess.Popen]]:
    """Rank 0's side of a worker that starts its own ranks: plan the
    devices (``plan_devices``), start the followers with the same model,
    engine config and weights (``params`` are copied to them on the
    CPU), and join them in a mesh over a localhost rendezvous. Returns
    this rank's mesh and the followers' processes."""
    backend = backend or default_backend(device)
    devices = plan_devices(spec.num_devices, device, backend)
    launch = Launch(model_cfg, engine_cfg, spec, devices, backend,
                    f"tcp://127.0.0.1:{free_port()}", model_dir=model_dir,
                    params=None if params is None else _to(params, "cpu"),
                    murmur_seed=murmur_seed)
    procs, path = start_followers(launch)
    try:
        mesh = make_mesh(spec, 0, devices[0], backend, launch.init_method)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        os.remove(path)
    return mesh, procs


def _full_params(launch: Launch, device):
    if launch.params is not None:
        return {k: _to(v, device) for k, v in launch.params.items()}
    if launch.model_dir:
        from xllm_service_tpu_torch.runtime import checkpoint
        if checkpoint.has_text_weights(launch.model_dir):
            return checkpoint.load_checkpoint(launch.model_dir,
                                              launch.model_cfg, device)
    return None


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def run_follower(launch: Launch, rank: int) -> int:
    """Build rank ``rank``'s engine (its shard of the full weights) and
    follow rank 0 until it stops. Returns the calls made."""
    from xllm_service_tpu_torch.runtime.engine import Engine
    device = launch.devices[rank]
    mesh = make_mesh(launch.spec, rank, device, launch.backend,
                     launch.init_method)
    try:
        # The engine resolves its switches (the write order, ragged) from
        # the config and the environment, which a follower inherits.
        engine = Engine(launch.model_cfg, launch.engine_cfg,
                        params=_full_params(launch, device), device=device,
                        murmur_seed=launch.murmur_seed,
                        mesh=mesh)
        return follow(engine, mesh)
    finally:
        mesh.close()


def _watch_parent(pid: int) -> None:
    """End this follower when the worker that started it is gone (its
    collectives would wait for it forever)."""
    def loop():
        while True:
            time.sleep(1.0)
            if os.getppid() != pid:
                os._exit(0)
    threading.Thread(target=loop, daemon=True,
                     name="xllm-rank-parent-watch").start()


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, rank = argv[0], int(argv[1])
    if len(argv) > 2:
        _watch_parent(int(argv[2]))
    logging.basicConfig(level=logging.INFO)
    d = torch.load(path, weights_only=False)
    launch = Launch(**d)
    calls = run_follower(launch, rank)
    logger.info("rank %d: followed %d runner calls", rank, calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
