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

A follower keeps a model book (``Life``): one engine per model name,
awake or asleep, and every broadcast call names the model whose
runners it is for. ``life`` drives the book beside rank 0's own
runtimes: ``fork`` stages a model asleep on every rank, ``sleep`` parks
each rank's shard in host memory (pinned on a GPU) and drops its
engine, ``wake`` rebuilds it from the parked shard (warm) or slices the
full weights on each rank (cold), and ``report`` gathers what every
rank holds. A follower whose every model sleeps holds nothing on the
device and keeps answering the keep-alives.

Rank 0 also moves KV between the pools of every rank and the full-head
blocks its engine hands out and takes in (the PD handoff, the block
fetch, the host spill tier): ``KvPlane``, a mirrored runner too.
``gather(pages)`` has each rank holding a head group
(``sharding.kv_sources``) send its heads of those pages to rank 0,
which joins them (``sharding.unshard_kv_cache``); ``scatter(pages, k,
v)`` sends every rank, replicas included, its slice of a full-head
block for the pages rank 0 allocated, which each writes into its own
pools. An unsharded engine's ``KvPlane`` does the same on its own
pools.

The step fault boundary holds under a mesh. After every launched
forward (and every KV move, control and lifecycle call) the ranks
agree on its status (``Mesh.agree``). A fault raised on rank 0 before a
section's launch (the step failpoints, a host error) leaves the world in step,
and the worker contains it as with one rank. A fault between a launch
and its agreement (rank 0 raising inside a sharded forward, a follower
raising) leaves it out of step: the rank that raised leaves its
process groups, which makes its peers' pending collectives fail at
once, and every rank re-forms the world under the next epoch
(``Mesh.reform``), keeping its engine, weights and pools; rank 0's
engine re-forms before the fault reaches the worker, which then
contains it (``Engine._rejoin``). A follower whose call without an
agreement raised (a staging call) re-forms at the next agreed call
instead of running it, so that rank 0 learns of it there. A follower
that exits is a lost rank: rank 0 polls the followers it started and
ends the worker (``abort``); between steps it broadcasts a keep-alive
every ``mesh.KEEPALIVE_S``, so that every collective can wait a bounded
time (``mesh.TIMEOUT``) for a peer.
"""

from __future__ import annotations

import dataclasses
import gc
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
from xllm_service_tpu_torch.parallel import sharding
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
               "stage_carries", "save_generator", "restore_generator",
               "prepare", "launch"),
    "prefill": ("stage", "stage_mm", "prepare", "launch"),
    "control": ("reset", "report", "all_reduce_ms", "forward_logits",
                "ring_logits", "kv_pages", "embed", "decode_state"),
    "kv": ("gather", "scatter"),
    "life": ("fork", "sleep", "wake", "report"),
}
# The calls that run collectives or change what a rank holds, after
# which every rank reports its status (``Mesh.agree``).
AGREED: Dict[str, Tuple[str, ...]] = {
    "decode": ("launch",), "prefill": ("launch",),
    "control": MIRRORED["control"], "kv": MIRRORED["kv"],
    "life": MIRRORED["life"],
}


def _lead(mesh: Mesh, model: str, name: str, attr: str, fn, args, kwargs,
          header=None):
    """Rank 0: broadcast the call on ``model``'s runner ``name``
    (``header``: the arguments the followers get, default all), make it
    here, and for an ``AGREED`` call wait for every rank's status.
    ``mesh.synced`` is False from the broadcast until the call is known
    to have gone through on every rank."""
    hargs, hkwargs = (args, kwargs) if header is None else header
    mesh.synced = False
    mesh.broadcast_object((model, name, attr, hargs, hkwargs))
    if attr not in AGREED[name]:
        mesh.synced = True
        return fn(*args, **kwargs)
    out = fn(*args, **kwargs)
    if not mesh.agree(True):
        raise RuntimeError(f"{name}.{attr} failed on another rank")
    mesh.synced = True
    return out


class Mirror:
    """Rank 0's stand-in for one of its engine's runners: a call of a
    ``MIRRORED`` method is broadcast to the followers, naming the
    engine's model, then made here; anything else is the runner's own.
    A runner with a ``header`` method chooses what of a call's arguments
    the followers get."""

    def __init__(self, runner, name: str, mesh: Mesh,
                 model: str = "") -> None:
        object.__setattr__(self, "_runner", runner)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_model", model)

    def __getattr__(self, attr: str):
        value = getattr(self._runner, attr)
        if attr not in MIRRORED[self._name]:
            return value
        header = getattr(self._runner, "header", None)

        def call(*args, **kwargs):
            return _lead(self._mesh, self._model, self._name, attr, value,
                         args, kwargs,
                         header=None if header is None
                         else header(attr, args, kwargs))
        return call

    def __setattr__(self, attr: str, value) -> None:
        setattr(self._runner, attr, value)


class KvPlane:
    """Page sets of the KV pools in and out as full-head blocks [L, n,
    page_size, Hkv, D] (module docstring): the pools of every rank under
    a mesh, the engine's own without one. Rank 0 calls it through a
    ``Mirror``; the followers make the same call with the page ids."""

    def __init__(self, engine, mesh: Optional[Mesh]) -> None:
        self.engine, self.mesh = engine, mesh

    @staticmethod
    def header(attr: str, args, kwargs):
        """The followers get the page ids alone (the blocks travel in
        the scatter, the placement of the result is rank 0's)."""
        return (args[0],), {}

    def _index(self, pages) -> torch.Tensor:
        return torch.tensor(list(pages), dtype=torch.long,
                            device=self.engine.kv[0].device)

    def gather(self, pages, device: bool = False):
        """Rank 0: (k, v) of ``pages`` with every KV head, fresh tensors
        on the engine's device with ``device=True``, else on the CPU.
        None on the followers (a source sends its heads)."""
        pools, mesh = self.engine.kv, self.mesh
        idx = self._index(pages)
        if mesh is None:
            k, v = (p.index_select(1, idx) for p in pools)
            return (k, v) if device else (k.cpu(), v.cpu())
        mine = torch.stack([p.index_select(1, idx) for p in pools])
        parts = mesh.gather(mine, sharding.kv_sources(self.engine.cfg,
                                                      mesh.spec),
                            device=pools[0].device if device else "cpu")
        if parts is None:
            return None
        full = sharding.unshard_kv_cache(parts, self.engine.cfg, dim=4)
        return full[0], full[1]

    def scatter(self, pages, k=None, v=None) -> None:
        """Write a full-head block (k, v: tensors on any device, or numpy
        arrays, given on rank 0) into ``pages`` of every rank's pools,
        each rank its own heads, in place."""
        pools, mesh = self.engine.kv, self.mesh
        idx = self._index(pages)
        if mesh is None:
            for pool, block in zip(pools, (k, v)):
                pool.index_copy_(1, idx, torch.as_tensor(block).to(
                    device=pool.device, dtype=pool.dtype))
            return
        parts = None
        if mesh.rank == 0:
            full = torch.stack([torch.as_tensor(k), torch.as_tensor(v)])
            cfg, tp = self.engine.cfg, mesh.spec.tp
            parts = {r: sharding.kv_share(full, cfg, tp,
                                          mesh.spec.coords(r)["tp"], dim=4)
                     for r in range(mesh.world)}
        shape = (2, pools[0].shape[0], len(idx), *pools[0].shape[2:])
        mine = mesh.scatter(parts, shape, pools[0].dtype, pools[0].device)
        for pool, block in zip(pools, mine):
            pool.index_copy_(1, idx, block)


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

    def kv_pages(self, pages: List[int]) -> Optional[List[Tuple]]:
        """Every rank's (k, v) share of ``pages`` of its pools, on the
        CPU, in rank order, gathered over the world to rank 0 as pickled
        objects (not through ``KvPlane``: what its gather is checked
        against); None on the others."""
        idx = torch.tensor(list(pages), dtype=torch.long,
                           device=self.engine.kv[0].device)
        return self.mesh.gather_object(tuple(
            p.index_select(1, idx).cpu() for p in self.engine.kv))

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

    def embed(self, tokens, lengths) -> "np.ndarray":
        """``/v1/embeddings``' forward (``forward_embedding``) of
        ``tokens`` [B, T] (``lengths`` [B]) through this rank's shard:
        the [B, D] float32 embeddings, numpy (replicated over tp)."""
        from xllm_service_tpu_torch.models import transformer
        e, dev = self.engine, self.engine.device
        with torch.inference_mode():
            out = transformer.forward_embedding(
                e.params, e.shard_cfg, torch.as_tensor(tokens).to(dev),
                torch.as_tensor(lengths).to(dev), e.kv, mesh=self.mesh)
        return out.cpu().numpy()

    def decode_state(self) -> Optional[List[Tuple]]:
        """Every rank's decode runner state, in rank order, gathered to
        rank 0 (None on the others): the generator's state bytes, the
        token and position carries and an mrope model's staged rope
        deltas (None for another)."""
        g = self.engine.graphs
        g = getattr(g, "_runner", g)
        return self.mesh.gather_object((
            g.generator.get_state().cpu().numpy().tobytes(),
            g.tokens.cpu().tolist(), g.positions.cpu().tolist(),
            None if g.rope_delta is None else g.rope_delta.cpu().tolist()))


def control(engine, attr: str, *args, **kwargs):
    """Rank 0: make ``Control.<attr>`` on every rank of ``engine``'s mesh;
    returns rank 0's result."""
    return _lead(engine.mesh, engine.name, "control", attr,
                 getattr(Control(engine, engine.mesh), attr), args, kwargs)


def life(mesh: Mesh, attr: str, fn, *args, **kwargs):
    """Rank 0: make ``Life.<attr>(*args, **kwargs)`` on every follower
    and ``fn()`` here, then agree on it. A raise between the broadcast
    and the agreement re-forms the world (``Mesh.reform``) before it
    goes on; ``MeshLost`` when the world does not come back."""
    try:
        return _lead(mesh, "", "life", attr, fn, (), {},
                     header=(args, kwargs))
    except Exception as exc:
        if not mesh.synced:
            mesh.reform(exc)
        raise


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def park(params, device: torch.device):
    """A host copy of a parameter tree, bit for bit: pinned (and copied
    without blocking, then synchronized) from a CUDA device."""
    if device.type != "cuda":
        return _map(torch.clone, params)

    def one(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    out = _map(one, params)
    torch.cuda.synchronize(device)
    return out


def unpark(params, device: torch.device):
    """A parked tree back on ``device``."""
    if device.type != "cuda":
        return params
    out = _map(lambda h: h.to(device, non_blocking=True), params)
    torch.cuda.synchronize(device)
    return out


def params_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(params_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def book_entry(rank: int, device: torch.device, engines: Dict[str, Any],
               parked: Dict[str, Any], timings: Dict[str, Dict[str, Any]],
               digests: bool = False) -> Dict[str, Any]:
    """What a rank holds (``Life.report``): its awake models with their
    shard's heads and bytes (and, with ``digests``, per-leaf sha256),
    its asleep ones with their parked bytes (and digests), the device's
    allocated bytes and free bytes (``torch.cuda.mem_get_info``, the
    whole card's), and each model's last sleep's and wake's timings."""
    from xllm_service_tpu_torch.runtime import checkpoint
    awake, asleep = {}, {}
    for model, eng in engines.items():
        if eng is None:
            p = parked.get(model)
            asleep[model] = {
                "parked_bytes": params_bytes(p) if p is not None else 0,
                **({"digests": checkpoint.param_digests(p)}
                   if digests and p is not None else {})}
            continue
        awake[model] = {
            "mesh": eng.mesh is not None,
            "heads": [eng.shard_cfg.num_heads, eng.shard_cfg.num_kv_heads],
            "bytes": params_bytes(eng.params),
            **({"digests": checkpoint.param_digests(eng.params)}
               if digests else {})}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    return {"rank": rank, "awake": awake, "asleep": asleep,
            "allocated": torch.cuda.memory_allocated(device) if cuda else 0,
            "free": torch.cuda.mem_get_info(device)[0] if cuda else 0,
            "timings": {m: dict(t) for m, t in timings.items()}}


class Life:
    """A follower's model book: one engine per model name, awake or
    asleep (None), with what each wake needs (the model's config and
    directory, the engine config and this rank's device), the shards
    parked by a sleep, and each model's last sleep's and wake's
    timings. Rank 0 drives it with ``life`` beside its own
    ``ModelRuntime``: ``fork`` stages a model asleep, ``sleep`` parks
    this rank's shard in host memory bit for bit and drops the engine,
    ``wake`` rebuilds it from the parked shard (warm: no re-slicing) or,
    with nothing parked, from the model directory's weights or random
    ones from the engine's seed, sliced to this rank's shard (cold).
    With every model asleep the rank holds nothing on the device."""

    def __init__(self, mesh: Mesh, engine_cfg: EngineConfig, device,
                 murmur_seed: int = 0) -> None:
        self.mesh, self.engine_cfg = mesh, engine_cfg
        self.device = torch.device(device)
        self.murmur_seed = murmur_seed
        self.engines: Dict[str, Any] = {}
        self.models: Dict[str, Tuple[ModelConfig, str]] = {}
        self.parked: Dict[str, Any] = {}
        self.timings: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def of(cls, engine, mesh: Mesh) -> "Life":
        """A book holding one awake engine, under its name."""
        book = cls(mesh, engine.ecfg, engine.device)
        book.models[engine.name] = (engine.cfg, "")
        book.engines[engine.name] = engine
        return book

    def fork(self, model: str, model_cfg: ModelConfig,
             model_dir: str = "") -> None:
        if model not in self.models:
            self.models[model] = (model_cfg, model_dir)
            self.engines[model] = None

    def _build(self, model: str, params, sharded: bool = False):
        from xllm_service_tpu_torch.runtime.engine import Engine
        cfg, _ = self.models[model]
        return Engine(cfg, self.engine_cfg, params=params,
                      device=self.device, murmur_seed=self.murmur_seed,
                      mesh=self.mesh, name=model, sharded=sharded)

    def sleep(self, model: str) -> None:
        eng = self.engines[model]
        if eng is None:
            return
        t0 = time.perf_counter()
        self.parked[model] = park(eng.params, self.device)
        t = self.timings.setdefault(model, {})
        t.update(d2h_s=time.perf_counter() - t0,
                 param_bytes=params_bytes(self.parked[model]))
        self.engines[model] = eng = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t["sleep_s"] = time.perf_counter() - t0

    def wake(self, model: str, params=None) -> None:
        """``params``: the full weights to build from (the primary's at
        boot, when the worker was given them)."""
        if self.engines.get(model) is not None:
            return
        t = self.timings.setdefault(model, {})
        t0 = time.perf_counter()
        parked = self.parked.get(model)
        if parked is not None:
            params, t["source"] = unpark(parked, self.device), "parked"
        elif params is None:
            _, model_dir = self.models[model]
            params = _full_params(model_dir, self.models[model][0],
                                  self.device)
            t["source"] = "random" if params is None else "checkpoint"
        else:
            t["source"] = "given"
        # The parked shard's way back, or the full weights' load.
        t["h2d_s" if parked is not None else "load_s"] = \
            time.perf_counter() - t0
        t1 = time.perf_counter()
        self.engines[model] = self._build(model, params,
                                          sharded=parked is not None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t["engine_s"] = time.perf_counter() - t1
        # Only now: a build that raised keeps the parked shard.
        self.parked.pop(model, None)

    def report(self, digests: bool = False) -> Optional[List[Dict]]:
        """Every rank's ``book_entry``, in rank order, gathered to rank
        0 (None on the others)."""
        return self.mesh.gather_object(book_entry(
            self.mesh.rank, self.device, self.engines, self.parked,
            self.timings, digests))


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
    """Rank 0, after a rank was lost: end the followers it started and
    leave the world without a stop broadcast (a follower may be waiting
    in a collective). Followers of a world the caller started see the
    world go (gloo) or time out (nccl)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    stop_processes(procs)
    mesh.close()


def _runner(book: Life, mesh: Mesh, model: str, name: str):
    if name == "life":
        return book
    eng = book.engines[model]
    if eng is None:
        raise RuntimeError(f"rank {mesh.rank}: a {name} call for "
                           f"{model!r}, which is asleep")
    if name == "control":
        return Control(eng, mesh)
    return {"decode": eng.graphs, "prefill": eng.prefill_graphs,
            "kv": eng.kv_plane}[name]


def follow(book, mesh: Mesh) -> int:
    """A follower's loop: make each call rank 0 broadcasts on the
    runners of the engine of the model it names in ``book`` (a ``Life``,
    or one engine, keyed by its name), or on the book itself, until
    rank 0 stops it. Returns the calls made. A call that raises re-forms
    the world (module docstring): an ``AGREED`` one at once, any other
    at the next agreed call. Ends with ``MeshLost`` when the world
    cannot re-form, and with the broadcast's error when rank 0 is
    gone."""
    if not isinstance(book, Life):
        book = Life.of(book, mesh)
    n = 0
    # A call without an agreement that raised, not reported yet.
    failed: Optional[BaseException] = None
    while True:
        msg = mesh.broadcast_object()
        if msg is None:
            return n
        if msg == _KEEPALIVE:
            continue
        model, name, attr, args, kwargs = msg
        agreed = attr in AGREED[name]
        try:
            if agreed and failed is not None:
                raise failed
            getattr(_runner(book, mesh, model, name), attr)(*args, **kwargs)
            if agreed:
                mesh.agree(True)
        except Exception as exc:  # noqa: BLE001 — this rank's fault
            if not agreed:
                failed = exc
                continue
            failed = None
            logger.warning("rank %d: %s.%s failed (%r); re-forming the "
                           "world", mesh.rank, name, attr, exc)
            mesh.reform(exc)
            continue
        n += 1
        if attr == "invalidate_staged":
            # Rank 0 reset after a fault: everything staged is uploaded
            # whole again.
            failed = None


@dataclasses.dataclass
class Launch:
    """What a follower needs to start its model book: the primary
    model's name (``model``, which its broadcasts name) and config, the
    engine config, the mesh, each rank's device, the backend and the
    rendezvous, where the full weights come from (``params`` given on
    the CPU, a ``model_dir`` checkpoint, else random from the engine's
    default seed on the rank's device, as rank 0's engine makes them),
    the murmur seed every engine's prefix cache takes, and whether the
    primary starts asleep (an encode worker's: nothing on the device
    until a wake). A model forked later comes with its own config and
    directory (``Life.fork``)."""
    model_cfg: ModelConfig
    engine_cfg: EngineConfig
    spec: MeshSpec
    devices: List[str]
    backend: str
    init_method: str
    model_dir: str = ""
    params: Optional[Dict[str, Any]] = None
    murmur_seed: int = 0
    model: str = ""
    start_asleep: bool = False


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
               murmur_seed: int = 0, model: str = "",
               start_asleep: bool = False
               ) -> Tuple[Mesh, List[subprocess.Popen]]:
    """Rank 0's side of a worker that starts its own ranks: plan the
    devices (``plan_devices``), start the followers with the same model
    (named ``model``; asleep with ``start_asleep``), engine config and
    weights (``params`` are copied to them on the CPU), and join them in
    a mesh over a localhost rendezvous. Returns this rank's mesh and the
    followers' processes."""
    backend = backend or default_backend(device)
    devices = plan_devices(spec.num_devices, device, backend)
    launch = Launch(model_cfg, engine_cfg, spec, devices, backend,
                    f"tcp://127.0.0.1:{free_port()}", model_dir=model_dir,
                    params=None if params is None or start_asleep
                    else _to(params, "cpu"),
                    murmur_seed=murmur_seed, model=model,
                    start_asleep=start_asleep)
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


def _full_params(model_dir: str, model_cfg: ModelConfig, device):
    """The directory's full weights on ``device`` when its shards hold
    the text stack, else None (random from the engine's seed)."""
    if model_dir:
        from xllm_service_tpu_torch.runtime import checkpoint
        if checkpoint.has_text_weights(model_dir):
            return checkpoint.load_checkpoint(model_dir, model_cfg, device)
    return None


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def follow_launch(launch: Launch, mesh: Mesh) -> int:
    """A follower's model book for ``launch`` on ``mesh`` (the primary
    built from its shard of the full weights, or staged asleep), then
    ``follow`` until rank 0 stops. Returns the calls made."""
    device = launch.devices[mesh.rank]
    book = Life(mesh, launch.engine_cfg, device, launch.murmur_seed)
    book.fork(launch.model, launch.model_cfg, launch.model_dir)
    if not launch.start_asleep:
        # The engine resolves its switches (the write order, ragged) from
        # the config and the environment, which a follower inherits.
        book.wake(launch.model, None if launch.params is None
                  else _to(launch.params, device))
    return follow(book, mesh)


def run_follower(launch: Launch, rank: int) -> int:
    """Join the mesh as rank ``rank`` and follow rank 0
    (``follow_launch``) until it stops. Returns the calls made."""
    mesh = make_mesh(launch.spec, rank, launch.devices[rank], launch.backend,
                     launch.init_method)
    try:
        return follow_launch(launch, mesh)
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
