"""The mesh of one worker instance over a ``torch.distributed`` world.

The counterpart of the JAX package's ``parallel/mesh.py``: axes (dp, ep,
sp, tp), tp varying fastest, so that a rank's coordinates are those of
its device in the JAX mesh's grid (``world rank = ((dp * EP + ep) * SP +
sp) * TP + tp``). Where JAX hands the grid to GSPMD, which then places
the collectives, here every process is one rank, and ``Mesh`` is what
the model calls for its collectives: one process group per axis (the
ranks that differ in that coordinate alone), the joint (ep, tp) group
the MoE reduce runs over, and the world for the step broadcasts of
``runtime/ranks.py``. No other module of the package calls
``torch.distributed``.

The backend is always named (``nccl`` on CUDA by default, ``gloo`` on
the CPU) and never switched behind the caller's back: NCCL refuses two
ranks on one card, so ``make_mesh`` raises for that layout and names
``gloo``. Under ``gloo`` every collective on a CUDA tensor is staged
through host memory (``staged``: copied out, reduced, gathered, sent or
broadcast on the CPU, copied back): gloo has no send/recv for device
tensors, and its device all-reduce and broadcast copy through the host
themselves. ``counts`` records the collectives by op, ``staged_s`` the
seconds the staged ones and the step broadcasts took.

Rank 0 moves page sets of the KV pools with ``gather`` (from a chosen
set of ranks) and ``scatter`` (a part to each rank): point-to-point
sends, staged through the host under gloo, on the device under nccl.
``agree`` is a one-int all-reduce on a CPU tensor (a gloo group of the
world under nccl), the status every rank reports after a launched
forward.

A step that fails on some rank leaves the others in a collective that
will never complete, or ahead of it. ``reform`` is the way back: the
rank leaves every process group it holds (a gloo peer then sees its
pairs close and fails promptly, rather than at ``TIMEOUT``), and joins
the world again under the next ``epoch``, a fresh key prefix on the
same rendezvous store. The process, its engine, weights and pools stay.
Under nccl it is untried (the layout needs a card per rank) whether the
groups' destruction wakes a peer blocked in a collective; NCCL does not
see a peer die, so such a peer may wait out ``TIMEOUT``.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import pickle
import socket
import time
import traceback
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import torch

AXIS_DP = "dp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_EP, AXIS_SP, AXIS_TP)
# The MoE layer's reduce: every rank holding a share of the experts'
# products (its experts, and within them its columns).
AXIS_EP_TP = (AXIS_EP, AXIS_TP)

BACKENDS = ("nccl", "gloo")
# How long a collective waits for its peers before it fails. A follower
# idles in a broadcast between requests, so rank 0 sends a keep-alive
# every ``KEEPALIVE_S`` while idle (``runtime/ranks.py``); the bound
# covers a rank's start (its weights loaded) and a kernel's first
# build. Under NCCL, which does not see a peer die, this is how long a
# rank waits on a lost peer.
TIMEOUT = datetime.timedelta(minutes=10)
KEEPALIVE_S = 30.0


class MeshLost(RuntimeError):
    """The world could not be re-formed: a peer did not come back (it
    exited, or it did not arrive at the rendezvous within ``TIMEOUT``)."""


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parallel degrees of one worker instance's mesh."""

    dp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.sp * self.tp

    @classmethod
    def for_devices(cls, n: int, tp: Optional[int] = None) -> "MeshSpec":
        """Default spec: all devices to tensor parallelism (the right
        default for single-host serving of a dense model)."""
        return cls(tp=tp or n)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank -> its (dp, ep, sp, tp) coordinates, tp fastest."""
        out: Dict[str, int] = {}
        for a in reversed(MESH_AXES):
            n = getattr(self, a)
            out[a] = rank % n
            rank //= n
        return {a: out[a] for a in MESH_AXES}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in MESH_AXES:
            r = r * getattr(self, a) + coords[a]
        return r


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device_ids: Sequence[str]) -> None:
    """Refuse a layout the backend cannot run: NCCL on anything but
    CUDA devices, or NCCL with two ranks on one card (``device_ids``:
    one identity per rank, ``host/uuid``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "nccl":
        return
    if any(d.endswith("/cpu") for d in device_ids):
        raise ValueError("the nccl backend needs a CUDA device on every "
                         "rank; use --dist-backend gloo on the CPU")
    seen: Dict[str, int] = {}
    for rank, d in enumerate(device_ids):
        if d in seen:
            raise ValueError(
                f"ranks {seen[d]} and {rank} share one card ({d}): NCCL "
                f"refuses two ranks on one GPU; use --dist-backend gloo "
                f"(or give each rank its own card)")
        seen[d] = rank


def device_identity(device) -> str:
    """``host/<card uuid>`` of a CUDA device, ``host/cpu`` otherwise."""
    device = torch.device(device)
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}/cpu"
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    uuid = getattr(props, "uuid", None)
    return f"{host}/{uuid if uuid is not None else f'cuda:{idx}'}"


class Mesh:
    """This rank's place in the mesh and the collectives over its axes
    (see the module docstring). A one-rank mesh needs no process group;
    every collective is then the identity."""

    def __init__(self, spec: MeshSpec, rank: int, backend: str,
                 device, groups: Dict[Any, Any], store=None) -> None:
        self.spec = spec
        self.rank = rank
        self.backend = backend
        self.device = torch.device(device)
        self.coords = spec.coords(rank)
        self._groups = groups
        # The rendezvous store (kept: rank 0 serves a TCPStore from it,
        # and ``reform`` rendezvouses on it again).
        self._store = store
        # The gloo group ``agree`` reduces over under nccl (None: the
        # default group).
        self._cpu_group = None
        # Re-formations so far (``reform``); the world's key prefix.
        self.epoch = 0
        # False from the broadcast of a call whose status the ranks
        # agree on until that agreement (``runtime/ranks.py``): a
        # failure in between leaves the world out of step.
        self.synced = True
        # Rank 0's check, while it waits to re-form, that the peers it
        # started still run (None: wait up to ``TIMEOUT``).
        self.alive: Optional[Callable[[], bool]] = None
        self.lost = False
        # The gloo path stages device tensors through the host.
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.counts: Dict[str, int] = collections.Counter()
        self.staged_s: Dict[str, float] = collections.Counter()
        # When this rank last took part in a world broadcast.
        self.last_broadcast = time.monotonic()

    # -- geometry -------------------------------------------------------
    @property
    def world(self) -> int:
        return self.spec.num_devices

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= getattr(self.spec, a)
        return n

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (a joint index, the last axis
        fastest, for several)."""
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * getattr(self.spec, a) + self.coords[a]
        return i

    def _group(self, axes):
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups.get(key)

    def _peer(self, axis: str, step: int) -> int:
        """The world rank ``step`` places along ``axis`` (cyclic)."""
        c = dict(self.coords)
        c[axis] = (c[axis] + step) % getattr(self.spec, axis)
        return self.spec.rank_of(c)

    # -- staging --------------------------------------------------------
    def _host(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().to("cpu") if self.staged else x

    def _back(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(like.device, non_blocking=False) if self.staged else x

    def _tick(self, op: str, t0: float) -> None:
        self.counts[op] += 1
        if self.staged:
            self.staged_s[op] += time.perf_counter() - t0

    # -- collectives ----------------------------------------------------
    def all_reduce(self, x: torch.Tensor, axes=AXIS_TP) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axes``, in float32, returned
        in x's dtype (a new tensor; ``x`` unchanged)."""
        if self.size(axes) == 1:
            return x
        t0 = time.perf_counter()
        buf = self._host(x).float()
        if buf is x:
            buf = buf.clone()
        torch.distributed.all_reduce(buf, group=self._group(axes))
        out = self._back(buf, x).to(x.dtype)
        self._tick("all_reduce", t0)
        return out

    def all_gather(self, x: torch.Tensor, axes=AXIS_TP,
                   dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` of ``axes`` concatenated along ``dim`` in
        rank order."""
        n = self.size(axes)
        if n == 1:
            return x
        t0 = time.perf_counter()
        buf = self._host(x).contiguous()
        parts = [torch.empty_like(buf) for _ in range(n)]
        torch.distributed.all_gather(parts, buf, group=self._group(axes))
        out = self._back(torch.cat(parts, dim=dim), x)
        self._tick("all_gather", t0)
        return out

    def ring_shift(self, x: torch.Tensor, axis: str = AXIS_SP
                   ) -> torch.Tensor:
        """Send ``x`` to the next rank along ``axis`` and return the
        previous rank's (ring attention's ``ppermute`` by +1)."""
        if self.size(axis) == 1:
            return x
        t0 = time.perf_counter()
        buf = self._host(x).contiguous()
        got = torch.empty_like(buf)
        reqs = [torch.distributed.isend(buf, self._peer(axis, 1)),
                torch.distributed.irecv(got, self._peer(axis, -1))]
        for r in reqs:
            r.wait()
        out = self._back(got, x)
        self._tick("send_recv", t0)
        return out

    def gather(self, x: torch.Tensor, sources: Sequence[int],
               device=None) -> Optional[List[torch.Tensor]]:
        """Rank 0: the ``x`` of every rank of ``sources`` (world ranks,
        0 among them, every ``x`` of one shape and dtype), in that
        order, on ``device`` (default x's). A source sends its ``x``;
        every other rank returns None at once."""
        device = x.device if device is None else torch.device(device)
        if self.world == 1:
            return [x.to(device)]
        if self.rank != 0 and self.rank not in sources:
            return None
        t0 = time.perf_counter()
        if self.rank != 0:
            torch.distributed.send(self._host(x).contiguous(), 0)
            self._tick("gather", t0)
            return None
        parts = {r: torch.empty(x.shape, dtype=x.dtype,
                                device="cpu" if self.staged else x.device)
                 for r in sources if r != 0}
        reqs = [torch.distributed.irecv(t, r) for r, t in parts.items()]
        for req in reqs:
            req.wait()
        out = [(x if r == 0 else parts[r]).to(device) for r in sources]
        self._tick("gather", t0)
        return out

    def scatter(self, parts: Optional[Dict[int, torch.Tensor]],
                shape: Sequence[int], dtype: torch.dtype,
                device) -> torch.Tensor:
        """Rank 0 passes ``parts``, one tensor of ``shape`` for every
        world rank, and sends each rank its own; every rank returns its
        part in ``dtype`` on ``device`` (the others pass None)."""
        if self.world == 1:
            return parts[0].to(device, dtype)
        t0 = time.perf_counter()
        # gloo sends host tensors, nccl device ones.
        wire = device if self.backend == "nccl" else "cpu"
        if self.rank == 0:
            reqs = [torch.distributed.isend(
                parts[r].to(wire, dtype).contiguous(), r)
                for r in range(1, self.world)]
            for req in reqs:
                req.wait()
            out = parts[0].to(device, dtype)
        else:
            buf = torch.empty(tuple(shape), dtype=dtype, device=wire)
            torch.distributed.recv(buf, 0)
            out = buf.to(device)
        self._tick("scatter", t0)
        return out

    def broadcast(self, x: Optional[torch.Tensor], shape: Sequence[int],
                  dtype: torch.dtype, device) -> torch.Tensor:
        """World rank 0's tensor ``x`` (of ``shape`` and ``dtype``) on
        every rank, on ``device``: one broadcast over the world, staged
        through the host under gloo, on the device under nccl. The
        others pass None. Counted as ``broadcast_tensor``."""
        if self.world == 1:
            return x.to(device, dtype)
        t0 = time.perf_counter()
        wire = device if self.backend == "nccl" else "cpu"
        if self.rank == 0:
            buf = x.to(wire, dtype).contiguous()
        else:
            buf = torch.empty(tuple(shape), dtype=dtype, device=wire)
        torch.distributed.broadcast(buf, src=0)
        out = buf.to(device)
        self.counts["broadcast_tensor"] += 1
        self.staged_s["broadcast_tensor"] += time.perf_counter() - t0
        return out

    def agree(self, ok: bool = True) -> bool:
        """Whether every rank of the world passed ``ok`` (a one-int
        all-reduce on a CPU tensor)."""
        if self.world == 1:
            return ok
        t0 = time.perf_counter()
        flag = torch.tensor([0 if ok else 1], dtype=torch.int32)
        torch.distributed.all_reduce(flag, group=self._cpu_group)
        self.counts["agree"] += 1
        self.staged_s["agree"] += time.perf_counter() - t0
        return int(flag.item()) == 0

    def broadcast_object(self, obj: Any = None, tally: bool = True) -> Any:
        """World rank 0's ``obj`` on every rank (pickled; a length and
        the bytes, two broadcasts). Rank 0 passes it, the others None.
        ``tally=False`` leaves ``counts`` and ``staged_s`` alone (a
        keep-alive)."""
        if self.world == 1:
            return obj
        t0 = time.perf_counter()
        dev = self.device if self.backend == "nccl" else "cpu"
        if self.rank == 0:
            data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
        else:
            n = torch.zeros(1, dtype=torch.int64, device=dev)
        torch.distributed.broadcast(n, src=0)
        size = int(n.item())
        if self.rank == 0:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        else:
            buf = torch.empty(size, dtype=torch.uint8, device=dev)
        torch.distributed.broadcast(buf, src=0)
        if self.rank != 0:
            obj = pickle.loads(buf.cpu().numpy().tobytes())
        self.last_broadcast = time.monotonic()
        if tally:
            self.counts["broadcast"] += 1
            self.staged_s["broadcast"] += time.perf_counter() - t0
        return obj

    def gather_object(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj`` (pickled), in rank order, on world rank
        0; None on the others. Not counted in ``counts``."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        torch.distributed.gather_object(obj, out, dst=0)
        return out

    def snapshot(self) -> Tuple[Dict[str, int], Dict[str, float]]:
        """Copies of ``counts`` and ``staged_s`` (to difference or
        restore them)."""
        return dict(self.counts), dict(self.staged_s)

    def close(self) -> None:
        """Leave the world (the process's default group)."""
        self._groups = {}
        self._cpu_group = None
        if self.world > 1 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    def reform(self, exc: Optional[BaseException] = None) -> None:
        """Leave every process group and join the world again under the
        next epoch (module docstring). ``exc``: the failure that left
        the world out of step; its frames' locals are cleared, so that
        no group outlives this rank's leaving in them. Raises
        ``MeshLost`` when a peer does not come back (rank 0 asks
        ``alive`` while it waits); the mesh is then unusable."""
        if self.lost:
            raise MeshLost(f"rank {self.rank}: the world is gone")
        if exc is not None:
            traceback.clear_frames(exc.__traceback__)
        self.close()
        self.epoch += 1
        key = f"mesh/reform/{self.epoch}"
        self._store.add(key, 1)
        deadline = time.monotonic() + TIMEOUT.total_seconds()
        while int(self._store.add(key, 0)) < self.world:
            if self.alive is not None and not self.alive():
                self.lost = True
                raise MeshLost(f"epoch {self.epoch}: a peer is gone")
            if time.monotonic() > deadline:
                self.lost = True
                raise MeshLost(f"epoch {self.epoch}: the peers did not "
                               f"re-form within {TIMEOUT}")
            time.sleep(0.01)
        self._join()
        self.synced = True

    def _join(self) -> None:
        """Join the world of the current epoch on the store and make the
        axis groups (every rank makes every group, in one order)."""
        spec, rank, world = self.spec, self.rank, self.world
        prefix = "world" if self.epoch == 0 else f"world/{self.epoch}"
        torch.distributed.init_process_group(
            self.backend,
            store=torch.distributed.PrefixStore(prefix, self._store),
            rank=rank, world_size=world, timeout=TIMEOUT)
        groups: Dict[Tuple[str, ...], Any] = {}
        for axes in [(a,) for a in MESH_AXES] + [AXIS_EP_TP]:
            members: Dict[Tuple, List[int]] = collections.defaultdict(list)
            for r in range(world):
                c = spec.coords(r)
                members[tuple(c[a] for a in MESH_AXES
                              if a not in axes)].append(r)
            size = 1
            for a in axes:
                size *= getattr(spec, a)
            if size == 1:
                continue
            if size == world:
                groups[axes] = None                 # the default group
                continue
            own = tuple(self.coords[a] for a in MESH_AXES if a not in axes)
            for key in sorted(members):
                g = torch.distributed.new_group(members[key],
                                                timeout=TIMEOUT,
                                                backend=self.backend)
                if key == own:
                    groups[axes] = g
        if self.backend == "nccl":
            self._cpu_group = torch.distributed.new_group(
                list(range(world)), timeout=TIMEOUT, backend="gloo")
        self._groups = groups


def _exchange_identities(store, rank: int, world: int,
                         ident: str) -> List[str]:
    store.set(f"mesh/device/{rank}", ident)
    return [store.get(f"mesh/device/{r}").decode() for r in range(world)]


def make_mesh(spec: MeshSpec, rank: int = 0, device="cuda",
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh``: joins the world of ``spec.num_devices``
    processes at ``init_method`` (``tcp://host:port`` or
    ``file:///path``; needed for more than one rank) as ``rank``, checks
    that ``backend`` (default: ``default_backend(device)``) can run the
    ranks' devices (``check_backend``, over the store before any group
    is made), and makes the axis groups. Every rank must call it with
    the same spec."""
    backend = backend or default_backend(device)
    world = spec.num_devices
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside the mesh's {world} ranks")
    if world == 1:
        check_backend(backend, [device_identity(device)])
        return Mesh(spec, 0, backend, device, {})
    if not init_method:
        raise ValueError(f"a mesh of {world} ranks needs an init method "
                         f"(tcp://host:port or file:///path)")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    store = _make_store(init_method, rank, world)
    check_backend(backend, _exchange_identities(
        store, rank, world, device_identity(device)))
    mesh = Mesh(spec, rank, backend, device, {}, store=store)
    mesh._join()
    return mesh


def _make_store(init_method: str, rank: int, world: int):
    """The rendezvous store of ``init_method``: a TCPStore served by rank
    0 (``tcp://host:port``) or a FileStore (``file:///path``)."""
    if init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        return torch.distributed.TCPStore(
            host, int(port), world, rank == 0, timeout=TIMEOUT,
            wait_for_workers=False)
    if init_method.startswith("file://"):
        return torch.distributed.FileStore(init_method[len("file://"):],
                                           world)
    raise ValueError(f"unknown init method {init_method!r}")


def free_port() -> int:
    """A free TCP port on localhost (for a ``tcp://`` rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
