"""Decode steps through CUDA graphs: the counterpart of the JAX engine's
jitted decode programs ``_jit_decode`` (one step) and
``_jit_decode_multi`` (N fused steps, ``_decode_multi_step``).

One graph per key (table width MP, steps n, greedy or sampled). The
batch is the engine's fixed ``max_batch_size`` slots. Every input lives
in a static device buffer that the engine fills before a replay, and
only where it changed: the sampled tokens and positions, the active
mask, one page table per width, and the per-slot sampling tensors. The
body runs n forwards, each feeding its sampled token and ``pos + 1``
forward on the device, and ends by copying the last token and position
back into the input buffers: the next burst starts from these carries
with no upload, also when it is dispatched before this one is read back
(the engine's speculative pipeline). Each launch's [n, B] tokens and
logprobs are copied into one of two pinned host buffers behind a CUDA
event, so burst k's copy is queued before burst k+1 replays over the
graph's outputs. An MoE model's capacity drops are summed over the n
forwards into a device scalar, a third output of the graph, copied
beside the tokens: a replay reports them with no host sync per layer.
Tables may carry NULL (0) entries where a sliding window trimmed a
sequence's leading pages; every kernel reads them only in lanes the
window masks.

All graphs, these and the prefill runner's (``runtime/prefill_graph.py``),
share one memory pool; they never run at once. A capture
that fails raises: nothing falls back to eager steps on CUDA. Steps run
eagerly, through the same body and buffers, where graphs are off (the
CPU, ``EngineConfig.cuda_graphs=False``) or a row draws from its own
seeded generator; ``report()`` counts them under that reason.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.models import transformer
from xllm_service_tpu_torch.ops.kernels._launch import (capture_tally,
                                                        count_replay)
from xllm_service_tpu_torch.ops.sampling import (SamplingTensors,
                                                 compute_logprobs,
                                                 sample_packed,
                                                 sample_seeded)

Key = Tuple[int, int, bool]             # (table width, steps, greedy)


@dataclasses.dataclass
class Seeded:
    """Rows drawn from per-row generators seeded by (seed, position):
    ``positions`` are each row's positions at the burst's first step."""
    rows: List[int]
    seeds: List[int]
    positions: List[int]

    def advanced(self, n: int) -> "Seeded":
        return Seeded(self.rows, self.seeds, [p + n for p in self.positions])


@dataclasses.dataclass
class Launch:
    """One dispatched step or burst: its outputs, on their way to the
    host."""
    n: int
    tokens: torch.Tensor                # [n, B] (pinned host on CUDA)
    logprobs: torch.Tensor
    event: Optional[torch.cuda.Event] = None
    # MoE capacity drops of the n forwards ([1]; None for other models),
    # and their value once read.
    dropped: Optional[torch.Tensor] = None
    moe_dropped: int = 0

    def read(self) -> Tuple[List[List[int]], List[List[float]]]:
        if self.event is not None:
            self.event.synchronize()
        if self.dropped is not None:
            self.moe_dropped = int(self.dropped[0])
        return (self.tokens[:self.n].tolist(),
                self.logprobs[:self.n].tolist())


class _Graph:
    def __init__(self, graph, tokens, logprobs, dropped, tally) -> None:
        self.graph, self.tokens, self.logprobs = graph, tokens, logprobs
        self.dropped = dropped
        self.tally = tally              # kernels captured, by wrapper
        self.replays = 0


def capture(warm_up: Callable[[], None], body: Callable[[], Tuple],
            pool, generator: torch.Generator, greedy: bool) -> _Graph:
    """``body()`` (returning tokens, logprobs and the drop count)
    captured into a graph in ``pool``. ``warm_up()`` runs first, eagerly
    on a side stream, so that lazy set-up (libraries' handles and
    workspaces, the kernels' modules) stays out of the graph; it must
    leave the inputs as it found them. A sampled body (not ``greedy``)
    registers ``generator``, whose state is as it was before."""
    state = generator.get_state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if not greedy:
        graph.register_generator_state(generator)
    with capture_tally() as tally:
        with torch.cuda.graph(graph, pool=pool):
            tokens, logprobs, dropped = body()
    generator.set_state(state)
    return _Graph(graph, tokens, logprobs, dropped, tally)


class DecodeGraphs:
    """The decode step runner of one engine (see the module
    docstring)."""

    def __init__(self, params, cfg, kv, batch: int, max_steps: int,
                 write_then_attend: bool, generator: torch.Generator,
                 device: torch.device, use_graphs: bool) -> None:
        self.params, self.cfg, self.kv = params, cfg, kv
        self.B, self.wta, self.generator = batch, write_then_attend, generator
        self.device = device
        self.use_graphs = use_graphs
        # MLA models count no drop (their routed experts run dense).
        self.count_drops = cfg.is_moe and not cfg.mla
        B = batch
        self.tokens = torch.zeros(B, dtype=torch.int64, device=device)
        self.positions = torch.zeros(B, dtype=torch.int32, device=device)
        self.active = torch.zeros(B, dtype=torch.bool, device=device)
        self.tables: Dict[int, torch.Tensor] = {}
        self.st = SamplingTensors.zeros(B, device)
        # Host mirrors of the last upload, compared before the next.
        self._apt_mirror: Optional[Tuple[int, np.ndarray]] = None
        self._st_mirror: Optional[np.ndarray] = None
        self.graphs: Dict[Key, Optional[_Graph]] = {}
        self.pool = (torch.cuda.graph_pool_handle() if use_graphs
                     else None)
        self._host: List[Tuple[torch.Tensor, ...]] = []
        if device.type == "cuda":
            self._host = [
                (torch.empty((max_steps, B), dtype=torch.int64,
                             pin_memory=True),
                 torch.empty((max_steps, B), dtype=torch.float32,
                             pin_memory=True),
                 torch.empty((1,), dtype=torch.int64, pin_memory=True))
                for _ in range(2)]
        self._next_host = 0
        self.warm = False
        # The keys captured after warmup, and the eager steps by program
        # (``program``: single steps, fused bursts).
        self.late: List[Key] = []
        self.eager_steps: Dict[str, Dict[str, int]] = {
            p: collections.Counter() for p in PROGRAMS}
        # Dispatches (a replay or an eager call) and the forwards in them.
        self.launches = 0
        self.forwards = 0

    # ------------------------------------------------------------------
    # Static inputs
    # ------------------------------------------------------------------
    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            # Pinned staging (the caching host allocator keeps it until
            # the copy ran): no stream sync, so a burst still running
            # on the device is not waited for.
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def table(self, width: int) -> torch.Tensor:
        t = self.tables.get(width)
        if t is None:
            t = self.tables[width] = torch.zeros(
                (self.B, width), dtype=torch.int32, device=self.device)
        return t

    def stage_active_table(self, active: np.ndarray,
                           table: np.ndarray) -> bool:
        """Upload the active mask and the page table of width
        ``table.shape[1]`` unless they equal the last upload; True when
        they were uploaded."""
        if self.active_table_matches(active, table):
            return False
        self._upload(self.active, active)
        self._upload(self.table(table.shape[1]), table)
        self._apt_mirror = (table.shape[1], np.concatenate(
            [active[:, None].astype(np.int32), table], axis=1))
        return True

    def active_table_matches(self, active: np.ndarray,
                             table: np.ndarray) -> bool:
        m = self._apt_mirror
        return (m is not None and m[0] == table.shape[1]
                and np.array_equal(m[1][:, 0], active)
                and np.array_equal(m[1][:, 1:], table))

    def stage_sampling(self, packed: np.ndarray) -> None:
        if self._st_mirror is not None and \
                np.array_equal(self._st_mirror, packed):
            return
        self._upload(self.st.temperature, packed[:, 0].astype(np.float32))
        self._upload(self.st.top_p, packed[:, 1].astype(np.float32))
        self._upload(self.st.top_k, packed[:, 2].astype(np.int64))
        self._st_mirror = packed.copy()

    def stage_carries(self, tokens: np.ndarray,
                      positions: np.ndarray) -> None:
        self._upload(self.tokens, tokens)
        self._upload(self.positions, positions)

    # ------------------------------------------------------------------
    # The body
    # ------------------------------------------------------------------
    def _body(self, width: int, n: int, greedy: bool,
              seeded: Optional[Seeded] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """n decode forwards from the carries; ends by writing the last
        token and position back into them. Returns the [n, B] tokens and
        logprobs, and the [1] MoE drop count of the n forwards (None
        where none is counted)."""
        tok, pos = self.tokens, self.positions
        table = self.tables[width]
        toks, lps = [], []
        drops = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                 if self.count_drops else None)
        for j in range(n):
            logits, kv = transformer.forward_decode(
                self.params, self.cfg, tok, pos, self.active, self.kv,
                table, write_then_attend=self.wta, moe_dropped=drops)
            if kv[0] is not self.kv[0] or kv[1] is not self.kv[1]:
                raise RuntimeError("forward_decode replaced the KV pools; "
                                   "the writers must write in place")
            new = sample_packed(logits, self.st, self.generator, greedy)
            if seeded is not None:
                sample_seeded(new, logits, self.st, seeded.rows,
                              seeded.seeds, seeded.advanced(j).positions)
            toks.append(new)
            lps.append(compute_logprobs(logits, new))
            tok, pos = new, pos + 1
        self.tokens.copy_(tok)
        self.positions.copy_(pos)
        return torch.stack(toks), torch.stack(lps), drops

    # ------------------------------------------------------------------
    # Capture and launch
    # ------------------------------------------------------------------
    def prepare(self, key: Key) -> None:
        """Capture ``key``'s graph (on the CPU, or with graphs off, only
        record the key). The staged inputs, the carries and the
        generator's state are as they were before."""
        if key in self.graphs:
            return
        if self.warm:
            self.late.append(key)
        width, n, greedy = key
        self.table(width)
        if not self.use_graphs:
            self.graphs[key] = None
            return
        saved = (self.tokens.clone(), self.positions.clone(),
                 self.active.clone())

        def warm_up():
            # Every row inactive: the writers write nothing.
            self.active.zero_()
            self._body(width, 1, greedy)
            for buf, old in zip((self.tokens, self.positions, self.active),
                                saved):
                buf.copy_(old)
        self.graphs[key] = capture(warm_up,
                                   lambda: self._body(width, n, greedy),
                                   self.pool, self.generator, greedy)

    def launch(self, key: Key, seeded: Optional[Seeded] = None) -> Launch:
        """Run ``key``'s step(s) from the staged inputs: a graph replay,
        or the body eagerly where graphs are off or rows are seeded."""
        self.prepare(key)
        g = self.graphs[key]
        self.launches += 1
        self.forwards += key[1]
        if g is None or seeded is not None:
            self.eager_steps[program(key)][
                "seeded" if g is not None else
                "graphs_off" if self.device.type == "cuda" else "cpu"] += 1
            tokens, logprobs, dropped = self._body(*key, seeded=seeded)
        else:
            g.graph.replay()
            count_replay(g.tally)
            g.replays += 1
            tokens, logprobs, dropped = g.tokens, g.logprobs, g.dropped
        if not self._host:
            return Launch(key[1], tokens, logprobs, dropped=dropped)
        host_tok, host_lp, host_drop = self._host[self._next_host]
        self._next_host ^= 1
        n = key[1]
        host_tok[:n].copy_(tokens, non_blocking=True)
        host_lp[:n].copy_(logprobs, non_blocking=True)
        if dropped is not None:
            host_drop.copy_(dropped, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return Launch(n, host_tok, host_lp, event,
                      dropped=host_drop if dropped is not None else None)

    def programs(self) -> Dict[str, Dict[str, object]]:
        """Per program (``decode``, ``decode_multi``): the graphs by key
        with their replays, the captures after warmup and the eager
        steps by reason."""
        def name(k: Key) -> str:
            return f"mp{k[0]}_n{k[1]}_{'greedy' if k[2] else 'sampled'}"
        return program_census(list(self.graphs.items()), PROGRAMS, program,
                              name, list(self.late), self.eager_steps)

    def report(self) -> Dict[str, object]:
        """The census of both programs together."""
        return census_totals(self.programs(), self.use_graphs)


PROGRAMS = ("decode", "decode_multi")


def program(key: Key) -> str:
    """The JAX program a decode key counts under: ``decode`` (one step,
    ``_jit_decode``) or ``decode_multi`` (a fused burst)."""
    return "decode" if key[1] == 1 else "decode_multi"


def program_census(items, programs, program_of, name_of, late,
                   eager) -> Dict[str, Dict[str, object]]:
    """A runner's census by program: its graphs (``items``: key, graph
    or None where none is captured) by name with their replays, the
    count of them, the captures after warmup (``late``: their keys, in
    order) and the eager steps by reason (``eager``)."""
    out = {p: {"graphs": {}, "captured": 0, "replays": 0,
               "captures_after_warmup": 0, "late": [],
               "eager_steps": dict(eager.get(p, {}))} for p in programs}
    for k in late:
        row = out[program_of(k)]
        row["captures_after_warmup"] += 1
        row["late"].append(name_of(k))
    for k, g in sorted(items):
        row = out[program_of(k)]
        replays = g.replays if g is not None else 0
        row["graphs"][name_of(k)] = replays
        row["captured"] += 1
        row["replays"] += replays
    return out


def census_totals(programs: Dict[str, Dict[str, object]],
                  use_graphs: bool) -> Dict[str, object]:
    """``programs`` with their sums: graphs captured, captures after
    warmup, replays and eager steps by reason over every program."""
    eager: Dict[str, int] = collections.Counter()
    for row in programs.values():
        eager.update(row["eager_steps"])
    out: Dict[str, object] = {
        "cuda_graphs": use_graphs,
        "captured": sum(r["captured"] for r in programs.values()),
        "captures_after_warmup": sum(r["captures_after_warmup"]
                                     for r in programs.values()),
        "replays": sum(r["replays"] for r in programs.values()),
        "eager_steps": dict(eager)}
    out.update(programs)
    return out


def decode_widths(max_pages_per_seq: int) -> List[int]:
    """Every table width a decode step can take: the powers of two below
    ``max_pages_per_seq``, and that width itself (the clamp)."""
    widths, w = [], 1
    while w < max_pages_per_seq:
        widths.append(w)
        w <<= 1
    return widths + [max_pages_per_seq]


__all__ = ["DecodeGraphs", "Launch", "PROGRAMS", "Seeded", "capture",
           "census_totals", "decode_widths", "program", "program_census"]
