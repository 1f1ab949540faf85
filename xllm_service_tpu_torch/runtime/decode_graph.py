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

All graphs share one memory pool; they never run at once. A capture
that fails raises: nothing falls back to eager steps on CUDA. Steps run
eagerly, through the same body and buffers, where graphs are off (the
CPU, ``EngineConfig.cuda_graphs=False``) or a row draws from its own
seeded generator; ``report()`` counts them under that reason.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

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
        self.captures_after_warmup = 0
        # Dispatches (a replay or an eager call) and the forwards in them.
        self.launches = 0
        self.forwards = 0
        self.eager_steps: Dict[str, int] = collections.Counter()

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
            self.captures_after_warmup += 1
        width, n, greedy = key
        self.table(width)
        if not self.use_graphs:
            self.graphs[key] = None
            return
        saved = (self.tokens.clone(), self.positions.clone(),
                 self.active.clone(), self.generator.get_state())
        # One eager step first, every row inactive (the writers write
        # nothing), on a side stream: lazy set-up (libraries' handles
        # and workspaces, the kernels' modules) stays out of the graph.
        self.active.zero_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body(width, 1, greedy)
        torch.cuda.current_stream().wait_stream(side)
        self.tokens.copy_(saved[0])
        self.positions.copy_(saved[1])
        self.active.copy_(saved[2])
        graph = torch.cuda.CUDAGraph()
        if not greedy:
            graph.register_generator_state(self.generator)
        with capture_tally() as tally:
            with torch.cuda.graph(graph, pool=self.pool):
                tokens, logprobs, dropped = self._body(width, n, greedy)
        self.generator.set_state(saved[3])
        self.graphs[key] = _Graph(graph, tokens, logprobs, dropped, tally)

    def launch(self, key: Key, seeded: Optional[Seeded] = None) -> Launch:
        """Run ``key``'s step(s) from the staged inputs: a graph replay,
        or the body eagerly where graphs are off or rows are seeded."""
        self.prepare(key)
        g = self.graphs[key]
        self.launches += 1
        self.forwards += key[1]
        if g is None or seeded is not None:
            self.eager_steps["seeded" if g is not None else
                             "graphs_off" if self.device.type == "cuda"
                             else "cpu"] += 1
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

    def report(self) -> Dict[str, object]:
        def name(k: Key) -> str:
            return f"mp{k[0]}_n{k[1]}_{'greedy' if k[2] else 'sampled'}"
        return {
            "cuda_graphs": self.use_graphs,
            "graphs": {name(k): (g.replays if g is not None else 0)
                       for k, g in sorted(self.graphs.items())},
            "captured": len(self.graphs),
            "captures_after_warmup": self.captures_after_warmup,
            "replays": sum(g.replays for g in self.graphs.values()
                           if g is not None),
            "eager_steps": dict(self.eager_steps),
        }


def decode_widths(max_pages_per_seq: int) -> List[int]:
    """Every table width a decode step can take: the powers of two below
    ``max_pages_per_seq``, and that width itself (the clamp)."""
    widths, w = [], 1
    while w < max_pages_per_seq:
        widths.append(w)
        w <<= 1
    return widths + [max_pages_per_seq]


__all__ = ["DecodeGraphs", "Launch", "Seeded", "decode_widths"]
