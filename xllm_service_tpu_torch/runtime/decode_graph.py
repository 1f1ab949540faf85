"""Decode steps through CUDA graphs: the counterpart of the JAX engine's
jitted decode programs ``_jit_decode`` (one step) and
``_jit_decode_multi`` (N fused steps, ``_decode_multi_step``).

One graph per key (``Key``: table width MP, steps n, and the sampling
variant: greedy or sampled, whether some sampled row is seeded, whether
the penalty counts ride along, the ``logit_bias`` width K). The batch is
the engine's fixed ``max_batch_size`` slots. Every input lives in a
static device buffer that the engine fills before a replay, and only
where it changed: the sampled tokens and positions, the active mask,
one page table per width, the packed sampling pair (float32 [B, 4],
int32 [B, 2]), the bias ids and values [B, K] (always staged, zeros
when unused, as the JAX engine always builds them), for an mrope model
each slot's rope delta (its generated tokens rotate at position + delta)
and, for penalized keys, the [B, V] output-token counts. The body runs n forwards, each
sampling with the bias and (penalized keys) the penalties, adding its
tokens to the counts, and feeding its sampled token and ``pos + 1``
forward on the device; it ends by copying the last token and position
back into the input buffers: the next burst starts from these carries
with no upload, also when it is dispatched before this one is read back
(the engine's speculative pipeline). A seeded key draws its seeded rows'
noise by threefry from (seed, position) inside the graph, so a seeded
request's step is a replay like any other. Each launch's [n, B] tokens
and logprobs (and, when asked for, the [n, B, k] top logprobs, k =
``EngineConfig.num_top_logprobs``) are copied into one of two pinned
host buffers behind a CUDA event, so burst k's copy is queued before
burst k+1 replays over the graph's outputs. An MoE model's capacity
drops are summed over the n forwards into a device scalar, copied beside
the tokens: a replay reports them with no host sync per layer. Tables
may carry NULL (0) entries where a sliding window trimmed a sequence's
leading pages; every kernel reads them only in lanes the window masks.

All graphs, these and the prefill runner's (``runtime/prefill_graph.py``),
share one memory pool; they never run at once. A capture
that fails raises: nothing falls back to eager steps on CUDA. Steps run
eagerly, through the same body and buffers, only where graphs are off
(the CPU, ``EngineConfig.cuda_graphs=False``); ``report()`` counts them
under that reason.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.models import transformer
from xllm_service_tpu_torch.ops.kernels._launch import (capture_tally,
                                                        count_replay)
from xllm_service_tpu_torch.ops.sampling import (SamplingTensors,
                                                 compute_logprobs,
                                                 compute_top_logprobs,
                                                 sample_packed,
                                                 update_counts)

# The logit-bias columns every graph is warmed with (the JAX engine's
# ``_BIAS_K``); a request with more entries takes the next power of two,
# captured at its first use.
BIAS_K = 8


class Key(NamedTuple):
    """A decode graph's key."""
    width: int                          # page-table columns
    steps: int                          # forwards per dispatch
    greedy: bool                        # no row samples
    seeded: bool = False                # some sampled row has a seed
    penalized: bool = False             # the counts ride along
    bias_k: int = BIAS_K                # logit-bias columns

    def suffix(self) -> str:
        return variant(self.greedy, self.seeded, self.penalized,
                       self.bias_k)


def variant(greedy: bool, seeded: bool, penalized: bool,
            bias_k: int) -> str:
    """The sampling variant's part of a graph's name: ``greedy`` or
    ``sampled``, then ``_seeded``, ``_penalized`` and ``_bias<K>`` (K
    past ``BIAS_K``) where they hold."""
    return (("greedy" if greedy else "sampled")
            + ("_seeded" if seeded else "")
            + ("_penalized" if penalized else "")
            + (f"_bias{bias_k}" if bias_k != BIAS_K else ""))


@dataclasses.dataclass
class Outputs:
    """What one body run leaves on the device: [n, B] (decode) or [B]
    (prefill) tokens and logprobs, the [1] MoE drop count (None where
    none is counted), the top logprobs (None when k = 0) and the prompt
    logprobs (prefill's echo variant only)."""
    tokens: torch.Tensor
    logprobs: torch.Tensor
    dropped: Optional[torch.Tensor] = None
    top_ids: Optional[torch.Tensor] = None
    top_lps: Optional[torch.Tensor] = None
    prompt_lps: Optional[torch.Tensor] = None


def top_rows(ids, lps) -> List[List[Dict[str, float]]]:
    """[B, k] top ids and logprobs (host lists) as each row's entries,
    ``{"token_id", "logprob"}``, best first (the JAX engine's
    ``_top_row``)."""
    return [[{"token_id": int(i), "logprob": float(lp)}
             for i, lp in zip(r_ids, r_lps)]
            for r_ids, r_lps in zip(ids, lps)]


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
    # [n, B, k] top logprobs, when the launch copied them.
    top_ids: Optional[torch.Tensor] = None
    top_lps: Optional[torch.Tensor] = None

    def read(self) -> Tuple[List[List[int]], List[List[float]],
                            Optional[List[List[List[Dict[str, float]]]]]]:
        """[n][B] tokens and logprobs, and [n][B] top entries (None
        unless copied)."""
        if self.event is not None:
            self.event.synchronize()
        if self.dropped is not None:
            self.moe_dropped = int(self.dropped[0])
        tops = None
        if self.top_ids is not None:
            tops = [top_rows(i, lp) for i, lp in zip(
                self.top_ids[:self.n].tolist(),
                self.top_lps[:self.n].tolist())]
        return (self.tokens[:self.n].tolist(),
                self.logprobs[:self.n].tolist(), tops)


class _Graph:
    def __init__(self, graph, outs: Outputs, tally) -> None:
        self.graph, self.outs = graph, outs
        self.tally = tally              # kernels captured, by wrapper
        self.replays = 0


# Per device, the warm-up stream and the capture stream of every graph:
# the caching allocator reuses a freed block only on the stream it was
# allocated on, so one pair lets each warm-up reuse the last one's
# temporaries and each capture the pool blocks the last one freed.
_STREAMS: Dict[int, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}
# Cached bytes no tensor holds past which a capture first returns them to
# the device (the warm-ups' temporaries; the pool draws on the device).
_CACHE_SLACK = 2 << 30


def capture(warm_up: Callable[[], None], body: Callable[[], Outputs],
            pool, generator: torch.Generator, greedy: bool) -> _Graph:
    """``body()`` (returning its ``Outputs``) captured into a graph in
    ``pool``. ``warm_up()`` runs first, eagerly on a side stream, so
    that lazy set-up (libraries' handles and workspaces, the kernels'
    modules) stays out of the graph; it must leave the inputs as it
    found them. A sampled body (not ``greedy``) registers ``generator``,
    whose state is as it was before. Unlike ``torch.cuda.graph``, a
    capture neither synchronizes the device nor empties the allocator's
    cache (unless it holds more than ``_CACHE_SLACK`` unused bytes):
    emptied, each warm-up allocated its temporaries from the device
    again, and llama3-1b's 96-graph warmup took ~1.6x as long (NVIDIA
    H100 80GB HBM3, 700 W)."""
    state = generator.get_state()
    dev = torch.cuda.current_device()
    if dev not in _STREAMS:
        _STREAMS[dev] = (torch.cuda.Stream(), torch.cuda.Stream())
    side, cap = _STREAMS[dev]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up()
    cap.wait_stream(side)
    if torch.cuda.memory_reserved() - torch.cuda.memory_allocated() > \
            _CACHE_SLACK:
        torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    if not greedy:
        graph.register_generator_state(generator)
    with capture_tally() as tally:
        with torch.cuda.stream(cap):
            graph.capture_begin(pool)
            try:
                outs = body()
            finally:
                graph.capture_end()
    torch.cuda.current_stream().wait_stream(cap)
    generator.set_state(state)
    return _Graph(graph, outs, tally)


class DecodeGraphs:
    """The decode step runner of one engine (see the module
    docstring)."""

    def __init__(self, params, cfg, kv, batch: int, max_steps: int,
                 write_then_attend: bool, generator: torch.Generator,
                 device: torch.device, use_graphs: bool,
                 num_top: int = 0, mesh=None) -> None:
        self.params, self.cfg, self.kv = params, cfg, kv
        self.mesh = mesh
        self.B, self.wta, self.generator = batch, write_then_attend, generator
        self.device = device
        self.use_graphs = use_graphs
        self.num_top = num_top
        # MLA models count no drop (their routed experts run dense).
        self.count_drops = cfg.is_moe and not cfg.mla
        B = batch
        self.tokens = torch.zeros(B, dtype=torch.int64, device=device)
        self.positions = torch.zeros(B, dtype=torch.int32, device=device)
        self.active = torch.zeros(B, dtype=torch.bool, device=device)
        self.rope_delta = (torch.zeros(B, dtype=torch.int32, device=device)
                           if cfg.is_mrope else None)
        self.tables: Dict[int, torch.Tensor] = {}
        # The packed sampling pair (greedy rows, unseeded) and its views.
        self.samp_f32 = torch.zeros((B, 4), dtype=torch.float32,
                                    device=device)
        self.samp_f32[:, 1] = 1.0
        self.samp_i32 = torch.zeros((B, 2), dtype=torch.int32, device=device)
        self.samp_i32[:, 1] = -1
        self.st = SamplingTensors.unpack(self.samp_f32, self.samp_i32)
        # Bias ids and values by width K; the [B, V] counts, made at the
        # first penalized key.
        self.bias: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.counts: Optional[torch.Tensor] = None
        # Host mirrors of the last upload, compared before the next.
        self._apt_mirror: Optional[Tuple[int, np.ndarray]] = None
        self._st_mirror: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._bias_mirror: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._delta_mirror: Optional[np.ndarray] = None
        self.graphs: Dict[Key, Optional[_Graph]] = {}
        self.pool = (torch.cuda.graph_pool_handle() if use_graphs
                     else None)
        self._host: List[Tuple[Optional[torch.Tensor], ...]] = []
        if device.type == "cuda":
            def pinned(shape, dtype):
                return torch.empty(shape, dtype=dtype, pin_memory=True)
            k = num_top
            self._host = [
                (pinned((max_steps, B), torch.int64),
                 pinned((max_steps, B), torch.float32),
                 pinned((1,), torch.int64),
                 pinned((max_steps, B, k), torch.int64) if k else None,
                 pinned((max_steps, B, k), torch.float32) if k else None)
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

    def bias_buffers(self, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
        buf = self.bias.get(K)
        if buf is None:
            buf = self.bias[K] = (
                torch.zeros((self.B, K), dtype=torch.int64,
                            device=self.device),
                torch.zeros((self.B, K), dtype=torch.float32,
                            device=self.device))
        return buf

    def counts_buffer(self) -> torch.Tensor:
        if self.counts is None:
            self.counts = torch.zeros((self.B, self.cfg.vocab_size),
                                      dtype=torch.int32, device=self.device)
        return self.counts

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

    def stage_sampling(self, packed: Tuple[np.ndarray, np.ndarray]) -> None:
        """Upload the packed pair (``SamplingTensors.pack_batch``) of
        every slot unless it equals the last upload."""
        f32, i32 = packed
        m = self._st_mirror
        if m is not None and np.array_equal(m[0], f32) and \
                np.array_equal(m[1], i32):
            return
        self._upload(self.samp_f32, f32)
        self._upload(self.samp_i32, i32)
        self._st_mirror = (f32.copy(), i32.copy())

    def stage_bias(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Upload the padded logit bias ([B, K] ids and values) into the
        width-K buffers unless it equals their last upload."""
        K = ids.shape[1]
        m = self._bias_mirror.get(K)
        if m is not None and np.array_equal(m[0], ids) and \
                np.array_equal(m[1], vals):
            return
        dst_ids, dst_vals = self.bias_buffers(K)
        self._upload(dst_ids, ids.astype(np.int64))
        self._upload(dst_vals, vals)
        self._bias_mirror[K] = (ids.copy(), vals.copy())

    def stage_rope_delta(self, delta: np.ndarray) -> None:
        """Upload an mrope model's per-slot rope deltas [B] int32 unless
        they equal the last upload."""
        m = self._delta_mirror
        if m is not None and np.array_equal(m, delta):
            return
        self._upload(self.rope_delta, delta.astype(np.int32))
        self._delta_mirror = delta.copy()

    def invalidate_staged(self) -> None:
        """Forget the host mirrors of the last uploads (after a step
        fault): the next step uploads the active mask, table, sampling
        pair, bias and rope deltas whole, into the same buffers."""
        self._apt_mirror = None
        self._st_mirror = None
        self._bias_mirror = {}
        self._delta_mirror = None

    def stage_counts(self, counts: np.ndarray) -> None:
        """Upload a host rebuild of the [B, V] output-token counts."""
        self._upload(self.counts_buffer(), counts)

    def stage_carries(self, tokens: np.ndarray,
                      positions: np.ndarray) -> None:
        self._upload(self.tokens, tokens)
        self._upload(self.positions, positions)

    # ------------------------------------------------------------------
    # The body
    # ------------------------------------------------------------------
    def _body(self, key: Key, steps: Optional[int] = None) -> Outputs:
        """``steps`` (default ``key.steps``) decode forwards from the
        carries; ends by writing the last token and position back into
        them. Returns the [n, B] tokens and logprobs, the [1] MoE drop
        count of the n forwards and the [n, B, k] top logprobs."""
        tok, pos = self.tokens, self.positions
        table = self.tables[key.width]
        bias_ids, bias_vals = self.bias[key.bias_k]
        counts = self.counts if key.penalized else None
        toks, lps, top_ids, top_lps = [], [], [], []
        drops = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                 if self.count_drops else None)
        for _ in range(key.steps if steps is None else steps):
            logits, kv = transformer.forward_decode(
                self.params, self.cfg, tok, pos, self.active, self.kv,
                table, write_then_attend=self.wta, moe_dropped=drops,
                rope_delta=self.rope_delta, mesh=self.mesh)
            if kv[0] is not self.kv[0] or kv[1] is not self.kv[1]:
                raise RuntimeError("forward_decode replaced the KV pools; "
                                   "the writers must write in place")
            # A seeded row's fold-in datum is its input token's position.
            new = sample_packed(logits, self.st, self.generator, key.greedy,
                                key.seeded, pos, counts, bias_ids,
                                bias_vals)
            toks.append(new)
            lps.append(compute_logprobs(logits, new))
            if self.num_top:
                ids, tlp = compute_top_logprobs(logits, self.num_top)
                top_ids.append(ids)
                top_lps.append(tlp)
            if counts is not None:
                update_counts(counts, new, self.active)
            tok, pos = new, pos + 1
        self.tokens.copy_(tok)
        self.positions.copy_(pos)
        return Outputs(torch.stack(toks), torch.stack(lps), drops,
                       torch.stack(top_ids) if top_ids else None,
                       torch.stack(top_lps) if top_lps else None)

    # ------------------------------------------------------------------
    # Capture and launch
    # ------------------------------------------------------------------
    def prepare(self, key) -> Key:
        """Capture ``key``'s graph (on the CPU, or with graphs off, only
        record the key). The staged inputs, the carries and the
        generator's state are as they were before. Returns the key."""
        key = Key(*key)
        if key in self.graphs:
            return key
        if self.warm:
            self.late.append(key)
        self.table(key.width)
        self.bias_buffers(key.bias_k)
        if key.penalized:
            self.counts_buffer()
        if not self.use_graphs:
            self.graphs[key] = None
            return key
        saved = (self.tokens.clone(), self.positions.clone(),
                 self.active.clone())

        def warm_up():
            # Every row inactive: the writers write nothing and the
            # counts take nothing.
            self.active.zero_()
            self._body(key, steps=1)
            for buf, old in zip((self.tokens, self.positions, self.active),
                                saved):
                buf.copy_(old)
        self.graphs[key] = capture(warm_up, lambda: self._body(key),
                                   self.pool, self.generator, key.greedy)
        return key

    def launch(self, key, want_top: bool = False) -> Launch:
        """Run ``key``'s step(s) from the staged inputs: a graph replay,
        or the body eagerly where graphs are off. ``want_top``: copy the
        top logprobs to the host too."""
        key = self.prepare(key)
        g = self.graphs[key]
        self.launches += 1
        self.forwards += key.steps
        if g is None:
            self.eager_steps[program(key)][
                "graphs_off" if self.device.type == "cuda" else "cpu"] += 1
            outs = self._body(key)
        else:
            g.graph.replay()
            count_replay(g.tally)
            g.replays += 1
            outs = g.outs
        want_top = want_top and outs.top_ids is not None
        if not self._host:
            return Launch(key.steps, outs.tokens, outs.logprobs,
                          dropped=outs.dropped,
                          top_ids=outs.top_ids if want_top else None,
                          top_lps=outs.top_lps if want_top else None)
        host_tok, host_lp, host_drop, host_ids, host_tlp = \
            self._host[self._next_host]
        self._next_host ^= 1
        n = key.steps
        host_tok[:n].copy_(outs.tokens, non_blocking=True)
        host_lp[:n].copy_(outs.logprobs, non_blocking=True)
        if outs.dropped is not None:
            host_drop.copy_(outs.dropped, non_blocking=True)
        if want_top:
            host_ids[:n].copy_(outs.top_ids, non_blocking=True)
            host_tlp[:n].copy_(outs.top_lps, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return Launch(n, host_tok, host_lp, event,
                      dropped=host_drop if outs.dropped is not None
                      else None,
                      top_ids=host_ids if want_top else None,
                      top_lps=host_tlp if want_top else None)

    def programs(self) -> Dict[str, Dict[str, object]]:
        """Per program (``decode``, ``decode_multi``): the graphs by key
        with their replays, the captures after warmup and the eager
        steps by reason."""
        def name(k: Key) -> str:
            return f"mp{k.width}_n{k.steps}_{k.suffix()}"
        return program_census(list(self.graphs.items()), PROGRAMS, program,
                              name, list(self.late), self.eager_steps)

    def report(self) -> Dict[str, object]:
        """The census of both programs together."""
        return census_totals(self.programs(), self.use_graphs)


PROGRAMS = ("decode", "decode_multi")


def program(key: Key) -> str:
    """The JAX program a decode key counts under: ``decode`` (one step,
    ``_jit_decode``) or ``decode_multi`` (a fused burst)."""
    return "decode" if key.steps == 1 else "decode_multi"


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


__all__ = ["BIAS_K", "DecodeGraphs", "Key", "Launch", "Outputs", "PROGRAMS",
           "capture", "census_totals", "decode_widths", "program",
           "program_census", "top_rows", "variant"]
