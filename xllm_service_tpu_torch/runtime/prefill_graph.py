"""Prefill and ragged steps through CUDA graphs: the counterpart of the
JAX engine's jitted prefill programs ``_jit_prefill`` (the split and
prefill-first steps) and ``_jit_ragged`` (the ragged mixed step).

One graph per key (kind, B, T, MP, greedy): ``kind`` is ``prefill`` or
``ragged``, B the power-of-two row count, T the prefill bucket, MP the
table width the engine picks for the batch (a power of two of its widest
row, clamped to ``max_pages_per_seq``), ``greedy`` whether no row
samples. Every input of a (B, T, MP) shape lives in one static int32
buffer that the engine fills with one upload before each launch, as the
JAX step packs its header, tokens and table into one array: the rows'
starts and lengths, their sampling parameters (temperature and top-p as
float32 bits, top-k), the [B, T] tokens and the [B, MP] page table. The
whole buffer is written each time, so the rows past the batch are
padding of length 0 with an all-NULL table row: a padding row left from
an earlier, larger batch under the same key would write into another
sequence's pages.

The body is the eager step's: ``forward_prefill`` (the ragged kernel for
``ragged``, else the prefill kernel in the engine's write order), the
packed sampler, each sampled token's logprob. A replay's [B] tokens and
logprobs and its MoE drop count are copied into pinned host buffers
behind a CUDA event. The graphs share the decode runner's memory pool:
no two run at once, and each launch queues its outputs' host copy before
the next replay can reuse the pool's memory.

A capture that fails raises: nothing falls back to eager steps on CUDA.
Steps run eagerly, through the same body and buffers, where graphs are
off (the CPU, ``EngineConfig.cuda_graphs=False``) or a row draws from
its own seeded generator; ``programs()`` counts them under that reason.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.models import transformer
from xllm_service_tpu_torch.ops.kernels._launch import count_replay
from xllm_service_tpu_torch.ops.sampling import (SamplingTensors,
                                                 compute_logprobs,
                                                 sample_packed,
                                                 sample_seeded)
from xllm_service_tpu_torch.runtime.decode_graph import (Seeded, _Graph,
                                                         capture,
                                                         program_census)

Key = Tuple[str, int, int, int, bool]   # (kind, B, T, MP, greedy)
Shape = Tuple[int, int, int]            # (B, T, MP)
KINDS = ("prefill", "ragged")


def layout(B: int, T: int, MP: int) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of each field in a shape's packed int32 buffer."""
    out, off = {}, 0
    for name, n in (("start", B), ("lengths", B), ("temperature", B),
                    ("top_p", B), ("top_k", B), ("tokens", B * T),
                    ("table", B * MP)):
        out[name] = (off, n)
        off += n
    return out


def pack(shape: Shape, rows: Sequence[Tuple[Sequence[int], int,
                                            Sequence[int]]],
         sampling: np.ndarray) -> np.ndarray:
    """The packed buffer of one step: ``rows`` (tokens, start, pages) for
    the live rows, zeros (length 0, NULL pages) past them; ``sampling``
    the [B, 3] ``SamplingTensors.pack_batch`` block of all B rows."""
    B, T, MP = shape
    lay = layout(B, T, MP)
    flat = np.zeros(sum(n for _, n in lay.values()), np.int32)

    def field(name):
        off, n = lay[name]
        return flat[off:off + n]
    start, lengths = field("start"), field("lengths")
    tokens = field("tokens").reshape(B, T)
    table = field("table").reshape(B, MP)
    for i, (toks, st, pages) in enumerate(rows):
        start[i] = st
        lengths[i] = len(toks)
        tokens[i, :len(toks)] = toks
        table[i, :len(pages)] = pages
    field("temperature").view(np.float32)[:] = sampling[:, 0]
    field("top_p").view(np.float32)[:] = sampling[:, 1]
    field("top_k")[:] = sampling[:, 2]
    return flat


class PrefillGraphs:
    """The prefill and ragged step runner of one engine (see the module
    docstring)."""

    def __init__(self, params, cfg, kv, max_rows: int,
                 write_then_attend: bool, generator: torch.Generator,
                 device: torch.device, use_graphs: bool, pool) -> None:
        self.params, self.cfg, self.kv = params, cfg, kv
        self.wta, self.generator = write_then_attend, generator
        self.device = device
        self.use_graphs = use_graphs
        self.pool = pool
        self.count_drops = cfg.is_moe and not cfg.mla
        self.inputs: Dict[Shape, torch.Tensor] = {}
        self.graphs: Dict[Key, Optional[_Graph]] = {}
        self._host: Tuple[torch.Tensor, ...] = ()
        if device.type == "cuda":
            self._host = (
                torch.empty((max_rows,), dtype=torch.int64, pin_memory=True),
                torch.empty((max_rows,), dtype=torch.float32,
                            pin_memory=True),
                torch.empty((1,), dtype=torch.int64, pin_memory=True))
        self.warm = False
        # The keys captured after warmup, and the eager steps by kind.
        self.late: List[Key] = []
        self.eager_steps: Dict[str, Dict[str, int]] = {
            kind: collections.Counter() for kind in KINDS}

    # ------------------------------------------------------------------
    # Static inputs
    # ------------------------------------------------------------------
    def _buffer(self, shape: Shape) -> torch.Tensor:
        buf = self.inputs.get(shape)
        if buf is None:
            n = sum(n for _, n in layout(*shape).values())
            buf = self.inputs[shape] = torch.zeros(
                (n,), dtype=torch.int32, device=self.device)
        return buf

    def stage(self, shape: Shape, flat: np.ndarray) -> None:
        """Upload a step's packed inputs (``pack``) into its shape's
        buffer: one host-to-device copy."""
        src = torch.from_numpy(flat)
        if self.device.type == "cuda":
            # Pinned staging, kept by the caching host allocator until
            # the copy ran.
            self._buffer(shape).copy_(src.pin_memory(), non_blocking=True)
        else:
            self._buffer(shape).copy_(src)

    # ------------------------------------------------------------------
    # The body
    # ------------------------------------------------------------------
    def _body(self, kind: str, B: int, T: int, MP: int, greedy: bool,
              seeded: Optional[Seeded] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """One forward over the staged windows and the sampler; returns
        the [B] tokens, their logprobs and the [1] MoE drop count (None
        where none is counted)."""
        flat = self.inputs[(B, T, MP)]
        lay = layout(B, T, MP)

        def field(name):
            off, n = lay[name]
            return flat[off:off + n]
        st = SamplingTensors(field("temperature").view(torch.float32),
                             field("top_p").view(torch.float32),
                             field("top_k").long())
        drops = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                 if self.count_drops else None)
        ragged = kind == "ragged"
        logits, kv = transformer.forward_prefill(
            self.params, self.cfg, field("tokens").view(B, T).long(),
            field("start"), field("lengths"), self.kv,
            field("table").view(B, MP), ragged=ragged,
            write_then_attend=ragged or self.wta, moe_dropped=drops)
        if kv[0] is not self.kv[0] or kv[1] is not self.kv[1]:
            raise RuntimeError("forward_prefill replaced the KV pools; "
                               "the writers must write in place")
        tokens = sample_packed(logits, st, self.generator, greedy)
        if seeded is not None:
            sample_seeded(tokens, logits, st, seeded.rows, seeded.seeds,
                          seeded.positions)
        return tokens, compute_logprobs(logits, tokens), drops

    # ------------------------------------------------------------------
    # Capture and launch
    # ------------------------------------------------------------------
    def prepare(self, key: Key) -> None:
        """Capture ``key``'s graph (on the CPU, or with graphs off, only
        record the key). The staged inputs and the generator's state are
        as they were before."""
        if key in self.graphs:
            return
        if self.warm:
            self.late.append(key)
        kind, B, T, MP, greedy = key
        flat = self._buffer((B, T, MP))
        if not self.use_graphs:
            self.graphs[key] = None
            return
        saved = flat.clone()

        def warm_up():
            # Every length 0 and every table NULL: the writers write
            # nothing.
            flat.zero_()
            self._body(kind, B, T, MP, greedy)
            flat.copy_(saved)
        self.graphs[key] = capture(
            warm_up, lambda: self._body(kind, B, T, MP, greedy), self.pool,
            self.generator, greedy)

    def launch(self, key: Key, seeded: Optional[Seeded] = None
               ) -> Tuple[List[int], List[float], int]:
        """Run ``key``'s step from the staged inputs (a graph replay, or
        the body eagerly where graphs are off or rows are seeded) and
        read it back: the [B] tokens, their logprobs, the MoE drops."""
        self.prepare(key)
        g = self.graphs[key]
        if g is None or seeded is not None:
            self.eager_steps[key[0]][
                "seeded" if g is not None else
                "graphs_off" if self.device.type == "cuda" else "cpu"] += 1
            tokens, logprobs, dropped = self._body(*key, seeded=seeded)
        else:
            g.graph.replay()
            count_replay(g.tally)
            g.replays += 1
            tokens, logprobs, dropped = g.tokens, g.logprobs, g.dropped
        if not self._host:
            return (tokens.tolist(), logprobs.tolist(),
                    int(dropped[0]) if dropped is not None else 0)
        B = key[1]
        host_tok, host_lp, host_drop = self._host
        host_tok[:B].copy_(tokens, non_blocking=True)
        host_lp[:B].copy_(logprobs, non_blocking=True)
        if dropped is not None:
            host_drop.copy_(dropped, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return (host_tok[:B].tolist(), host_lp[:B].tolist(),
                int(host_drop[0]) if dropped is not None else 0)

    def programs(self) -> Dict[str, Dict[str, object]]:
        """Per program (``prefill``, ``ragged``): the graphs by key with
        their replays, the captures after warmup and the eager steps by
        reason."""
        def name(k: Key) -> str:
            return (f"b{k[1]}_t{k[2]}_mp{k[3]}_"
                    f"{'greedy' if k[4] else 'sampled'}")
        return program_census(list(self.graphs.items()), KINDS,
                              lambda k: k[0], name, list(self.late),
                              self.eager_steps)


def ladder(batch_pows: Sequence[int], buckets: Sequence[int], budget: int,
           page_size: int, extended: bool) -> List[Shape]:
    """The JAX engine's prefill warmup shapes: every (pow2 B, bucket T)
    with (B - 1) + T <= max(budget, T), each at the table widths
    pow2(pages(T)) and pow2(pages(T + 1)) (two where T is page-aligned:
    a fresh T-token window's sampled token takes the next page); only
    the first pair's when not ``extended``."""
    def pow2_pages(n: int) -> int:
        return 1 << max(-(-n // page_size) - 1, 0).bit_length()
    shapes: List[Shape] = []
    for B in batch_pows:
        for T in buckets:
            if (B - 1) + T > max(budget, T):
                continue
            shapes.extend((B, T, mp) for mp in sorted(
                {pow2_pages(T), pow2_pages(T + 1)}))
            if not extended:
                return shapes
    return shapes


__all__ = ["KINDS", "PrefillGraphs", "ladder", "layout", "pack"]
