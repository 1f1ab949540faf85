"""Prefill and ragged steps through CUDA graphs: the counterpart of the
JAX engine's jitted prefill programs ``_jit_prefill`` (the split and
prefill-first steps), ``_jit_prefill_plp`` (a prefill that also scores
its window's prompt tokens, for ``echo`` with ``logprobs``) and
``_jit_ragged`` (the ragged mixed step).

One graph per key (``Key``: kind, B, T, MP, the sampling variant, the
``logit_bias`` width K, ``plp``, ``mm``): ``kind`` is ``prefill`` or
``ragged``, B the power-of-two row count, T the prefill bucket, MP the table width
the engine picks for the batch (a power of two of its widest row,
clamped to ``max_pages_per_seq``), then whether no row samples, whether
some sampled row is seeded, K, and whether the window's prompt tokens
are scored (B = 1, captured at its first use, as the JAX engine compiles
``_jit_prefill_plp`` lazily), and whether vision embeddings splice over
the window's token embeddings (``mm``: every key of an mrope model, a
batch carrying an image on any other). Every input of an input shape
(B, T, MP, K, plp, mm) lives in one static int32 buffer that the engine
fills with one upload before each launch, as the JAX step packs its header, tokens and
table into one array: the rows' starts and lengths, the packed sampling
pair (float32 [B, 4] as bits, int32 [B, 2]), the bias ids and values
[B, K] (zeros when unused), the [B, T] tokens, the [B, MP] page table
and, for ``plp``, the [B, T] targets (the prompt token after each window
position), for ``mm`` the [B, T] splice index (the row of the runner's
embedding buffer a window position takes, -1 for none) and, for an
mrope model, the window's [B, 3, T] rope position streams. The
embedding rows themselves go into one [mm_cap, D] buffer that every
``mm`` key reads (``stage_mm``; under a mesh rank 0 sends them to every
rank in one tensor broadcast, outside the step header). The whole
buffer is written each time, so the rows past the batch are padding of
length 0 with an all-NULL table row: a padding row left from an earlier, larger batch under the same key would write into
another sequence's pages.

The body is the eager step's: ``forward_prefill`` (the ragged kernel for
``ragged``, else the prefill kernel in the engine's write order), the
packed sampler with the bias (no penalties: the JAX prefill and ragged
programs take no counts), a seeded row's noise by threefry from (seed,
start + length - 1), each sampled token's logprob and the top logprobs
(k = ``EngineConfig.num_top_logprobs``). A replay's [B] tokens and
logprobs and its MoE drop count are copied into pinned host buffers
behind a CUDA event. The graphs share the decode runner's memory pool:
no two run at once, and each launch queues its outputs' host copy
before the next replay can reuse the pool's memory.

A ``prefill_ring`` key (one row, T a multiple of the mesh's sp size,
from position 0) runs ``forward_prefill_ring`` over the same packed
buffer, eagerly: it exists only under a mesh, whose steps run eager
(``runtime/engine.py``); ``programs()`` counts it under its own kind
where the runner was made with ``ring``.

A capture that fails raises: nothing falls back to eager steps on CUDA.
Steps run eagerly, through the same body and buffers, only where graphs
are off (the CPU, ``EngineConfig.cuda_graphs=False``); ``programs()``
counts them under that reason.
"""

from __future__ import annotations

import collections
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple)

import numpy as np
import torch

from xllm_service_tpu_torch.models import transformer
from xllm_service_tpu_torch.ops.kernels._launch import count_replay
from xllm_service_tpu_torch.ops.sampling import (SamplingTensors,
                                                 compute_logprobs,
                                                 compute_top_logprobs,
                                                 sample_packed)
from xllm_service_tpu_torch.runtime.decode_graph import (
    BIAS_K, Outputs, _Graph, capture, program_census, top_rows, variant)

Shape = Tuple[int, int, int]            # (B, T, MP)
InShape = Tuple[int, int, int, int, bool, bool]   # (B, T, MP, K, plp, mm)
KINDS = ("prefill", "ragged")
RING = "prefill_ring"


class Key(NamedTuple):
    """A prefill or ragged graph's key."""
    kind: str
    B: int
    T: int
    MP: int
    greedy: bool                        # no row samples
    seeded: bool = False                # some sampled row has a seed
    bias_k: int = BIAS_K                # logit-bias columns
    plp: bool = False                   # scores the window's prompt
    mm: bool = False                    # splices vision embeddings

    @property
    def in_shape(self) -> InShape:
        return (self.B, self.T, self.MP, self.bias_k, self.plp, self.mm)


class Result(NamedTuple):
    """One launch read back: the [B] tokens and logprobs, the MoE drops,
    each row's top entries (None unless asked for) and the [B, T] prompt
    logprobs (``plp`` keys only)."""
    tokens: List[int]
    logprobs: List[float]
    dropped: int
    tops: Optional[List[List[Dict[str, float]]]] = None
    prompt_lps: Optional[List[List[float]]] = None


def _in_shape(shape) -> InShape:
    """An input shape from (B, T, MP) (bias width ``BIAS_K``, no
    targets, no splice), (B, T, MP, K, plp) or the whole (B, T, MP, K,
    plp, mm)."""
    shape = tuple(shape)
    if len(shape) == 3:
        return (*shape, BIAS_K, False, False)
    return shape if len(shape) == 6 else (*shape, False)


def layout(B: int, T: int, MP: int, K: int = BIAS_K, plp: bool = False,
           mm: bool = False, mrope: bool = False
           ) -> Dict[str, Tuple[int, int]]:
    """(offset, length) of each field in a shape's packed int32 buffer
    (``mrope``: the model's, which adds the rope position streams)."""
    out, off = {}, 0
    fields = [("start", B), ("lengths", B), ("f32", B * 4), ("i32", B * 2),
              ("bias_ids", B * K), ("bias_vals", B * K),
              ("tokens", B * T), ("table", B * MP)]
    if plp:
        fields.append(("targets", B * T))
    if mm:
        fields.append(("mm_index", B * T))
    if mrope:
        fields.append(("rope_pos", B * 3 * T))
    for name, n in fields:
        out[name] = (off, n)
        off += n
    return out


def pack(shape: Shape, rows: Sequence[Tuple[Sequence[int], int,
                                            Sequence[int]]],
         sampling: Tuple[np.ndarray, np.ndarray],
         bias: Optional[Tuple[np.ndarray, np.ndarray]] = None,
         targets: Optional[np.ndarray] = None,
         mm_index: Optional[np.ndarray] = None,
         rope_pos: Optional[np.ndarray] = None) -> np.ndarray:
    """The packed buffer of one step: ``rows`` (tokens, start, pages) for
    the live rows, zeros (length 0, NULL pages) past them; ``sampling``
    the ``SamplingTensors.pack_batch`` pair of all B rows; ``bias`` the
    [B, K] ids and values (None: K = ``BIAS_K`` zeros); ``targets`` the
    [B, T] prompt-score targets of a ``plp`` step; ``mm_index`` the
    [B, T] splice index of an ``mm`` step; ``rope_pos`` an mrope model's
    [B, 3, T] position streams."""
    B, T, MP = shape[:3]
    K = BIAS_K if bias is None else bias[0].shape[1]
    lay = layout(B, T, MP, K, targets is not None, mm_index is not None,
                 rope_pos is not None)
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
    f32, i32 = sampling
    field("f32").view(np.float32)[:] = f32.reshape(-1)
    field("i32")[:] = i32.reshape(-1)
    if bias is not None:
        field("bias_ids")[:] = bias[0].reshape(-1)
        field("bias_vals").view(np.float32)[:] = bias[1].reshape(-1)
    if targets is not None:
        field("targets")[:] = targets.reshape(-1)
    if mm_index is not None:
        field("mm_index")[:] = mm_index.reshape(-1)
    if rope_pos is not None:
        field("rope_pos")[:] = rope_pos.reshape(-1)
    return flat


class PrefillGraphs:
    """The prefill and ragged step runner of one engine (see the module
    docstring)."""

    def __init__(self, params, cfg, kv, max_rows: int,
                 write_then_attend: bool, generator: torch.Generator,
                 device: torch.device, use_graphs: bool, pool,
                 num_top: int = 0, mm_cap: int = 0, mesh=None,
                 ring: bool = False) -> None:
        self.params, self.cfg, self.kv = params, cfg, kv
        self.mesh = mesh
        self.kinds = KINDS + ((RING,) if ring else ())
        # Every key of an mrope model splices (and carries rope streams).
        self.mrope = cfg.is_mrope
        self.mm_cap = mm_cap
        self.mm_rows: Optional[torch.Tensor] = None
        self.wta, self.generator = write_then_attend, generator
        self.device = device
        self.use_graphs = use_graphs
        self.pool = pool
        self.num_top = num_top
        self.count_drops = cfg.is_moe and not cfg.mla
        self.inputs: Dict[InShape, torch.Tensor] = {}
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
            kind: collections.Counter() for kind in self.kinds}

    # ------------------------------------------------------------------
    # Static inputs
    # ------------------------------------------------------------------
    def _layout(self, shape) -> Dict[str, Tuple[int, int]]:
        return layout(*_in_shape(shape), mrope=self.mrope)

    def _buffer(self, shape) -> torch.Tensor:
        shape = _in_shape(shape)
        buf = self.inputs.get(shape)
        if buf is None:
            n = sum(n for _, n in self._layout(shape).values())
            buf = self.inputs[shape] = torch.zeros(
                (n,), dtype=torch.int32, device=self.device)
        return buf

    def stage(self, shape, flat: np.ndarray) -> None:
        """Upload a step's packed inputs (``pack``) into the buffer of
        its input shape ((B, T, MP), or (B, T, MP, K, plp)): one
        host-to-device copy."""
        src = torch.from_numpy(flat)
        if self.device.type == "cuda":
            # Pinned staging, kept by the caching host allocator until
            # the copy ran.
            self._buffer(shape).copy_(src.pin_memory(), non_blocking=True)
        else:
            self._buffer(shape).copy_(src)

    def _mm_buffer(self) -> torch.Tensor:
        if self.mm_rows is None:
            self.mm_rows = torch.zeros(
                (max(self.mm_cap, 1), self.cfg.hidden_size),
                dtype=self.params["embed"].dtype, device=self.device)
        return self.mm_rows

    @staticmethod
    def header(attr: str, args, kwargs):
        """What of a mirrored call the followers get in the step header:
        ``stage_mm``'s rows travel in a tensor broadcast of their own
        (the header carries their shape); every other call whole."""
        if attr != "stage_mm":
            return args, kwargs
        rows = args[0] if args else kwargs["rows"]
        return (), {"shape": tuple(np.shape(rows))}

    def stage_mm(self, rows: Optional[np.ndarray] = None,
                 shape: Optional[Tuple[int, int]] = None) -> None:
        """Upload a step's spliced embedding rows [n, D] (float32) into
        the head of the shared embedding buffer, which the staged
        ``mm_index`` points into. Under a mesh every rank needs the
        whole rows (the hidden state is replicated over tp): rank 0
        passes them and broadcasts them over the world; a follower
        passes their ``shape`` and receives them."""
        n = len(rows) if rows is not None else shape[0]
        if n > self.mm_cap:
            raise ValueError(f"{n} spliced rows exceed the "
                             f"buffer's {self.mm_cap}")
        if not n:
            return
        dst = self._mm_buffer()[:n]
        if self.mesh is not None and self.mesh.world > 1:
            src = None if rows is None else torch.from_numpy(
                np.ascontiguousarray(rows, np.float32))
            dst.copy_(self.mesh.broadcast(
                src, (n, self.cfg.hidden_size), torch.float32, self.device))
            return
        src = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        if self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    # ------------------------------------------------------------------
    # The body
    # ------------------------------------------------------------------
    def _body(self, key: Key) -> Outputs:
        """One forward over the staged windows and the sampler; returns
        the [B] tokens, their logprobs, the [1] MoE drop count (None
        where none is counted), the [B, k] top logprobs and, for a
        ``plp`` key, the [B, T] prompt logprobs."""
        B, T, K = key.B, key.T, key.bias_k
        flat = self.inputs[key.in_shape]
        lay = self._layout(key.in_shape)

        def field(name):
            off, n = lay[name]
            return flat[off:off + n]
        st = SamplingTensors.unpack(
            field("f32").view(torch.float32).view(B, 4),
            field("i32").view(B, 2))
        drops = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                 if self.count_drops else None)
        start, lengths = field("start"), field("lengths")
        if key.kind == RING:
            res = transformer.forward_prefill_ring(
                self.params, self.cfg, field("tokens").view(B, T).long(),
                lengths, self.kv, field("table").view(B, key.MP), self.mesh,
                moe_dropped=drops)
        else:
            res = self._forward(key, field, drops)
        logits, kv = res[0], res[1]
        if kv[0] is not self.kv[0] or kv[1] is not self.kv[1]:
            raise RuntimeError("forward_prefill replaced the KV pools; "
                               "the writers must write in place")
        # A seeded row's fold-in datum: its last window token's position.
        positions = start + (lengths - 1).clamp(min=0)
        tokens = sample_packed(
            logits, st, self.generator, key.greedy, key.seeded, positions,
            None, field("bias_ids").view(B, K),
            field("bias_vals").view(torch.float32).view(B, K))
        top_ids = top_lps = None
        if self.num_top:
            top_ids, top_lps = compute_top_logprobs(logits, self.num_top)
        return Outputs(tokens, compute_logprobs(logits, tokens), drops,
                       top_ids, top_lps, res[2] if key.plp else None)

    def _forward(self, key: Key, field, drops):
        """The prefill or ragged forward of ``key`` over the staged
        fields."""
        B, T = key.B, key.T
        ragged = key.kind == "ragged"
        return transformer.forward_prefill(
            self.params, self.cfg, field("tokens").view(B, T).long(),
            field("start"), field("lengths"), self.kv, field("table").view(B, key.MP),
            ragged=ragged, write_then_attend=ragged or self.wta,
            moe_dropped=drops,
            prompt_lp_targets=(field("targets").view(B, T) if key.plp
                               else None),
            mm_embeds=self._mm_buffer() if key.mm else None,
            mm_index=field("mm_index").view(B, T) if key.mm else None,
            rope_pos=(field("rope_pos").view(B, 3, T) if self.mrope
                      else None),
            mesh=self.mesh)

    # ------------------------------------------------------------------
    # Capture and launch
    # ------------------------------------------------------------------
    def prepare(self, key) -> Key:
        """Capture ``key``'s graph (on the CPU, or with graphs off, only
        record the key). The staged inputs and the generator's state are
        as they were before. Returns the key (``mm`` set for an mrope
        model)."""
        key = Key(*key)
        if self.mrope and not key.mm:
            key = key._replace(mm=True)
        if key in self.graphs:
            return key
        if self.warm:
            self.late.append(key)
        flat = self._buffer(key.in_shape)
        if not self.use_graphs:
            self.graphs[key] = None
            return key
        saved = flat.clone()

        def warm_up():
            # Every length 0 and every table NULL: the writers write
            # nothing.
            flat.zero_()
            self._body(key)
            flat.copy_(saved)
        self.graphs[key] = capture(warm_up, lambda: self._body(key),
                                   self.pool, self.generator, key.greedy)
        return key

    def launch(self, key, want_top: bool = False) -> Result:
        """Run ``key``'s step from the staged inputs (a graph replay, or
        the body eagerly where graphs are off) and read it back.
        ``want_top``: read the top logprobs too."""
        key = self.prepare(key)
        g = self.graphs[key]
        if g is None:
            self.eager_steps[key.kind][
                "graphs_off" if self.device.type == "cuda" else "cpu"] += 1
            outs = self._body(key)
        else:
            g.graph.replay()
            count_replay(g.tally)
            g.replays += 1
            outs = g.outs
        B = key.B
        if self._host:
            host_tok, host_lp, host_drop = self._host
            host_tok[:B].copy_(outs.tokens, non_blocking=True)
            host_lp[:B].copy_(outs.logprobs, non_blocking=True)
            if outs.dropped is not None:
                host_drop.copy_(outs.dropped, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
            toks, lps, drop = host_tok[:B], host_lp[:B], host_drop
        else:
            toks, lps, drop = outs.tokens, outs.logprobs, outs.dropped
        tops = None
        if want_top and outs.top_ids is not None:
            tops = top_rows(outs.top_ids.tolist(), outs.top_lps.tolist())
        return Result(toks.tolist(), lps.tolist(),
                      int(drop[0]) if outs.dropped is not None else 0,
                      tops,
                      outs.prompt_lps.tolist() if key.plp else None)

    def programs(self) -> Dict[str, Dict[str, object]]:
        """Per program (``prefill``, ``ragged``): the graphs by key with
        their replays, the captures after warmup and the eager steps by
        reason."""
        def name(k: Key) -> str:
            return (f"b{k.B}_t{k.T}_mp{k.MP}_"
                    f"{variant(k.greedy, k.seeded, False, k.bias_k)}"
                    + ("_echo" if k.plp else "") + ("_mm" if k.mm else ""))
        return program_census(list(self.graphs.items()), self.kinds,
                              lambda k: k.kind, name, list(self.late),
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


__all__ = ["KINDS", "Key", "PrefillGraphs", "Result", "ladder", "layout",
           "pack"]
