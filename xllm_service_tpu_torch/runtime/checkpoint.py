"""HF safetensors checkpoint <-> the stacked-[L, ...] parameter dict.

The counterpart of the JAX package's ``runtime/checkpoint.py`` for the
text stacks. A HuggingFace model directory (``config.json`` and
``*.safetensors`` shards, with ``model.safetensors.index.json`` when
sharded) maps into the layout of ``models/transformer.py``: per-layer
weights stacked over a leading [L] axis, every 2-D projection transposed
from torch's ``[out, in]`` into ``x @ W``'s ``[in, out]``, Mixtral's and
Qwen3-MoE's per-expert weights stacked into ``[L, E, ...]``, Phi-3's
fused projections split, Gemma's ``(1 + w)`` norms folded, GPT-OSS's
interleaved ``gate_up`` columns split (from bf16 or MXFP4 storage), and
DeepSeek's MLA tree split into its dense prefix and MoE suffix stacks.
A Qwen2-VL or Qwen2.5-VL directory's vision tower (``visual.*``) maps
into ``models/qwen2vl_vision.py``'s tree (``load_qwen2vl_vision``; the
Conv3D patch kernel flattened into one matmul) and back
(``save_qwen2vl_vision``).

The safetensors format is read and written here with the standard
library and torch alone (no ``safetensors``, ``ml_dtypes`` or numpy
bfloat16): an 8-byte little-endian header length, a JSON header giving
each tensor's ``dtype``, ``shape`` and ``data_offsets`` (and an optional
``__metadata__``), then the raw little-endian bytes. A file is mapped
with ``mmap`` and each tensor is a ``torch.frombuffer`` view of it, read
from disk when touched.

Loading goes one stacked group at a time: its destination is allocated
on the target device and filled layer by layer (each layer's tensor
moved to the device, transposed and cast there), so the host holds one
tensor of the file at a time on top of the mapping, never a widened
copy of the model.
"""

from __future__ import annotations

import glob
import hashlib
import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from xllm_service_tpu_torch.config import ModelConfig

Params = Dict[str, Any]

# The format's dtype names.
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# The safetensors format
# ---------------------------------------------------------------------------

class SafetensorsFile:
    """One ``.safetensors`` file, mapped: ``get(name)`` is a CPU tensor
    viewing the file's bytes (copy-on-write: writing to it never
    reaches the file)."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size > 8 + n else None)
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__",
                                                             None)
        self._entries: Dict[str, Dict[str, Any]] = header
        self._base = 8 + n

    def keys(self) -> List[str]:
        return list(self._entries)

    def nbytes(self, name: str) -> int:
        lo, hi = self._entries[name]["data_offsets"]
        return hi - lo

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = _DTYPES[e["dtype"]]
        lo, hi = e["data_offsets"]
        shape = tuple(e["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        count = (hi - lo) // size
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        start = self._base + lo
        if start % size:
            # A foreign writer left the tensor unaligned: copy it out.
            return torch.frombuffer(bytearray(self._mm[start:start + hi - lo]),
                                    dtype=dtype).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dtype, count=count,
                                offset=start).reshape(shape)

    def close(self) -> None:
        # Views still alive keep the mapping; it goes with the last one.
        self._mm = None


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes in row-major order, on the host."""
    # Made contiguous where it lies (a transpose on the card is one
    # kernel, on the host a strided copy), then copied out.
    flat = t.detach().contiguous().reshape(-1).to("cpu")
    if flat.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    return memoryview(flat.numpy())


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; views allowed) as one safetensors
    file, one tensor's bytes at a time. Tensors go in the order the
    ``safetensors`` package writes them (wider elements first, then by
    name), so every tensor starts aligned to its element size. Returns
    the bytes of tensor data written."""
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, Any] = {}
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    off = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for _, t in items:
            if t.numel():
                f.write(_raw_bytes(t))
    return off


class ShardedReader:
    """Lazy tensor access across a directory's safetensors shards (the
    index's weight map when there is one); counts the bytes of the
    tensors it hands out, each once (``bytes_read``)."""

    def __init__(self, model_dir: str) -> None:
        files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {model_dir!r}")
        self._files: Dict[str, SafetensorsFile] = {}
        self._index: Dict[str, str] = {}
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path, "r", encoding="utf-8") as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self._index[name] = os.path.join(model_dir, fname)
        else:
            for path in files:
                for name in self._open(path).keys():
                    self._index[name] = path
        self.bytes_read = 0
        self._seen: set = set()

    def _open(self, path: str) -> SafetensorsFile:
        h = self._files.get(path)
        if h is None:
            h = self._files[path] = SafetensorsFile(path)
        return h

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def get(self, name: str) -> torch.Tensor:
        h = self._open(self._index[name])
        if name not in self._seen:
            self._seen.add(name)
            self.bytes_read += h.nbytes(name)
        return h.get(name)

    def close(self) -> None:
        for h in self._files.values():
            h.close()
        self._files.clear()


class _PrefixRemap:
    """Key-prefix indirection over a ShardedReader (text stacks nested
    under model.language_model.* in VLM checkpoints)."""

    def __init__(self, inner: ShardedReader, old: str, new: str) -> None:
        self._inner, self._old, self._new = inner, old, new

    def _map(self, name: str) -> str:
        return self._new + name[len(self._old):] \
            if name.startswith(self._old) else name

    def get(self, name: str) -> torch.Tensor:
        return self._inner.get(self._map(name))

    def __contains__(self, name: str) -> bool:
        return self._map(name) in self._inner

    @property
    def bytes_read(self) -> int:
        return self._inner.bytes_read

    def close(self) -> None:
        self._inner.close()


# ---------------------------------------------------------------------------
# MXFP4
# ---------------------------------------------------------------------------

# The 16 MXFP4 (E2M1) code points in low-nibble index order (the OCP
# Microscaling table; GPT-OSS checkpoints ship their experts in it).
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
               -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e exactly, as float32, for int32 ``e`` in [-126, 127]: the
    exponent field written directly."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def dequant_mxfp4(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """MXFP4 block dequantization, on the tensors' device.

    ``blocks`` [..., G, B] uint8, each byte two E2M1 codes, the LOW
    nibble first; ``scales`` [..., G] uint8, E8M0 shared exponents
    (value 2**(s - 127)) per block of 2B values. Returns [..., G * 2B]
    float32, bit-equal to the JAX package's ``np.ldexp`` of the table:
    the scale is applied as two exact powers of two (each within the
    normal range), so the only rounding is the one ``ldexp`` makes,
    to infinity past the largest float32."""
    lut = torch.tensor(_FP4_VALUES, dtype=torch.float32, device=blocks.device)
    codes = blocks.to(torch.int64)
    vals = torch.stack([lut[codes & 0x0F], lut[codes >> 4]], dim=-1)
    vals = vals.reshape(blocks.shape[:-1] + (blocks.shape[-1] * 2,))
    e = scales.to(torch.int32) - 127
    e1 = torch.div(e, 2, rounding_mode="floor")
    vals = vals * _pow2(e1)[..., None] * _pow2(e - e1)[..., None]
    return vals.reshape(blocks.shape[:-2] + (-1,))


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

class _Stacker:
    """Fills stacked destinations on ``device`` one layer at a time from
    a reader; each source tensor moves to the device, then is
    transposed, sliced and cast there."""

    def __init__(self, r, device, dtype: torch.dtype) -> None:
        self.r, self.device, self.dtype = r, torch.device(device), dtype

    def get(self, name: str) -> torch.Tensor:
        return self.r.get(name).to(self.device)

    def stack(self, fmt: str, idxs: Iterable[int], transpose: bool = False,
              dtype: Optional[torch.dtype] = None,
              fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
        """Layer ``i``'s ``fmt.format(i=i)`` for each of ``idxs``, stacked
        (``fn`` applied to each first, then the transpose)."""
        idxs = list(idxs)
        out = None
        for j, i in enumerate(idxs):
            t = self.get(fmt.format(i=i))
            if fn is not None:
                t = fn(t)
            if transpose:
                t = t.t()
            if out is None:
                out = torch.empty((len(idxs),) + tuple(t.shape),
                                  dtype=dtype or self.dtype,
                                  device=self.device)
            out[j].copy_(t)
        return out

    def empty(self, *shape, dtype: Optional[torch.dtype] = None):
        return torch.empty(shape, dtype=dtype or self.dtype,
                           device=self.device)


def _open_reader(model_dir: str):
    r = ShardedReader(model_dir)
    # VLM checkpoints may nest the text stack (current transformers
    # writes model.language_model.*; published Qwen2-VL keeps model.*).
    if "model.embed_tokens.weight" not in r \
            and "model.language_model.embed_tokens.weight" in r:
        return _PrefixRemap(r, "model.", "model.language_model.")
    return r


def load_checkpoint(model_dir: str, cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None,
                    stats: Optional[Dict[str, float]] = None) -> Params:
    """Load a HF checkpoint directory into the transformer's parameter
    dict on ``device`` (required, as for ``init_params``: the host only
    when a caller names it), cast to ``dtype`` (default ``cfg.dtype``;
    the sink logits and router biases stay float32). ``stats``, if
    given, receives ``bytes_read``."""
    r = _open_reader(model_dir)
    dtype = dtype or getattr(torch, cfg.dtype)
    s = _Stacker(r, device, dtype)
    try:
        params = (_load_mla(s, cfg) if cfg.mla else _load_dense(s, cfg))
    finally:
        if stats is not None:
            stats["bytes_read"] = r.bytes_read
        r.close()
    return params


def _load_dense(s: _Stacker, cfg: ModelConfig) -> Params:
    r = s.r
    L = range(cfg.num_layers)
    f32 = torch.float32

    def fold(t: torch.Tensor) -> torch.Tensor:
        """Norm weights; Gemma checkpoints store w for (1 + w) * x_hat:
        the +1 is folded in float32, then cast (save subtracts it)."""
        t = t.to(f32)
        return t + 1.0 if cfg.gemma else t

    def stack_norm(fmt: str) -> torch.Tensor:
        return s.stack(fmt, L, fn=fold)

    A = "model.layers.{i}.self_attn."
    M = "model.layers.{i}.mlp."
    layers: Dict[str, torch.Tensor] = {
        "input_norm": stack_norm("model.layers.{i}.input_layernorm.weight"),
        "post_norm": stack_norm(
            "model.layers.{i}.post_attention_layernorm.weight"),
        "o_proj": s.stack(A + "o_proj.weight", L, transpose=True),
    }
    if cfg.gemma:
        layers["pre_ff_norm"] = stack_norm(
            "model.layers.{i}.pre_feedforward_layernorm.weight")
        layers["post_ff_norm"] = stack_norm(
            "model.layers.{i}.post_feedforward_layernorm.weight")

    def split_stack(fmt: str, bounds) -> List[torch.Tensor]:
        """Phi-3's fused rows ([q | k | v], [gate | up]) split into the
        separate projections, each transposed."""
        outs = []
        lo = 0
        for n in bounds:
            outs.append(s.stack(fmt, L, transpose=True,
                                fn=lambda t, lo=lo, n=n: t[lo:lo + n]))
            lo += n
        return outs

    if cfg.fused_proj:
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        layers["q_proj"], layers["k_proj"], layers["v_proj"] = \
            split_stack(A + "qkv_proj.weight", (nq, nkv, nkv))
    else:
        for nm in ("q_proj", "k_proj", "v_proj"):
            layers[nm] = s.stack(A + nm + ".weight", L, transpose=True)
    if cfg.attention_bias:
        for nm in ("q", "k", "v"):
            layers[nm + "_bias"] = s.stack(A + nm + "_proj.bias", L)
        if A.format(i=0) + "o_proj.bias" in r:
            layers["o_bias"] = s.stack(A + "o_proj.bias", L)
    if cfg.gptoss:
        layers["sinks"] = s.stack(A + "sinks", L, dtype=f32)
    if cfg.qk_norm:
        # fold is the identity without Gemma (qwen3).
        layers["q_norm"] = stack_norm(A + "q_norm.weight")
        layers["k_norm"] = stack_norm(A + "k_norm.weight")
    if cfg.gptoss:
        layers.update(_load_gptoss_experts(s, cfg))
    elif cfg.is_moe:
        # Two expert-key dialects: Qwen3-MoE (mlp.experts.N.*_proj +
        # mlp.gate) and Mixtral (block_sparse_moe.experts.N.w1/w3/w2 +
        # block_sparse_moe.gate).
        X = M if cfg.qwen_moe else "model.layers.{i}.block_sparse_moe."
        layers["router"] = s.stack(X + "gate.weight", L, transpose=True)
        names = (("gate_proj", "gate_proj"), ("up_proj", "up_proj"),
                 ("down_proj", "down_proj")) if cfg.qwen_moe else \
            (("gate_proj", "w1"), ("up_proj", "w3"), ("down_proj", "w2"))
        for ours, hf in names:
            layers[ours] = _stack_experts(s, X, hf, L, cfg.num_experts)
    elif cfg.fused_proj:
        layers["gate_proj"], layers["up_proj"] = split_stack(
            M + "gate_up_proj.weight",
            (cfg.intermediate_size, cfg.intermediate_size))
        layers["down_proj"] = s.stack(M + "down_proj.weight", L,
                                      transpose=True)
    else:
        for nm in ("gate_proj", "up_proj", "down_proj"):
            layers[nm] = s.stack(M + nm + ".weight", L, transpose=True)

    final = fold(s.get("model.norm.weight")).to(s.dtype)
    params: Params = {"embed": s.get("model.embed_tokens.weight").to(s.dtype),
                      "layers": layers, "final_norm": final}
    _load_head(s, cfg, params)
    return params


def _stack_experts(s: _Stacker, X: str, hf: str, idxs, E: int
                   ) -> torch.Tensor:
    """[L, E, in, out]: each expert's ``experts.N.<hf>.weight``,
    transposed."""
    idxs = list(idxs)
    out = None
    for j, i in enumerate(idxs):
        for e in range(E):
            t = s.get(X.format(i=i) + f"experts.{e}.{hf}.weight").t()
            if out is None:
                out = s.empty(len(idxs), E, *t.shape)
            out[j, e].copy_(t)
    return out


def _load_gptoss_experts(s: _Stacker, cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """GPT-OSS's stacked experts: fused ``gate_up`` with interleaved
    columns (gate even, up odd) and per-expert biases, in bf16 storage
    ([E, D, 2F] and [E, F, D], already ``x @ W``) or MXFP4 storage
    (``*_blocks`` / ``*_scales`` [E, out_rows, in / 32, 16], dequantized
    on the device, then transposed as the HF dequantizer does); the
    router with its float32 bias."""
    r, L = s.r, range(cfg.num_layers)
    X = "model.layers.{i}.mlp."
    mxfp4 = X.format(i=0) + "experts.gate_up_proj_blocks" in r
    out = {"router": s.stack(X + "router.weight", L, transpose=True),
           "router_bias": s.stack(X + "router.bias", L,
                                  dtype=torch.float32)}
    for j in L:
        E_ = X.format(i=j) + "experts."
        if mxfp4:
            g_up = dequant_mxfp4(s.get(E_ + "gate_up_proj_blocks"),
                                 s.get(E_ + "gate_up_proj_scales")
                                 ).transpose(1, 2)          # [E, D, 2F]
            dn = dequant_mxfp4(s.get(E_ + "down_proj_blocks"),
                               s.get(E_ + "down_proj_scales")
                               ).transpose(1, 2)            # [E, F, D]
        else:
            g_up = s.get(E_ + "gate_up_proj")
            dn = s.get(E_ + "down_proj")
        g_upb = s.get(E_ + "gate_up_proj_bias")             # [E, 2F]
        dnb = s.get(E_ + "down_proj_bias")                  # [E, D]
        for name, t in (("gate_proj", g_up[..., 0::2]),
                        ("up_proj", g_up[..., 1::2]), ("down_proj", dn),
                        ("gate_bias", g_upb[..., 0::2]),
                        ("up_bias", g_upb[..., 1::2]), ("down_bias", dnb)):
            if name not in out:
                out[name] = s.empty(cfg.num_layers, *t.shape)
            out[name][j].copy_(t)
        del g_up, dn
    return out


def _load_head(s: _Stacker, cfg: ModelConfig, params: Params) -> None:
    if cfg.tie_word_embeddings:
        return
    if "lm_head.weight" in s.r:
        t = s.get("lm_head.weight").t()
        params["lm_head"] = s.empty(*t.shape)
        params["lm_head"].copy_(t)
    else:
        # Checkpoints that tie without saying so in config.json.
        params["lm_head"] = params["embed"].t().contiguous()


def _load_mla(s: _Stacker, cfg: ModelConfig) -> Params:
    """DeepSeek-V2/V3: MLA attention blocks split into a dense-MLP prefix
    stack (``first_k_dense_replace`` layers, ``layers``) and a MoE suffix
    stack (routed and shared experts, ``layers_moe``), the layout of
    ``transformer._init_mla_params``. ``kv_b_proj`` splits into the
    absorbed halves kv_b_k [Hq, nope, r] / kv_b_v [Hq, v, r]."""
    Hq, D = cfg.num_heads, cfg.hidden_size
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    k_dense = cfg.first_k_dense_replace if cfg.is_moe else cfg.num_layers
    A = "model.layers.{i}.self_attn."
    M = "model.layers.{i}.mlp."

    def attn_block(idxs) -> Dict[str, torch.Tensor]:
        blk = {
            "input_norm": s.stack("model.layers.{i}.input_layernorm.weight",
                                  idxs),
            "post_norm": s.stack(
                "model.layers.{i}.post_attention_layernorm.weight", idxs),
            "kv_a": s.stack(A + "kv_a_proj_with_mqa.weight", idxs, True),
            "kv_a_norm": s.stack(A + "kv_a_layernorm.weight", idxs),
            "o_proj": s.stack(A + "o_proj.weight", idxs, True),
        }
        kv_b = A + "kv_b_proj.weight"                       # [Hq*(n+v), r]
        blk["kv_b_k"] = s.stack(
            kv_b, idxs, fn=lambda w: w.reshape(Hq, nope + vd, lora)[:, :nope])
        blk["kv_b_v"] = s.stack(
            kv_b, idxs, fn=lambda w: w.reshape(Hq, nope + vd, lora)[:, nope:])
        if cfg.q_lora_rank:
            blk["q_a"] = s.stack(A + "q_a_proj.weight", idxs, True)
            blk["q_a_norm"] = s.stack(A + "q_a_layernorm.weight", idxs)
            blk["q_b"] = s.stack(A + "q_b_proj.weight", idxs, True)
        else:
            blk["q_proj"] = s.stack(A + "q_proj.weight", idxs, True)
        return blk

    dense_idx = list(range(k_dense))
    if dense_idx:
        dense = attn_block(dense_idx)
        for nm in ("gate_proj", "up_proj", "down_proj"):
            dense[nm] = s.stack(M + nm + ".weight", dense_idx, True)
    else:
        # first_k_dense_replace == 0 (a valid HF default): the dense
        # prefix stack is EMPTY, zero-length tensors with the trailing
        # shapes, which the layer loop walks zero times.
        Fi = cfg.intermediate_size

        def e(*trail):
            return s.empty(0, *trail)

        dense = {
            "input_norm": e(D), "post_norm": e(D),
            "kv_a": e(D, lora + cfg.qk_rope_head_dim), "kv_a_norm": e(lora),
            "kv_b_k": e(Hq, nope, lora), "kv_b_v": e(Hq, vd, lora),
            "o_proj": e(Hq * vd, D),
            "gate_proj": e(D, Fi), "up_proj": e(D, Fi), "down_proj": e(Fi, D),
        }
        if cfg.q_lora_rank:
            dense["q_a"] = e(D, cfg.q_lora_rank)
            dense["q_a_norm"] = e(cfg.q_lora_rank)
            dense["q_b"] = e(cfg.q_lora_rank, Hq * cfg.qk_head_dim)
        else:
            dense["q_proj"] = e(D, Hq * cfg.qk_head_dim)
    params: Params = {
        "embed": s.get("model.embed_tokens.weight").to(s.dtype),
        "layers": dense,
        "final_norm": s.get("model.norm.weight").to(s.dtype),
    }
    moe_idx = list(range(k_dense, cfg.num_layers))
    if moe_idx:
        moe = attn_block(moe_idx)
        moe["router"] = s.stack(M + "gate.weight", moe_idx, True)
        if cfg.moe_scoring == "sigmoid":
            # V3's learned selection bias (not a combine weight).
            moe["router_bias"] = s.stack(M + "gate.e_score_correction_bias",
                                         moe_idx, dtype=torch.float32)
        for nm in ("gate_proj", "up_proj", "down_proj"):
            moe[nm] = _stack_experts(s, M, nm, moe_idx, cfg.num_experts)
        if cfg.n_shared_experts:
            for ours, hf in (("shared_gate", "gate_proj"),
                             ("shared_up", "up_proj"),
                             ("shared_down", "down_proj")):
                moe[ours] = s.stack(M + f"shared_experts.{hf}.weight",
                                    moe_idx, True)
        params["layers_moe"] = moe
    _load_head(s, cfg, params)
    return params


# ---------------------------------------------------------------------------
# The vision towers (Qwen2-VL, Qwen2.5-VL)
# ---------------------------------------------------------------------------

def has_text_weights(model_dir: str) -> bool:
    """Whether the directory's shards hold a text stack (its token
    embedding, at either nesting): a directory holding only a vision
    tower serves the language model from random weights."""
    if not checkpoint_files(model_dir):
        return False
    r = ShardedReader(model_dir)
    try:
        return ("model.embed_tokens.weight" in r
                or "model.language_model.embed_tokens.weight" in r)
    finally:
        r.close()


def _visual_reader(model_dir: str, depth: int, device, dtype):
    """Both tower readers' scaffolding: the shard reader, the visual key
    prefix (published ``visual.`` or the module path ``model.visual.``),
    and (reader, get, stack); None when the directory has no tower."""
    if not checkpoint_files(model_dir):
        return None
    r = ShardedReader(model_dir)
    prefix = ("visual." if "visual.patch_embed.proj.weight" in r
              else "model.visual.")
    if prefix + "patch_embed.proj.weight" not in r:
        r.close()
        return None
    s = _Stacker(r, device, dtype)

    def g(name: str) -> torch.Tensor:
        return s.get(prefix + name).to(dtype)

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return s.stack(prefix + fmt, range(depth), transpose=transpose)

    return r, g, stack


def _conv_patch_embed(g) -> torch.Tensor:
    """The Conv3d with stride = kernel over flattened patch rows is a
    matmul: the kernel [D, C, tp, P, P] flattened and transposed to
    [C * tp * P * P, D]."""
    conv = g("patch_embed.proj.weight")
    return conv.reshape(conv.shape[0], -1).t().contiguous()


def _merger_tree(g, with_bias_norm: bool) -> Dict[str, torch.Tensor]:
    out = {"ln_q_w": g("merger.ln_q.weight"),
           "mlp0_w": g("merger.mlp.0.weight").t().contiguous(),
           "mlp0_b": g("merger.mlp.0.bias"),
           "mlp2_w": g("merger.mlp.2.weight").t().contiguous(),
           "mlp2_b": g("merger.mlp.2.bias")}
    if with_bias_norm:
        out["ln_q_b"] = g("merger.ln_q.bias")
    return out


# Per-block leaves of each tower: (ours, the HF name, transposed).
_QWEN2VL_BLOCK = (
    ("norm1_w", "norm1.weight", False), ("norm1_b", "norm1.bias", False),
    ("qkv_w", "attn.qkv.weight", True), ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True), ("proj_b", "attn.proj.bias", False),
    ("norm2_w", "norm2.weight", False), ("norm2_b", "norm2.bias", False),
    ("fc1_w", "mlp.fc1.weight", True), ("fc1_b", "mlp.fc1.bias", False),
    ("fc2_w", "mlp.fc2.weight", True), ("fc2_b", "mlp.fc2.bias", False))
_QWEN25VL_BLOCK = (
    ("norm1_w", "norm1.weight", False),
    ("qkv_w", "attn.qkv.weight", True), ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True), ("proj_b", "attn.proj.bias", False),
    ("norm2_w", "norm2.weight", False),
    ("gate_w", "mlp.gate_proj.weight", True),
    ("gate_b", "mlp.gate_proj.bias", False),
    ("up_w", "mlp.up_proj.weight", True), ("up_b", "mlp.up_proj.bias", False),
    ("down_w", "mlp.down_proj.weight", True),
    ("down_b", "mlp.down_proj.bias", False))


def load_qwen2vl_vision(model_dir: str, device, vcfg=None,
                        image_size: int = 224,
                        dtype: Optional[torch.dtype] = None):
    """A Qwen2-VL or Qwen2.5-VL checkpoint's vision tower (``visual.*``,
    or ``model.visual.*`` as current transformers writes it) as
    ``models/qwen2vl_vision.py``'s parameter dict on ``device``, in
    ``dtype`` (default the config's, float32). Returns (vcfg, params), or
    None when the directory has no tower (a text checkpoint). The
    config.json's ``vision_config`` picks the tower (the JAX package's
    ``load_qwen2vl_vision``)."""
    from xllm_service_tpu_torch.models.qwen2vl_vision import (
        Qwen25VLVisionConfig, Qwen2VLVisionConfig)
    if vcfg is None:
        cfg_path = os.path.join(model_dir, "config.json")
        if not os.path.exists(cfg_path):
            return None
        with open(cfg_path, "r", encoding="utf-8") as f:
            d = json.load(f)
        if "vision_config" not in d:
            return None
        vc = d["vision_config"]
        if vc.get("model_type") == "qwen2_5_vl" \
                or "fullatt_block_indexes" in vc:
            vcfg = Qwen25VLVisionConfig.from_hf_config(vc, image_size)
        else:
            vcfg = Qwen2VLVisionConfig.from_hf_config(vc, image_size)
    v25 = isinstance(vcfg, Qwen25VLVisionConfig)
    opened = _visual_reader(model_dir, vcfg.depth, device,
                            dtype or getattr(torch, vcfg.dtype))
    if opened is None:
        return None
    r, g, stack = opened
    try:
        params = {
            "patch_embed": _conv_patch_embed(g),
            "blocks": {ours: stack("blocks.{i}." + hf, transpose=t)
                       for ours, hf, t in (_QWEN25VL_BLOCK if v25
                                           else _QWEN2VL_BLOCK)},
            "merger": _merger_tree(g, with_bias_norm=not v25),
        }
    finally:
        r.close()
    return vcfg, params


def save_qwen2vl_vision(params: Dict[str, Any], vcfg, path: str) -> int:
    """Write a tower's parameters under the published ``visual.*`` names
    (the inverse of ``load_qwen2vl_vision``) as one safetensors file.
    Returns the bytes of tensor data written."""
    from xllm_service_tpu_torch.models.qwen2vl_vision import (
        Qwen25VLVisionConfig)
    v25 = isinstance(vcfg, Qwen25VLVisionConfig)
    pe = params["patch_embed"]
    out: Dict[str, torch.Tensor] = {
        "visual.patch_embed.proj.weight": pe.t().reshape(
            pe.shape[1], vcfg.in_channels, vcfg.temporal_patch_size,
            vcfg.patch_size, vcfg.patch_size)}
    bl = params["blocks"]
    for ours, hf, t in (_QWEN25VL_BLOCK if v25 else _QWEN2VL_BLOCK):
        for i in range(vcfg.depth):
            out[f"visual.blocks.{i}.{hf}"] = bl[ours][i].t() if t \
                else bl[ours][i]
    mg = params["merger"]
    out["visual.merger.ln_q.weight"] = mg["ln_q_w"]
    if not v25:
        out["visual.merger.ln_q.bias"] = mg["ln_q_b"]
    for k in ("0", "2"):
        out[f"visual.merger.mlp.{k}.weight"] = mg[f"mlp{k}_w"].t()
        out[f"visual.merger.mlp.{k}.bias"] = mg[f"mlp{k}_b"]
    return save_file(out, path, metadata={"format": "pt"})


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------

def save_checkpoint(params: Params, cfg: ModelConfig, model_dir: str) -> int:
    """Write ``params`` (any device) as a single-file HF-layout checkpoint
    and ``config.json``, the same tensors and keys the JAX package's
    ``save_checkpoint`` writes. Each tensor streams from its own storage
    (transposes are views until the writer copies them out one at a
    time). Returns the bytes of tensor data written."""
    if cfg.mla or cfg.gptoss:
        raise NotImplementedError(
            "save_checkpoint for MLA/GPT-OSS trees is not implemented — "
            "the absorbed kv_b / interleaved gate_up splits are one-way "
            "for now")
    os.makedirs(model_dir, exist_ok=True)

    def norm(w: torch.Tensor) -> torch.Tensor:
        """Inverse of load's +1 folding for Gemma's (1 + w) convention."""
        return (w.float() - 1.0).to(w.dtype) if cfg.gemma else w

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": norm(params["final_norm"]),
    }
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t()
    lp = params["layers"]
    for i in range(cfg.num_layers):
        A = f"model.layers.{i}.self_attn."
        out[f"model.layers.{i}.input_layernorm.weight"] = \
            norm(lp["input_norm"][i])
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            norm(lp["post_norm"][i])
        if cfg.gemma:
            out[f"model.layers.{i}.pre_feedforward_layernorm.weight"] = \
                norm(lp["pre_ff_norm"][i])
            out[f"model.layers.{i}.post_feedforward_layernorm.weight"] = \
                norm(lp["post_ff_norm"][i])
        if cfg.fused_proj:
            out[A + "qkv_proj.weight"] = torch.cat(
                [lp[nm][i].t() for nm in ("q_proj", "k_proj", "v_proj")])
            out[A + "o_proj.weight"] = lp["o_proj"][i].t()
        else:
            for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
                out[A + nm + ".weight"] = lp[nm][i].t()
                bias = nm.replace("proj", "bias")
                if nm != "o_proj" and bias in lp:
                    out[A + nm + ".bias"] = lp[bias][i]
        if "q_norm" in lp:
            out[A + "q_norm.weight"] = norm(lp["q_norm"][i])
            out[A + "k_norm.weight"] = norm(lp["k_norm"][i])
        if cfg.is_moe:
            X = (f"model.layers.{i}.mlp." if cfg.qwen_moe
                 else f"model.layers.{i}.block_sparse_moe.")
            out[X + "gate.weight"] = lp["router"][i].t()
            names = ((("gate_proj", "gate_proj"), ("up_proj", "up_proj"),
                      ("down_proj", "down_proj")) if cfg.qwen_moe
                     else (("w1", "gate_proj"), ("w3", "up_proj"),
                           ("w2", "down_proj")))
            for e in range(cfg.num_experts):
                for hf, ours in names:
                    out[X + f"experts.{e}.{hf}.weight"] = lp[ours][i][e].t()
        elif cfg.fused_proj:
            M = f"model.layers.{i}.mlp."
            out[M + "gate_up_proj.weight"] = torch.cat(
                [lp["gate_proj"][i].t(), lp["up_proj"][i].t()])
            out[M + "down_proj.weight"] = lp["down_proj"][i].t()
        else:
            M = f"model.layers.{i}.mlp."
            for hf in ("gate_proj", "up_proj", "down_proj"):
                out[M + hf + ".weight"] = lp[hf][i].t()
    nbytes = save_file(out, os.path.join(model_dir, "model.safetensors"),
                       metadata={"format": "pt"})
    with open(os.path.join(model_dir, "config.json"), "w",
              encoding="utf-8") as f:
        json.dump(hf_config(cfg), f, indent=1)
    return nbytes


def hf_config(cfg: ModelConfig) -> Dict[str, Any]:
    """The ``config.json`` that ``save_checkpoint`` writes for ``cfg``
    (the JAX package's keys and values)."""
    hf_cfg: Dict[str, Any] = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
        "torch_dtype": cfg.dtype,
        # Gemma-3 is told from Gemma-2 by its per-layer rope base:
        # labelled gemma2 it would reload without qk-norm and without
        # rope_local_base_freq.
        "model_type": ("qwen2_vl" if cfg.is_mrope
                       else "gemma3_text"
                       if cfg.gemma and cfg.rope_local_base_freq is not None
                       else "gemma2" if cfg.gemma
                       else "qwen3" if cfg.qk_norm
                       else "phi3" if cfg.fused_proj
                       else "qwen2" if cfg.attention_bias else "llama"),
    }
    if cfg.rope_local_base_freq is not None:
        hf_cfg["rope_local_base_freq"] = cfg.rope_local_base_freq
    if cfg.sliding_window:
        hf_cfg["sliding_window"] = cfg.sliding_window
        if cfg.gemma and (cfg.layer_sliding is not None
                          or cfg.rope_local_base_freq is not None):
            # Always explicit for Gemma-3: a uniform all-sliding window
            # left implicit would reload through the every-6th-layer
            # global default.
            ls = cfg.layer_sliding or (True,) * cfg.num_layers
            hf_cfg["layer_types"] = ["sliding_attention" if x
                                     else "full_attention" for x in ls]
    if cfg.gemma:
        hf_cfg["attn_logit_softcapping"] = cfg.attn_logit_softcapping
        hf_cfg["final_logit_softcapping"] = cfg.final_logit_softcapping
        hf_cfg["query_pre_attn_scalar"] = cfg.query_pre_attn_scalar
    if cfg.rope_scaling is not None:
        kind = cfg.rope_scaling[0]
        if kind == "llama3":
            hf_cfg["rope_scaling"] = {
                "rope_type": "llama3", "factor": cfg.rope_scaling[1],
                "low_freq_factor": cfg.rope_scaling[2],
                "high_freq_factor": cfg.rope_scaling[3],
                "original_max_position_embeddings": cfg.rope_scaling[4]}
        elif kind == "mrope":
            hf_cfg["rope_scaling"] = {
                "type": "mrope", "mrope_section": list(cfg.rope_scaling[1])}
        elif kind == "yarn":
            (_, factor, bf, bs, orig, attn, trunc, msa) = cfg.rope_scaling
            hf_cfg["rope_scaling"] = {
                "rope_type": "yarn", "factor": factor, "beta_fast": bf,
                "beta_slow": bs, "original_max_position_embeddings": orig,
                "attention_factor": attn, "truncate": trunc}
            if msa:
                hf_cfg["rope_scaling"]["mscale_all_dim"] = msa
        else:
            hf_cfg["rope_scaling"] = {"rope_type": "linear",
                                      "factor": cfg.rope_scaling[1]}
    if cfg.is_moe:
        hf_cfg["num_experts_per_tok"] = cfg.num_experts_per_tok
        if cfg.qwen_moe:
            hf_cfg["num_experts"] = cfg.num_experts
            hf_cfg["moe_intermediate_size"] = \
                cfg.moe_intermediate_size or cfg.intermediate_size
            hf_cfg["norm_topk_prob"] = cfg.norm_topk_prob
            hf_cfg["model_type"] = "qwen3_moe"
        else:
            hf_cfg["num_local_experts"] = cfg.num_experts
            hf_cfg["model_type"] = "mixtral"
    return hf_cfg


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------

def param_digests(params: Params) -> Dict[str, str]:
    """sha256 of each leaf's bytes (row-major, its own dtype), by dotted
    name: equal digests are bit-equal weights. Each leaf is copied to
    the host on its own."""
    out: Dict[str, str] = {}

    def walk(tree: Dict[str, Any], prefix: str) -> None:
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, torch.Tensor):
                h = hashlib.sha256()
                if v.numel():
                    h.update(_raw_bytes(v))
                out[prefix + k] = h.hexdigest()
    walk(params, "")
    return out


def checkpoint_files(model_dir: str) -> Tuple[str, ...]:
    """The directory's ``*.safetensors`` shards ('' or none: ())."""
    if not model_dir:
        return ()
    return tuple(sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))))
