"""Model, engine and cluster-role configuration for the PyTorch/CUDA
worker.

``ModelConfig`` is a copy of the JAX package's architecture config
(presets and ``from_hf_config`` unchanged), so a configuration written
for one package describes the same model in the other. ``EngineConfig``
keeps the fields this engine reads: the paged KV pool, the decode slot
count, the prefill buckets, the step schedule and the order of the KV
write. ``InstanceType`` is the worker's role in the cluster, as the
JAX package names it.

Standard library only.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Dict, Optional, Tuple


class InstanceType(str, enum.Enum):
    """Worker roles. Mirrors reference ``common/types.h:71-79``; ENCODE is the
    net-new EPD multimodal encode role (reference claims EPD but keeps it
    engine-side)."""

    DEFAULT = "DEFAULT"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    MIX = "MIX"
    ENCODE = "ENCODE"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config covering Llama-2/3, Qwen2(.5), Qwen3, TinyLlama, and the
    MoE (Mixtral-style) variant used for expert parallelism.

    Frozen (hashable) so it can be a static jit argument — one compiled
    program per architecture. Derive variants with ``dataclasses.replace``.
    """

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None            # default hidden_size // num_heads
    rope_theta: float = 10000.0
    # Frequency scaling from config.json:rope_scaling, in hashable tuple
    # form ("llama3", factor, low_freq, high_freq, original_max_pos) or
    # ("linear", factor, 0, 0, 0) — see ops/rope.py. None = unscaled.
    rope_scaling: Optional[Tuple[Any, ...]] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False              # True for Qwen2 QKV
    # Per-head RMSNorm on q/k before rope (Qwen3's replacement for the
    # Qwen2 QKV bias).
    qk_norm: bool = False
    # Checkpoint stores fused qkv_proj / gate_up_proj rows (Phi-3).
    # Pure load/save-mapping concern: the in-memory tree keeps separate
    # projections, so compute paths are untouched.
    fused_proj: bool = False
    # Sliding-window attention width W (Mistral v0.1's 4096, Phi-3-mini's
    # 2047): each token attends only to the last W positions including
    # itself. None/0 = full causal attention. Threaded as a static mask
    # parameter through every attention path (ops/attention.py), so one
    # transformer body serves both regimes; the Pallas fast paths are
    # bypassed at trace time when a window is set.
    sliding_window: Optional[int] = None
    # Per-layer window activation (Gemma-2's alternating local/global
    # layers): tuple of bools, True = this layer uses sliding_window,
    # False = full attention. None = uniform (sliding_window applies to
    # every layer, or to none).
    layer_sliding: Optional[Tuple[bool, ...]] = None
    # Gemma-2 layer-body deltas (all default-off):
    # tanh soft-cap on attention logits / final lm_head logits.
    attn_logit_softcapping: float = 0.0
    final_logit_softcapping: float = 0.0
    # Attention scale = query_pre_attn_scalar**-0.5 instead of
    # head_dim**-0.5 (Gemma-2 fixes it at 256 regardless of head_dim).
    query_pre_attn_scalar: Optional[int] = None
    # Gemma family conventions: sqrt(hidden) embedding scale, the
    # four-norm block (post-attn/post-ffw norms on the SUBLAYER OUTPUT
    # before the residual add), and tanh-GELU gating in the MLP. The
    # (1 + weight) RMSNorm convention is normalized away at checkpoint
    # load (runtime/checkpoint.py adds 1; save subtracts it back).
    gemma: bool = False
    # Gemma-3: sliding (local) layers rotate with their own rope base
    # and WITHOUT the long-context scaling; full (global) layers use
    # rope_theta + rope_scaling. None = single rope base everywhere.
    rope_local_base_freq: Optional[float] = None
    # MoE (0 experts → dense MLP).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Expert MLP width when it differs from the dense intermediate size
    # (Qwen3-MoE's moe_intermediate_size). None → intermediate_size.
    moe_intermediate_size: Optional[int] = None
    # Divide the selected experts' routing weights by their sum (Mixtral
    # semantics; Qwen3-MoE checkpoints declare it via norm_topk_prob —
    # False uses the raw softmax values).
    norm_topk_prob: bool = True
    # Checkpoint expert-key dialect: mlp.experts.N.{gate,up,down}_proj +
    # mlp.gate (Qwen3-MoE) vs block_sparse_moe.experts.N.w1/w3/w2 +
    # block_sparse_moe.gate (Mixtral).
    qwen_moe: bool = False
    # --- DeepSeek-V2 multi-head latent attention (MLA) ---
    # kv_lora_rank > 0 enables MLA: per token the cache holds ONE latent
    # row [kv_lora_rank + qk_rope_head_dim] instead of per-head K/V; the
    # up-projections are absorbed into the query/output sides so the
    # standard paged-attention machinery serves the latent pool with a
    # single KV "head" (models/transformer.py MLA branch).
    kv_lora_rank: int = 0
    q_lora_rank: Optional[int] = None   # None = direct q_proj (V2-Lite)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # DeepSeek MoE shape: shared experts run densely beside the routed
    # ones; routed weights scale by routed_scaling_factor; device-limited
    # routing restricts the top-k to topk_group of n_group expert groups.
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"         # or "group_limited_greedy"
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    # First k layers use a dense MLP (DeepSeek's first_k_dense_replace);
    # the layer stack splits into a dense prefix + MoE suffix scan.
    first_k_dense_replace: int = 0
    # DeepSeek-V3 deltas over V2: sigmoid routing with a learned
    # per-expert selection bias (e_score_correction_bias — biases the
    # CHOICE, not the weights) and top-2-sum group scores; a flag for
    # the rope sub-head pair layout; and yarn's mscale² folded into the
    # softmax scale. The mscale fold is keyed on the CHECKPOINT (yarn
    # with nonzero mscale_all_dim), matching DeepSeek's original
    # modeling code and vLLM for both V2 and V3 — real V2/V2-Lite
    # checkpoints ship mscale_all_dim 0.707. (HF's in-tree V2 port
    # omits the factor; that is its divergence, not ours.)
    moe_scoring: str = "softmax"        # or "sigmoid" (V3)
    rope_interleave: bool = True
    mla_yarn_mscale: bool = False
    # GPT-OSS: per-head attention-sink logits, biased q/k/v/o, a
    # post-top-k-softmax router with bias, and clamped-GLU experts
    # ((up+1)·gate·sigmoid(1.702·gate), clamp ±7) with fused interleaved
    # gate_up weights split at load. Alternating sliding layers reuse
    # the layer_sliding machinery.
    gptoss: bool = False
    # Sparse dispatch capacity factor (parallel/expert.py): each expert
    # takes ≤ ceil(k·G·cf/E) tokens per group. ≥ E/k guarantees no drops;
    # 0 selects the dense-compute oracle (every expert on every token).
    moe_capacity_factor: float = 2.0
    # Dispatch group size G: tokens route in groups so the dispatch /
    # combine masks are [G, E, C_g] per group — linear, not quadratic, in
    # window length (GShard's group axis; parallel/expert.py).
    moe_group_size: int = 512
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.hidden_size // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mrope(self) -> bool:
        """Qwen2-VL-style 3-D multimodal rope (ops/rope.apply_mrope)."""
        return (self.rope_scaling is not None
                and self.rope_scaling[0] == "mrope")

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """Per-head query/key width under MLA (nope + rope parts)."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def kv_cache_heads(self) -> int:
        """KV-pool head count: 1 latent "head" under MLA."""
        return 1 if self.mla else self.num_kv_heads

    @property
    def kv_cache_dim(self) -> int:
        """KV-pool per-head width: the latent row under MLA."""
        return (self.kv_lora_rank + self.qk_rope_head_dim if self.mla
                else self.head_dim)

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        return cls(name="llama3-8b", vocab_size=128256, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, rope_theta=500000.0,
                   max_position_embeddings=8192)

    @classmethod
    def llama3_1b(cls) -> "ModelConfig":
        # Llama-3.2-1B shape: the single-chip flagship for bench.py.
        return cls(name="llama3-1b", vocab_size=128256, hidden_size=2048,
                   intermediate_size=8192, num_layers=16, num_heads=32,
                   num_kv_heads=8, head_dim=64, rope_theta=500000.0,
                   max_position_embeddings=8192, tie_word_embeddings=True)

    @classmethod
    def qwen2_7b(cls) -> "ModelConfig":
        return cls(name="qwen2-7b", vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_layers=28, num_heads=28,
                   num_kv_heads=4, rope_theta=1000000.0, rms_norm_eps=1e-6,
                   attention_bias=True, max_position_embeddings=32768)

    @classmethod
    def qwen25_7b(cls) -> "ModelConfig":
        # Qwen2.5-7B: identical wiring to Qwen2-7B (per-checkpoint quirks
        # come from config.json when loading from a model dir).
        return dataclasses.replace(cls.qwen2_7b(), name="qwen2.5-7b")

    @classmethod
    def qwen3_8b(cls) -> "ModelConfig":
        # Qwen3-8B: qk-norm generation (no attention bias).
        return cls(name="qwen3-8b", vocab_size=151936, hidden_size=4096,
                   intermediate_size=12288, num_layers=36, num_heads=32,
                   num_kv_heads=8, head_dim=128, rope_theta=1000000.0,
                   rms_norm_eps=1e-6, max_position_embeddings=40960,
                   qk_norm=True)

    @classmethod
    def mistral_7b(cls) -> "ModelConfig":
        # Mistral-7B v0.3: llama wiring, full attention (v0.2+ dropped
        # the sliding window).
        return cls(name="mistral-7b", vocab_size=32768, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, rope_theta=1000000.0,
                   max_position_embeddings=32768)

    @classmethod
    def mistral_7b_v01(cls) -> "ModelConfig":
        # Mistral-7B v0.1: the original sliding-window checkpoint
        # (W=4096 over a 32k position range).
        return cls(name="mistral-7b-v01", vocab_size=32000,
                   hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8,
                   rope_theta=10000.0, max_position_embeddings=32768,
                   sliding_window=4096)

    @classmethod
    def phi3_mini(cls) -> "ModelConfig":
        # Phi-3-mini-4k: llama-shaped compute, fused-projection files,
        # sliding window 2047 (as the real config.json declares).
        return cls(name="phi3-mini", vocab_size=32064, hidden_size=3072,
                   intermediate_size=8192, num_layers=32, num_heads=32,
                   num_kv_heads=32, rope_theta=10000.0,
                   max_position_embeddings=4096, fused_proj=True,
                   sliding_window=2047)

    @classmethod
    def qwen3_30b_a3b(cls) -> "ModelConfig":
        # Qwen3-30B-A3B: 128-expert top-8 MoE with qk-norm attention and
        # narrow expert MLPs (3B active of 30B total).
        return cls(name="qwen3-30b-a3b", vocab_size=151936,
                   hidden_size=2048, intermediate_size=6144,
                   moe_intermediate_size=768, num_layers=48, num_heads=32,
                   num_kv_heads=4, head_dim=128, rope_theta=1000000.0,
                   rms_norm_eps=1e-6, max_position_embeddings=40960,
                   qk_norm=True, num_experts=128, num_experts_per_tok=8,
                   norm_topk_prob=True, qwen_moe=True)

    @classmethod
    def deepseek_v2_lite(cls) -> "ModelConfig":
        # DeepSeek-V2-Lite: MLA (latent KV rank 512 + 64 rope dims → the
        # paged cache holds 576 values/token instead of 16·384), 64
        # routed + 2 shared experts, greedy top-6, one dense first layer.
        # Real checkpoints add yarn scaling (factor 40, mscale 0.707 both
        # ways → attention factor cancels to 1.0) with the mscale²
        # softmax-scale fold live (mscale_all_dim 0.707 ≠ 0).
        return cls(name="deepseek-v2-lite", vocab_size=102400,
                   hidden_size=2048, intermediate_size=10944,
                   moe_intermediate_size=1408, num_layers=27,
                   num_heads=16, num_kv_heads=16, head_dim=64,
                   rope_theta=10000.0, rms_norm_eps=1e-6,
                   max_position_embeddings=163840,
                   rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0,
                                 True, 0.707),
                   kv_lora_rank=512, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128,
                   num_experts=64, num_experts_per_tok=6,
                   n_shared_experts=2, first_k_dense_replace=1,
                   routed_scaling_factor=1.0, norm_topk_prob=False,
                   mla_yarn_mscale=True)

    @classmethod
    def deepseek_v3(cls) -> "ModelConfig":
        # DeepSeek-V3/R1 shape: 256-expert top-8 with sigmoid scoring +
        # learned selection bias, 8-group device-limited routing, MLA
        # with q compression, 3 dense prefix layers, yarn long context
        # (mscale folded into the softmax scale).
        return cls(name="deepseek-v3", vocab_size=129280,
                   hidden_size=7168, intermediate_size=18432,
                   moe_intermediate_size=2048, num_layers=61,
                   num_heads=128, num_kv_heads=128, head_dim=64,
                   rope_theta=10000.0, rms_norm_eps=1e-6,
                   max_position_embeddings=163840,
                   rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0,
                                 True, 1.0),
                   kv_lora_rank=512, q_lora_rank=1536,
                   qk_nope_head_dim=128, qk_rope_head_dim=64,
                   v_head_dim=128, num_experts=256,
                   num_experts_per_tok=8, n_shared_experts=1,
                   first_k_dense_replace=3, n_group=8, topk_group=4,
                   routed_scaling_factor=2.5, norm_topk_prob=True,
                   topk_method="group_limited_greedy",
                   moe_scoring="sigmoid", mla_yarn_mscale=True)

    @classmethod
    def gpt_oss_20b(cls) -> "ModelConfig":
        # GPT-OSS-20B: 32-expert top-4 clamped-GLU MoE, attention sinks,
        # alternating 128-token sliding layers, yarn long context.
        return cls(name="gpt-oss-20b", vocab_size=201088,
                   hidden_size=2880, intermediate_size=2880,
                   moe_intermediate_size=2880, num_layers=24,
                   num_heads=64, num_kv_heads=8, head_dim=64,
                   rope_theta=150000.0, rms_norm_eps=1e-5,
                   max_position_embeddings=131072,
                   rope_scaling=("yarn", 32.0, 32.0, 1.0, 4096,
                                 1.3465735902799727, False, 0.0),
                   attention_bias=True, sliding_window=128,
                   layer_sliding=tuple((i + 1) % 2 == 1
                                       for i in range(24)),
                   num_experts=32, num_experts_per_tok=4,
                   norm_topk_prob=False, gptoss=True)

    @classmethod
    def gemma2_9b(cls) -> "ModelConfig":
        # Gemma-2-9B: alternating local/global attention (W=4096 on even
        # layers), soft-caps, four-norm blocks, GeGLU, 256-dim heads.
        return cls(name="gemma2-9b", vocab_size=256000, hidden_size=3584,
                   intermediate_size=14336, num_layers=42, num_heads=16,
                   num_kv_heads=8, head_dim=256, rope_theta=10000.0,
                   rms_norm_eps=1e-6, max_position_embeddings=8192,
                   tie_word_embeddings=True, sliding_window=4096,
                   layer_sliding=tuple((i + 1) % 2 == 1
                                       for i in range(42)),
                   attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0,
                   query_pre_attn_scalar=256, gemma=True)

    @classmethod
    def gemma3_12b(cls) -> "ModelConfig":
        # Gemma-3-12B text stack: 5:1 local:global layers (W=1024),
        # per-layer rope bases (local 10k unscaled, global 1M with 8x
        # linear scaling), qk-norm, no soft-caps.
        return cls(name="gemma3-12b", vocab_size=262208,
                   hidden_size=3840, intermediate_size=15360,
                   num_layers=48, num_heads=16, num_kv_heads=8,
                   head_dim=256, rope_theta=1000000.0,
                   rope_local_base_freq=10000.0, rms_norm_eps=1e-6,
                   max_position_embeddings=131072,
                   rope_scaling=("linear", 8.0, 0.0, 0.0, 0),
                   tie_word_embeddings=True, qk_norm=True,
                   sliding_window=1024,
                   layer_sliding=tuple((i + 1) % 6 != 0
                                       for i in range(48)),
                   query_pre_attn_scalar=256, gemma=True)

    @classmethod
    def mixtral_8x7b(cls) -> "ModelConfig":
        # Mixtral-8x7B: the expert-parallel flagship (parallel/expert.py
        # top-k dispatch; experts shard over the mesh's ep axis).
        return cls(name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, rope_theta=1000000.0,
                   max_position_embeddings=32768, num_experts=8,
                   num_experts_per_tok=2)

    @classmethod
    def tiny(cls, vocab_size: int = 256, num_experts: int = 0) -> "ModelConfig":
        """Small config for CPU tests."""
        return cls(name="tiny", vocab_size=vocab_size, hidden_size=64,
                   intermediate_size=128, num_layers=2, num_heads=4,
                   num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                   max_position_embeddings=512, num_experts=num_experts)

    @classmethod
    def from_hf_config(cls, d: Dict[str, Any], name: str = "hf") -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict (LlamaConfig/Qwen2Config).

        Unsupported architectures are REFUSED here, not approximated: a
        model that needs sliding-window masks or layer-body deltas this
        transformer does not implement must fail at load, never emit
        silently-wrong tokens."""
        mt = d.get("model_type", "llama")
        supported = ("llama", "mistral", "qwen2", "qwen3", "phi3",
                     "mixtral", "gemma2", "gemma3", "gemma3_text",
                     "qwen2_vl", "qwen2_5_vl",
                     "qwen3_moe", "deepseek_v2", "deepseek_v3",
                     "gpt_oss")
        _dsk = mt in ("deepseek_v2", "deepseek_v3")
        if _dsk:
            tkm = d.get("topk_method")
            ok = ((None, "greedy", "group_limited_greedy")
                  if mt == "deepseek_v2"
                  # V3/R1 checkpoints say "noaux_tc" — the aux-loss-free
                  # biased sigmoid selection with grouped top-k, exactly
                  # the sigmoid gate implemented here.
                  else (None, "noaux_tc", "group_limited_greedy"))
            if tkm not in ok:
                raise ValueError(
                    f"deepseek topk_method {tkm!r} is not implemented")
            sf = d.get("scoring_func")
            want_sf = "sigmoid" if mt == "deepseek_v3" else "softmax"
            if sf is not None and sf != want_sf:
                raise ValueError(
                    f"{mt} with scoring_func {sf!r} is not implemented "
                    f"(expected {want_sf!r})")
        if mt == "qwen3_moe":
            # Mixed sparse/dense layer schedules can't share the one
            # scanned layer body — refuse, never approximate.
            if d.get("decoder_sparse_step", 1) != 1 \
                    or d.get("mlp_only_layers"):
                raise ValueError(
                    "qwen3_moe with dense layers (decoder_sparse_step "
                    "!= 1 or mlp_only_layers) is not implemented")
        if mt not in supported:
            raise ValueError(
                f"unsupported model_type {mt!r} (supported: "
                f"{', '.join(supported)})")
        if mt in ("qwen2_vl", "qwen2_5_vl", "gemma3"):
            # Current transformers nests the text stack under
            # text_config (published checkpoints keep it top-level) —
            # flatten, keeping the outer model_type.
            d = {**d, **d.get("text_config", {}), "model_type": mt}
        if mt in ("gemma3", "gemma3_text"):
            mt = "gemma3_text"
            # transformers' to_diff_dict omits class-default keys, and
            # Gemma3TextConfig's defaults differ from the generic HF
            # fallbacks below (head_dim 256 ≠ hidden/heads, theta 1e6,
            # 262k vocab, tied embeddings) — overlay them first so a
            # diff-style config.json loads faithfully.
            d = {**{"vocab_size": 262208, "head_dim": 256,
                    "rope_theta": 1000000.0,
                    "max_position_embeddings": 131072,
                    "sliding_window": 4096, "rms_norm_eps": 1e-6,
                    "tie_word_embeddings": True,
                    "query_pre_attn_scalar": 256,
                    "intermediate_size": d.get(
                        "intermediate_size", 9216),
                    "num_key_value_heads": d.get(
                        "num_key_value_heads", 4)},
                 **d, "model_type": mt}
            rs_kind = (d.get("rope_scaling") or {}).get(
                "rope_type", (d.get("rope_scaling") or {}).get("type"))
            if rs_kind not in (None, "default", "linear"):
                raise ValueError(
                    f"gemma3 rope_scaling {rs_kind!r} is not implemented "
                    f"(global layers support linear scaling only)")
        layer_sliding = None
        if mt in ("gemma2", "gemma3_text", "gpt_oss"):
            # Alternating local/global layers: HF's layer_types (or the
            # shared default pattern — sliding on even-indexed layers).
            L = d["num_hidden_layers"]
            if mt == "gemma3_text":
                # Gemma-3 default pattern: every 6th layer is global.
                lt = d.get("layer_types") or [
                    "full_attention" if (i + 1) % 6 == 0
                    else "sliding_attention" for i in range(L)]
            else:
                lt = d.get("layer_types") or [
                    "sliding_attention" if (i + 1) % 2
                    else "full_attention" for i in range(L)]
            layer_sliding = tuple(t == "sliding_attention" for t in lt)
        # sliding_window is honored for ANY supported model_type — real
        # Phi-3 checkpoints declare it too (Phi-3-mini-4k ships 2047), not
        # just Mistral v0.1 (round-3 advisor finding). A declared window
        # at least max_position_embeddings is inert and normalized away so
        # the full-attention fast paths stay eligible.
        sw = d.get("sliding_window") or None
        if sw is not None \
                and mt in ("qwen2", "qwen3", "qwen2_vl", "qwen2_5_vl",
                           "qwen3_moe") \
                and not d.get("use_sliding_window", False):
            # Qwen2-family raw config.json declares-but-disables the
            # window (e.g. Qwen2.5-7B-Instruct-1M: sliding_window 32768,
            # use_sliding_window false — and HF's default for the gate is
            # False, so an omitted key also means full attention): HF
            # torch normalizes it to None; so must we. Mistral/Phi-3
            # have no gate — a set window is always live there.
            sw = None
        if sw is not None \
                and sw >= d.get("max_position_embeddings", 4096) \
                and mt != "gemma3_text":
            # An at-least-context-wide window never binds, so dropping
            # it keeps full-attention fast paths eligible. Gemma-3 is
            # EXEMPT: its sliding/full layer pattern also selects the
            # per-layer rope base, which must survive even when the
            # window itself is inert (the mask is harmless then).
            sw = None
        if sw is not None:
            # Qwen2-family per-layer windows: the first max_window_layers
            # layers run FULL attention, the rest SWA. A uniform window
            # can express the all-SWA (0) and all-full (>= L) extremes
            # only; a genuine mix must refuse, not approximate.
            mwl = d.get("max_window_layers")
            L = d["num_hidden_layers"]
            if mwl is not None and 0 < mwl < L:
                raise ValueError(
                    f"per-layer sliding window (max_window_layers={mwl} "
                    f"of {L}) is not implemented")
            if mwl is not None and mwl >= L:
                sw = None           # every layer full attention — inert
        if layer_sliding is not None and not any(layer_sliding):
            # Every layer declared full attention: a shipped
            # sliding_window value is inert (HF ignores it too).
            sw = None
        if sw is None:
            layer_sliding = None
        elif layer_sliding is not None and all(layer_sliding):
            layer_sliding = None        # uniform window, static fast path
        parsed_rs = cls._parse_rope_scaling(
            d.get("rope_scaling"),
            d.get("max_position_embeddings", 4096))
        return cls(
            name=name,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings",
                                      mt == "gemma2"),
            attention_bias=d.get("attention_bias",
                                 d.get("model_type")
                                 in ("qwen2", "qwen2_vl", "qwen2_5_vl",
                                     "gpt_oss")),
            qk_norm=d.get("model_type") in ("qwen3", "qwen3_moe",
                                            "gemma3_text"),
            fused_proj=d.get("model_type") == "phi3",
            sliding_window=sw,
            layer_sliding=layer_sliding,
            # HF's Gemma2Config DEFAULTS the caps to 50/30 when the keys
            # are absent; an explicit null disables them. Mirror both.
            attn_logit_softcapping=(
                (d["attn_logit_softcapping"] or 0.0
                 if "attn_logit_softcapping" in d else 50.0)
                if mt == "gemma2" else 0.0),
            final_logit_softcapping=(
                (d["final_logit_softcapping"] or 0.0
                 if "final_logit_softcapping" in d else 30.0)
                if mt == "gemma2" else 0.0),
            query_pre_attn_scalar=(
                d.get("query_pre_attn_scalar", 256)
                if mt in ("gemma2", "gemma3_text") else None),
            gemma=mt in ("gemma2", "gemma3_text"),
            rope_local_base_freq=(d.get("rope_local_base_freq", 10000.0)
                                  if mt == "gemma3_text" else None),
            num_experts=(d.get("num_experts", 0) if mt == "qwen3_moe"
                         else d.get("n_routed_experts", 0) if _dsk
                         else d.get("num_local_experts", 0)),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            kv_lora_rank=(d.get("kv_lora_rank") or 0) if _dsk else 0,
            q_lora_rank=d.get("q_lora_rank") if _dsk else None,
            qk_nope_head_dim=d.get("qk_nope_head_dim", 0) if _dsk else 0,
            qk_rope_head_dim=d.get("qk_rope_head_dim", 0) if _dsk else 0,
            v_head_dim=d.get("v_head_dim", 0) if _dsk else 0,
            n_shared_experts=(d.get("n_shared_experts") or 0) if _dsk
            else 0,
            routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
            # V3's "noaux_tc" IS grouped selection under sigmoid scoring.
            topk_method=("group_limited_greedy" if mt == "deepseek_v3"
                         else d.get("topk_method", "greedy")),
            n_group=d.get("n_group"),
            topk_group=d.get("topk_group"),
            first_k_dense_replace=(d.get("first_k_dense_replace", 0)
                                   if _dsk else 0),
            moe_scoring="sigmoid" if mt == "deepseek_v3" else "softmax",
            gptoss=mt == "gpt_oss",
            rope_interleave=bool(d.get("rope_interleave", True)),
            # The mscale² softmax-scale fold follows the CHECKPOINT, not
            # the model_type: DeepSeek's own modeling code (and vLLM)
            # apply it whenever yarn ships a nonzero mscale_all_dim —
            # real V2/V2-Lite checkpoints carry 0.707 — while HF's
            # in-tree V2 port omits it (round-4 advisor finding).
            mla_yarn_mscale=bool(
                _dsk and parsed_rs is not None and parsed_rs[0] == "yarn"
                and len(parsed_rs) > 7 and parsed_rs[7]),
            # HF defaults: Mixtral always normalizes top-k weights;
            # Qwen3MoeConfig defaults norm_topk_prob to FALSE when the
            # key is absent; the DeepSeek-V2 gate never normalizes.
            norm_topk_prob=bool(d.get("norm_topk_prob",
                                      mt != "qwen3_moe"))
            and mt != "deepseek_v2",
            qwen_moe=mt == "qwen3_moe",
            rope_scaling=parsed_rs,
        )

    @staticmethod
    def _parse_rope_scaling(rs: Optional[Dict[str, Any]],
                            max_position_embeddings: int = 4096
                            ) -> Optional[Tuple[Any, ...]]:
        """config.json:rope_scaling dict → the hashable tuple ops/rope.py
        takes. Unknown types raise at load time rather than silently
        mis-rotating positions (checkpoint-fidelity contract)."""
        if not rs:
            return None
        kind = rs.get("rope_type", rs.get("type"))
        if rs.get("mrope_section") and kind in (None, "default", "mrope"):
            # Qwen2-VL 3-D multimodal rope: (t, h, w) frequency-band
            # sections (ops/rope.py apply_mrope). Published checkpoints
            # say type "mrope"; transformers re-serializes it as
            # "default" + mrope_section.
            return ("mrope", tuple(int(s) for s in rs["mrope_section"]))
        if kind in (None, "default"):
            return None
        if kind == "llama3":
            return ("llama3", float(rs["factor"]),
                    float(rs["low_freq_factor"]),
                    float(rs["high_freq_factor"]),
                    int(rs["original_max_position_embeddings"]))
        if kind == "linear":
            return ("linear", float(rs["factor"]), 0.0, 0.0, 0)
        if kind == "yarn":
            # NTK-by-parts (YaRN, 2309.00071): low-frequency bands
            # interpolate by `factor`, high-frequency extrapolate, a
            # linear ramp blends between; cos/sin scale by the attention
            # factor (inferred from factor/mscale when not explicit —
            # HF modeling_rope_utils._compute_yarn_parameters).
            factor = float(rs["factor"])
            attn = rs.get("attention_factor")
            if attn is None:
                ms, msa = rs.get("mscale"), rs.get("mscale_all_dim")

                def _mscale(scale, m=1.0):
                    import math
                    return (0.1 * m * math.log(scale) + 1.0) if scale > 1 \
                        else 1.0

                attn = (_mscale(factor, ms) / _mscale(factor, msa)
                        if ms and msa else _mscale(factor))
            orig = int(rs.get("original_max_position_embeddings")
                       or max_position_embeddings)
            return ("yarn", factor,
                    float(rs.get("beta_fast") or 32.0),
                    float(rs.get("beta_slow") or 1.0),
                    orig, float(attn),
                    bool(rs.get("truncate", True)),
                    float(rs.get("mscale_all_dim") or 0.0))
        raise NotImplementedError(
            f"rope_scaling type {kind!r} not supported")


@dataclasses.dataclass
class EngineConfig:
    """Worker-engine runtime config (paged KV cache + continuous batching).

    Field names, defaults and environment overrides match the JAX
    package's ``EngineConfig``. ``enable_prefix_cache`` turns on the
    content-addressed prefix cache (``runtime/kv_cache.PrefixCacheIndex``):
    full pages are registered under their chained block digest, a prompt
    whose leading pages are cached prefills only past them, and released
    pages stay reclaimable until allocation pressure takes them."""

    page_size: int = 64                 # tokens per KV page
    num_pages: int = 1024               # KV pool size (per layer)
    max_model_len: int = 2048           # max tokens per sequence
    max_batch_size: int = 8             # decode slot count
    max_prefill_tokens: int = 2048      # prefill token budget per step
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    enable_prefix_cache: bool = True
    # One-dispatch ragged mixed steps: an interleaved iteration with both
    # running decoders and schedulable prefill windows packs both into
    # one ragged batch (decode rows are length-1 continuation windows)
    # served by one forward whose layers attend with the ragged kernel.
    # None = off. Env XLLM_RAGGED_ATTN=0/1 overrides.
    ragged_attn: Optional[bool] = None
    # Token-budget interleaving: every iteration decodes the running set
    # first, then spends the rest of the iteration's token budget on
    # chunked-prefill windows. None = on; off = prefill-first routing
    # (a step prefills if it can, else decodes). Env XLLM_INTERLEAVE=0/1
    # overrides.
    interleave: Optional[bool] = None
    # Token budget of one interleaved iteration, decode tokens included.
    # 0 = max_prefill_tokens. Env XLLM_STEP_TOKEN_BUDGET overrides.
    step_token_budget: int = 0
    # Once the oldest waiting prompt has queued this long (ms), the
    # iteration's prefill budget is floored at the smallest prefill
    # bucket even if decode used up the budget. 0 = the floor applies on
    # every iteration. Env XLLM_PREFILL_DEADLINE_MS overrides.
    prefill_deadline_ms: float = 500.0
    # Order of the KV write in a layer. True: write-then-attend, each
    # layer writes its fresh K/V into the pool, then attends to the pool.
    # False: attend-then-write, each layer attends to the pool plus its
    # fresh K/V, and one launch writes every layer's rows after the layer
    # loop. None = resolved at Engine init: on where the CUDA kernels run,
    # off on the CPU (as the JAX engine resolves it from its Pallas
    # switch). The ragged mixed step always writes first. Env
    # XLLM_WRITE_THEN_ATTEND=0/1 overrides.
    write_then_attend: Optional[bool] = None
    # Decode steps fused into one dispatch (one CUDA graph replay): the
    # N forwards feed each sampled token and position forward on the
    # device, and only the [N, B] tokens and logprobs cross to the host.
    # Finish detection runs on the host afterwards; tokens sampled past
    # a stop are discarded.
    decode_steps: int = 1
    # Top-k alternative logprobs computed inside every step (a static k;
    # 0 computes none). OpenAI callers get at most this many
    # ``top_logprobs``.
    num_top_logprobs: int = 0
    # Pipelined decode: after dispatching fused burst k, start its
    # device-to-host copy and, while the batch still matches, dispatch
    # burst k+1 from the device-resident carries before reading burst k
    # back, so the host post overlaps the next burst's device work. A
    # wrong speculation is discarded (the generator's state restored)
    # and re-dispatched from host truth; token streams are identical
    # either way. None = on when decode_steps > 1. Env
    # XLLM_DECODE_PIPELINE=0/1 overrides.
    decode_pipeline: Optional[bool] = None
    # Every step kind through CUDA graphs: decode captured per (table
    # width, steps, sampling mode), prefill and ragged per (rows, bucket,
    # table width, sampling mode), the counterparts of the JAX engine's
    # jitted programs. None = on for a CUDA engine, off on the CPU (where
    # the same runners call the steps eagerly). Env XLLM_CUDA_GRAPHS=0/1
    # overrides.
    cuda_graphs: Optional[bool] = None
    # Host spill tier: when > 0 (and the prefix cache is on), cached
    # pages reclaimed under allocation pressure are copied into a
    # host-memory tier of this many MB instead of dropped, and restored
    # into fresh pages on a later prefix hit. 0 = off. Env
    # XLLM_KV_SPILL_MB overrides.
    kv_spill_mb: float = 0.0
    # Optional disk tier behind the host tier: blocks the host tier
    # demotes land as header + raw-bytes ``.kv`` files under this
    # directory, bounded by kv_spill_disk_mb. An empty directory or a
    # zero budget means no disk tier. Env XLLM_KV_SPILL_DIR /
    # XLLM_KV_SPILL_DISK_MB override.
    kv_spill_dir: str = ""
    kv_spill_disk_mb: float = 0.0

    def __post_init__(self) -> None:
        if self.max_model_len % self.page_size != 0:
            raise ValueError(
                f"max_model_len={self.max_model_len} must be a multiple of "
                f"page_size={self.page_size}")
        # Any bucket works: the KV writers of this package take any
        # window start, page-aligned or not.
        self.prefill_buckets = tuple(sorted(self.prefill_buckets))
        self.max_pages_per_seq = self.max_model_len // self.page_size
        flag = _env_flag("XLLM_RAGGED_ATTN")
        if flag is not None:
            self.ragged_attn = flag
        flag = _env_flag("XLLM_INTERLEAVE")
        if flag is not None:
            self.interleave = flag
        flag = _env_flag("XLLM_WRITE_THEN_ATTEND")
        if flag is not None:
            self.write_then_attend = flag
        flag = _env_flag("XLLM_DECODE_PIPELINE")
        if flag is not None:
            self.decode_pipeline = flag
        flag = _env_flag("XLLM_CUDA_GRAPHS")
        if flag is not None:
            self.cuda_graphs = flag
        env = os.environ.get("XLLM_STEP_TOKEN_BUDGET", "").strip()
        if env:
            try:
                self.step_token_budget = int(env)
            except ValueError:
                pass
        env = os.environ.get("XLLM_PREFILL_DEADLINE_MS", "").strip()
        if env:
            try:
                self.prefill_deadline_ms = float(env)
            except ValueError:
                pass
        env = os.environ.get("XLLM_KV_SPILL_MB", "").strip()
        if env:
            try:
                self.kv_spill_mb = float(env)
            except ValueError:
                pass
        env = os.environ.get("XLLM_KV_SPILL_DIR", "").strip()
        if env:
            self.kv_spill_dir = env
        env = os.environ.get("XLLM_KV_SPILL_DISK_MB", "").strip()
        if env:
            try:
                self.kv_spill_disk_mb = float(env)
            except ValueError:
                pass


def _env_flag(name: str) -> Optional[bool]:
    """A 0/1 environment switch: True, False, or None when unset (or
    neither)."""
    env = os.environ.get(name, "").strip()
    if env in ("0", "false", "no"):
        return False
    if env in ("1", "true", "yes"):
        return True
    return None
