"""Decoder-only transformer over a paged KV cache.

The counterpart of the JAX package's ``models/transformer.py`` for the
Llama-2/3.x, Qwen2/2.5/3, Phi-3, Mistral, Gemma-2 and Gemma-3 families
(Gemma-3's local and global layers rotate by their own rope bases:
``ops/rope.layer_cos_sin`` makes one cos/sin set per base from the
forward's positions, and each layer takes its own), their
mixture-of-experts variants (Mixtral, Qwen3-MoE: SwiGLU experts behind
a softmax top-k router, ``parallel/expert.py``), GPT-OSS (attention
sinks, biased q/k/v/o, alternating 128-token windows, clamped-GLU
experts with biases behind a biased router), and DeepSeek-V2/V3's
multi-head latent attention (MLA) with DeepSeek's MoE, in both of its
orders of the KV write (``write_then_attend``):

- write-then-attend: every layer writes its fresh K/V into the pool
  first (the one-layer KV writer kernels, fused with the rope of q and
  k, or under MLA with the latent row's norm and rope: one launch), then
  its attention kernel reads everything, cached prefix and current
  tokens alike, from the pool;
- attend-then-write: every layer attends to the pool (the cached
  prefix) plus its fresh K/V, handed to the attention kernel as
  separate operands. The same fused kernels rotate (or build the
  latent) there, with no pools to write, and put the fresh rows in
  their layer's slot of a staging buffer [L, B, (T,) Hkv, D] that the
  forward allocates once; the attention reads them there. A decode
  step's last layer writes every layer's rows into the pool in its own
  writer launch (``rope_kv_update_all_layers``,
  ``latent_kv_update_all_layers``); a prefill step writes them after
  the layer loop with one launch of the all-layer window writer.

The Qwen2/2.5-VL text stacks rotate by the multimodal rope (mrope):
three position streams, each owning a section of the frequency bands.
A prefill given ``rope_pos`` [B, 3, T] builds the sectioned cos/sin
tables from them (``ops/rope.mrope_cos_sin``), which the fused rope +
KV-write kernels take unchanged; a decode given ``rope_delta`` [B]
rotates at ``position + rope_delta`` (equal streams: standard rope),
while the KV goes to its storage position. ``mm_embeds`` rows splice
over the token embeddings at the window positions ``mm_index`` names
(the EPD path's vision embeddings, ``runtime/multimodal.py``).
``forward_embedding`` is the ``/v1/embeddings`` forward: a causal pass
with no cache (the fresh-window form of the prefill attention kernel,
nothing read from the pools), mean-pooled over the valid tokens.

Under MLA the pool holds one latent row per token, [kv_lora_rank
(normed) | rotated k_pe], as a single KV "head" of width
``cfg.kv_cache_dim``; the key up-projection is absorbed into the query
and the value up-projection applied after attention, so decode
attention reads each latent row once for both products (the K3''
kernel). Both pools carry the same latent rows, as in the JAX package;
the second is written and never read.

Under a mesh (``parallel/mesh.py``; every forward takes ``mesh=``) the
parameters are one rank's shard (``parallel/sharding.py``) and ``cfg``
is its view (``shard_config``: its query and KV heads), so that every
kernel runs at the shard's head counts. The collectives sit where the
JAX package's GSPMD puts them: one all-reduce over tp after ``o_proj``
and one after ``down_proj`` (after an MoE layer's combine over the
joint (ep, tp) group: each rank contracts its own experts), the
vocabulary-split embedding as a masked local lookup and an all-reduce,
the split head as local logits and an all-gather over tp before the
soft-cap. A leaf left whole (``o_bias``, shared experts) is added once,
after its reduce. ``forward_prefill_ring`` splits a whole prompt's
sequence over sp (ring attention).

Parameters are a plain dict with the JAX package's layout: per-layer
weights stacked over a leading [L] axis, weights used as ``x @ W`` with
``W`` [in, out]. The layer loop is a Python loop over L; ``params[...][i]``
is a view. bfloat16 weights and activations; norms, rope, softmax and
logits in float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.ops.attention import (
    FULL_WINDOW, gather_pages, mha_prefill_auto, overlay_fresh_kv)
from xllm_service_tpu_torch.ops.kernels import (
    latent_kv_update_all_layers, latent_kv_update_layer,
    latent_prefill_kv_update_layer, paged_decode_attention,
    paged_decode_attention_current, paged_decode_attention_mla,
    paged_decode_attention_mla_current, paged_prefill_attention,
    paged_prefill_attention_fresh, paged_prefill_kv_update,
    ragged_paged_attention, rope_kv_update_all_layers, rope_kv_update_layer,
    rope_prefill_kv_update_layer)
from xllm_service_tpu_torch.ops.norm import rms_norm
from xllm_service_tpu_torch.ops.rope import (layer_cos_sin, mrope_cos_sin,
                                             rope_cos_sin, rotate,
                                             rotate_interleaved)
from xllm_service_tpu_torch.parallel.expert import gptoss_glu, moe_mlp
from xllm_service_tpu_torch.parallel.mesh import (AXIS_EP, AXIS_EP_TP,
                                                  AXIS_SP, AXIS_TP, Mesh)
from xllm_service_tpu_torch.parallel.ring import ring_attention

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]   # [L, P, ps, Hkv, D] each


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a rope scaling this package lacks."""
    kind = cfg.rope_scaling[0] if cfg.rope_scaling is not None else None
    if kind not in (None, "llama3", "linear", "yarn", "mrope"):
        raise NotImplementedError(
            f"{cfg.name}: {kind} rope scaling not supported by this "
            f"package yet")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

# Largest float32 draw of the random init, in elements (1 GiB): a larger
# weight is drawn a slice of its leading axis at a time, so that the
# float32 transient stays small beside the weights being built (one
# layer's experts of DeepSeek-V2-Lite, not all 26).
_DRAW_ELEMS = 1 << 28


def _random_weight(shape, fan_in: int, generator: torch.Generator, device,
                   dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/fan_in) in ``dtype``, drawn in float32 from ``generator``
    in slices of the leading axis of at most ``_DRAW_ELEMS`` elements."""
    out = torch.empty(shape, device=device, dtype=dtype)
    if out.numel() == 0:
        return out
    rows = max(1, _DRAW_ELEMS // (out.numel() // shape[0]))
    for i in range(0, shape[0], rows):
        x = torch.randn((min(rows, shape[0] - i),) + tuple(shape[1:]),
                        generator=generator, device=device,
                        dtype=torch.float32)
        out[i:i + rows] = x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: Optional[torch.dtype] = None) -> Params:
    """Random-init a parameter dict with the stacked-layer layout, drawn
    from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg)
    if cfg.mla:
        return _init_mla_params(cfg, generator, device, dtype)
    L, D, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(shape, fan_in):
        return _random_weight(shape, fan_in, generator, device, dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    layers: Dict[str, torch.Tensor] = {
        "input_norm": ones(L, D),
        "q_proj": w((L, D, Hq * Dh), D),
        "k_proj": w((L, D, Hkv * Dh), D),
        "v_proj": w((L, D, Hkv * Dh), D),
        "o_proj": w((L, Hq * Dh, D), Hq * Dh),
        "post_norm": ones(L, D),
    }
    if cfg.attention_bias:
        layers["q_bias"] = zeros(L, Hq * Dh)
        layers["k_bias"] = zeros(L, Hkv * Dh)
        layers["v_bias"] = zeros(L, Hkv * Dh)
    if cfg.gemma:
        layers["pre_ff_norm"] = ones(L, D)
        layers["post_ff_norm"] = ones(L, D)
    if cfg.gptoss:
        layers["sinks"] = torch.zeros(L, Hq, device=device,
                                      dtype=torch.float32)
        layers["o_bias"] = zeros(L, D)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Dh)
        layers["k_norm"] = ones(L, Dh)
    if cfg.is_moe:
        E, Fe = cfg.num_experts, cfg.moe_intermediate_size or Fi
        layers["router"] = w((L, D, E), D)
        layers["gate_proj"] = w((L, E, D, Fe), D)
        layers["up_proj"] = w((L, E, D, Fe), D)
        layers["down_proj"] = w((L, E, Fe, D), Fe)
        if cfg.gptoss:
            layers["router_bias"] = torch.zeros(L, E, device=device,
                                                dtype=torch.float32)
            layers["gate_bias"] = zeros(L, E, Fe)
            layers["up_bias"] = zeros(L, E, Fe)
            layers["down_bias"] = zeros(L, E, D)
    else:
        layers["gate_proj"] = w((L, D, Fi), D)
        layers["up_proj"] = w((L, D, Fi), D)
        layers["down_proj"] = w((L, Fi, D), Fi)
    params: Params = {
        "embed": w((cfg.vocab_size, D), D),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((D, cfg.vocab_size), D)
    return params


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int, device,
                  dtype: Optional[torch.dtype] = None) -> KVCache:
    dtype = dtype or torch_dtype(cfg)
    # MLA: one latent "head" of width kv_lora_rank + qk_rope_head_dim.
    shape = (cfg.num_layers, num_pages, page_size, cfg.kv_cache_heads,
             cfg.kv_cache_dim)
    return (torch.zeros(shape, device=device, dtype=dtype),
            torch.zeros(shape, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def _attn_extras(cfg: ModelConfig) -> Dict[str, Any]:
    """Per-model attention keywords: Gemma-2's logit soft-cap and its
    query_pre_attn_scalar**-0.5 scale."""
    out: Dict[str, Any] = {"logits_soft_cap": cfg.attn_logit_softcapping}
    if cfg.query_pre_attn_scalar is not None:
        out["scale"] = cfg.query_pre_attn_scalar ** -0.5
    return out


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Sliding window of each layer (0 = full attention). Alternating
    models (Gemma-2) give full layers the larger-than-any-context
    window, as the JAX package does."""
    if cfg.layer_sliding is None:
        return [cfg.sliding_window or 0] * cfg.num_layers
    return [cfg.sliding_window if s else FULL_WINDOW
            for s in cfg.layer_sliding]


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _scale_embed(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma scales token embeddings by sqrt(hidden), in the activation
    dtype."""
    if not cfg.gemma:
        return x
    # The factor rounded to the activation dtype on the host: a Python
    # number, so that a CUDA graph capture copies nothing from the host.
    scale = float(torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype))
    return x * scale


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].t() if head is None else head


def _split(mesh: Optional[Mesh], axes=AXIS_TP) -> bool:
    return mesh is not None and mesh.size(axes) > 1


def _reduce(mesh: Optional[Mesh], x: torch.Tensor,
            axes=AXIS_TP) -> torch.Tensor:
    """Sum of a row-parallel product's shares over ``axes``."""
    return mesh.all_reduce(x, axes) if _split(mesh, axes) else x


def _embed(params: Params, tokens: torch.Tensor,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Token embeddings; under tp each rank holds a slice of the
    vocabulary and looks up the tokens that fall in it (zeros for the
    rest), and one all-reduce puts every row together (exactly: one
    share of each row is nonzero)."""
    emb = params["embed"]
    if not _split(mesh):
        return emb[tokens]
    n = emb.shape[0]
    idx = tokens.long() - mesh.index(AXIS_TP) * n
    inside = (idx >= 0) & (idx < n)
    rows = emb[idx.clamp(0, n - 1)] * inside[..., None].to(emb.dtype)
    return mesh.all_reduce(rows, AXIS_TP)


def _head_logits(cfg: ModelConfig, x: torch.Tensor,
                 head: torch.Tensor,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """lm_head matmul, logits in float32, with Gemma-2's final soft-cap;
    under tp each rank's vocabulary slice, gathered over tp first."""
    logits = (x @ head).float()
    if _split(mesh):
        logits = mesh.all_gather(logits, AXIS_TP, dim=-1)
    cap = cfg.final_logit_softcapping
    if cap > 0.0:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _qkv(lp: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor):
    """x: [B, T, D] -> q [B, T, Hq, Dh], k/v [B, T, Hkv, Dh]."""
    B, T, _ = x.shape
    q = x @ lp["q_proj"]
    k = x @ lp["k_proj"]
    v = x @ lp["v_proj"]
    if "q_bias" in lp:
        q = q + lp["q_bias"]
        k = k + lp["k_bias"]
        v = v + lp["v_bias"]
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in lp:
        # Qwen3: per-head RMSNorm on q/k before rope.
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _scatter_topk(vals: torch.Tensor, idx: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """Per-token top-k ``vals`` [.., k] at distinct expert ids ``idx``
    [.., k] as a dense [.., E] map."""
    out = vals.new_zeros(vals.shape[:-1] + (num_classes,))
    return out.scatter_(-1, idx, vals)


def _expert_offset(mesh: Optional[Mesh], lp) -> int:
    """The global id of this rank's first expert."""
    if not _split(mesh, AXIS_EP):
        return 0
    return mesh.index(AXIS_EP) * lp["gate_proj"].shape[0]


def _tp_lead(mesh: Optional[Mesh]) -> bool:
    """Whether this rank adds the leaves a tp group adds once."""
    return mesh is None or mesh.index(AXIS_TP) == 0


def _experts_dense(lp: Dict[str, torch.Tensor], x: torch.Tensor,
                   weights: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The dense oracle of an MoE layer: every SwiGLU expert on every
    token, mixed by the [B, T, E] routing map (this rank's experts'
    share of it under a mesh, reduced over (ep, tp))."""
    e0, n = _expert_offset(mesh, lp), lp["gate_proj"].shape[0]
    weights = weights[..., e0:e0 + n]
    hg = torch.einsum("btd,edf->btef", x, lp["gate_proj"])
    hu = torch.einsum("btd,edf->btef", x, lp["up_proj"])
    if "gate_bias" in lp:
        # GPT-OSS: biased clamped-GLU experts.
        h = gptoss_glu(hg + lp["gate_bias"], hu + lp["up_bias"])
    else:
        h = F.silu(hg) * hu
    out = torch.einsum("btef,efd->bted", h, lp["down_proj"])
    if "down_bias" in lp and _tp_lead(mesh):
        out = out + lp["down_bias"]
    return _reduce(mesh, torch.einsum("bted,bte->btd", out,
                                      weights.to(x.dtype)), AXIS_EP_TP)


def _gptoss_gate(lp: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """GPT-OSS's routing weights as a dense [.., E] map: the top-k of the
    BIASED router logits (float32), a softmax over just the k chosen."""
    logits = (x @ lp["router"]).float() + lp["router_bias"]
    topv, topi = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    return _scatter_topk(torch.softmax(topv, dim=-1), topi,
                         logits.shape[-1])


def _gptoss_moe(lp: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, valid: Optional[torch.Tensor],
                moe_dropped: Optional[torch.Tensor],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """GPT-OSS's MoE: ``_gptoss_gate``'s routing, the clamped-GLU experts
    with their biases (the capacity path, or the dense oracle at
    capacity factor 0)."""
    k = cfg.num_experts_per_tok
    weights = _gptoss_gate(lp, cfg, x)
    if cfg.moe_capacity_factor <= 0:
        return _experts_dense(lp, x, weights, mesh)
    out, dropped = moe_mlp(
        x, lp["router"], lp["gate_proj"], lp["up_proj"], lp["down_proj"], k,
        cfg.moe_capacity_factor, valid=valid, group_size=cfg.moe_group_size,
        norm_topk=False, gates=weights, expert_style="gptoss",
        gate_b=lp["gate_bias"], up_b=lp["up_bias"],
        down_b=lp["down_bias"] if _tp_lead(mesh) else None,
        expert_offset=_expert_offset(mesh, lp))
    if moe_dropped is not None:
        moe_dropped.add_(dropped)
    return _reduce(mesh, out, AXIS_EP_TP)


def _mlp(lp: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
         valid: Optional[torch.Tensor] = None,
         moe_dropped: Optional[torch.Tensor] = None,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Gated MLP: SiLU (Llama family) or tanh-GELU (Gemma); MoE models
    route each token through its top-k SwiGLU experts. ``valid`` [B, T]
    bool marks real tokens: padding and inactive rows take no expert
    capacity. The capacity path adds its dropped (token, expert)
    assignments into the device scalar ``moe_dropped`` when one is
    given (no host sync)."""
    if not cfg.is_moe:
        gate = x @ lp["gate_proj"]
        act = F.gelu(gate, approximate="tanh") if cfg.gemma else F.silu(gate)
        return _reduce(mesh, (act * (x @ lp["up_proj"])) @ lp["down_proj"])
    if cfg.gptoss:
        return _gptoss_moe(lp, cfg, x, valid, moe_dropped, mesh)
    k = cfg.num_experts_per_tok
    if cfg.moe_capacity_factor > 0:
        out, dropped = moe_mlp(x, lp["router"], lp["gate_proj"],
                               lp["up_proj"], lp["down_proj"], k,
                               cfg.moe_capacity_factor, valid=valid,
                               group_size=cfg.moe_group_size,
                               norm_topk=cfg.norm_topk_prob,
                               expert_offset=_expert_offset(mesh, lp))
        if moe_dropped is not None:
            moe_dropped.add_(dropped)
        return _reduce(mesh, out, AXIS_EP_TP)
    # Dense oracle (capacity factor 0), the reference of the sparse path.
    gates = torch.softmax((x @ lp["router"]).float(), dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return _experts_dense(lp, x, _scatter_topk(topv, topi, gates.shape[-1]),
                          mesh)


def _block_tail(lp, cfg: ModelConfig, x: torch.Tensor, a: torch.Tensor,
                valid: torch.Tensor,
                moe_dropped: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Residual adds around attention output ``a`` and the MLP; Gemma's
    four-norm block norms each sublayer output before its add."""
    if cfg.gemma:
        x = x + rms_norm(a, lp["post_norm"], cfg.rms_norm_eps)
        h = rms_norm(x, lp["pre_ff_norm"], cfg.rms_norm_eps)
        return x + rms_norm(_mlp(lp, cfg, h, valid, moe_dropped, mesh),
                            lp["post_ff_norm"], cfg.rms_norm_eps)
    x = x + a
    h = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    return x + _mlp(lp, cfg, h, valid, moe_dropped, mesh)


def _attn_out(lp, a: torch.Tensor, mesh: Optional[Mesh] = None
              ) -> torch.Tensor:
    """o_proj (row-parallel under tp: reduced), then GPT-OSS's o bias,
    once."""
    a = _reduce(mesh, a @ lp["o_proj"])
    return a + lp["o_bias"] if "o_bias" in lp else a


def _staging(cfg: ModelConfig, lead: Tuple[int, ...], pool: torch.Tensor):
    """The attend-then-write path's staging buffers: every layer's fresh
    K and V rows, [L, *lead, Hkv, D] each in the pools' dtype
    (``torch.empty``: no launch), or under MLA one buffer of latent rows
    (K and V alike)."""
    shape = (cfg.num_layers, *lead, cfg.kv_cache_heads, cfg.kv_cache_dim)
    if cfg.mla:
        return torch.empty(shape, dtype=pool.dtype, device=pool.device)
    return tuple(torch.empty(shape, dtype=pool.dtype, device=pool.device)
                 for _ in range(2))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def forward_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    start_pos: torch.Tensor, lengths: torch.Tensor,
                    kv: KVCache, page_table: torch.Tensor,
                    ragged: bool = False, write_then_attend: bool = True,
                    moe_dropped: Optional[torch.Tensor] = None,
                    prompt_lp_targets: Optional[torch.Tensor] = None,
                    mm_embeds: Optional[torch.Tensor] = None,
                    mm_index: Optional[torch.Tensor] = None,
                    rope_pos: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Prefill ``tokens`` [B, T] (padded; ``lengths`` [B] int32 true
    counts) at positions start_pos[b] + t, with the cached prefix
    [0, start_pos[b]) already in the pools. Writes the window's K/V into
    the pools in place. Returns (logits of each row's last valid token
    [B, V] float32, kv), and with ``prompt_lp_targets`` [B, T] a third
    element: [B, T] float32, the logprob of ``prompt_lp_targets[b, t]``
    under the distribution predicted at window position t (the
    completion API's ``echo`` scores; ``_prompt_logprobs``).

    ``write_then_attend`` (see the module docstring): True writes each
    layer's window before its attention; False attends to the prefix
    and the fresh window (staged per layer), then writes all layers'
    windows in one launch.

    ``ragged``: the batch is the engine's ragged mix, each row a prefill
    window or a single decode continuation (length 1 at start_pos =
    context - 1, mid-page as often as not), and each layer attends with
    the ragged kernel instead of the prefill kernel. It requires
    write-then-attend, as in the JAX package. The writer is the same:
    this package's prefill KV writer takes any start (on the TPU the
    ragged step writes through the XLA scatter there, because the Pallas
    writer needs page-aligned starts).

    ``moe_dropped``: a device int64 scalar into which an MoE model's
    capacity path adds the (token, expert) assignments it dropped, the
    JAX forwards' ``moe_dropped``; MLA models add nothing (their routed
    experts run dense, as in the JAX package).

    ``mm_embeds`` [N, D] and ``mm_index`` [B, T] (int, -1 = none): window
    position t of row b takes embedding row ``mm_index[b, t]`` in place
    of its token's embedding (the JAX forward's ``mm_embeds`` /
    ``mm_positions`` splice, after Gemma's embedding scale). ``rope_pos``
    [B, 3, T]: an mrope model's explicit position streams for the
    window; None broadcasts the storage positions (standard rope).
    ``mesh``: the rank's mesh (``params`` its shard, ``cfg`` its view;
    see the module docstring)."""
    check_supported(cfg)
    if ragged and not write_then_attend:
        raise ValueError("the ragged mixed step requires write_then_attend")
    if cfg.mla:
        if ragged:
            raise ValueError("MLA models have no ragged mixed-batch path")
        if mm_embeds is not None:
            raise ValueError("MLA models have no multimodal splice")
        return _mla_forward_prefill(params, cfg, tokens, start_pos, lengths,
                                    kv, page_table, write_then_attend,
                                    prompt_lp_targets, mesh)
    attend = ragged_paged_attention if ragged else paged_prefill_attention
    k_pages, v_pages = kv
    B, T = tokens.shape
    x = _scale_embed(cfg, _embed(params, tokens, mesh))            # [B, T, D]
    if mm_embeds is not None:
        x = splice_embeds(x, mm_embeds, mm_index)
    positions = start_pos.long()[:, None] + torch.arange(
        T, device=tokens.device)[None, :]
    # Every layer rotates by the same positions: one cos/sin table, or
    # one per rope base (Gemma-3's local and global layers).
    if rope_pos is not None:
        ropes = [mrope_cos_sin(rope_pos, cfg.head_dim, cfg.rope_theta,
                               cfg.rope_scaling[1])] * cfg.num_layers
    else:
        ropes = layer_cos_sin(cfg, positions)
    valid = torch.arange(T, device=tokens.device)[None, :] \
        < lengths.long()[:, None]
    extras = _attn_extras(cfg)
    windows = _layer_windows(cfg)
    if not write_then_attend:
        k_stage, v_stage = _staging(cfg, (B, T), k_pages)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)
        cos, sin = ropes[i]
        kw = dict(sliding_window=windows[i], sinks=lp.get("sinks"), **extras)
        if write_then_attend:
            # q and k rotated in place, k and v written: one launch.
            rope_prefill_kv_update_layer(q, k, v, cos, sin, k_pages, v_pages,
                                         page_table, start_pos, lengths, i)
            attn = attend(q, k_pages, v_pages, page_table, start_pos,
                          lengths, i, **kw)
        else:
            rope_prefill_kv_update_layer(q, k, v, cos, sin, layer=i,
                                         k_stage=k_stage, v_stage=v_stage)
            attn = paged_prefill_attention_fresh(
                q, k_stage[i], v_stage[i], k_pages, v_pages, page_table,
                start_pos, lengths, i, **kw)
        x = _block_tail(lp, cfg, x,
                        _attn_out(lp, attn.reshape(B, T, -1), mesh),
                        valid, moe_dropped, mesh)
    if not write_then_attend:
        paged_prefill_kv_update(k_pages, v_pages, k_stage, v_stage,
                                page_table, start_pos, lengths)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (lengths.long() - 1).clamp(min=0)
    last_x = x[torch.arange(B, device=x.device), last]
    out = (_head_logits(cfg, last_x, _head(params), mesh),
           (k_pages, v_pages))
    if prompt_lp_targets is None:
        return out
    return out + (_prompt_logprobs(x, _head(params), prompt_lp_targets,
                                   cap=cfg.final_logit_softcapping,
                                   mesh=mesh),)


def splice_embeds(x: torch.Tensor, mm_embeds: torch.Tensor,
                  mm_index: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] with position (b, t) replaced by ``mm_embeds[mm_index[
    b, t]]`` where the index is >= 0 (cast to x's dtype)."""
    rows = mm_embeds[mm_index.long().clamp(min=0)].to(x.dtype)
    return torch.where(mm_index[..., None] >= 0, rows, x)


def _prompt_logprobs(x: torch.Tensor, head: torch.Tensor,
                     targets: torch.Tensor, chunk: int = 128,
                     cap: float = 0.0,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """logprob of ``targets[b, t]`` under the distribution predicted at
    position t, from the final hidden states ``x`` [B, T, D]. Chunked
    over T (gcd(T, 128) positions a chunk) so the [B, c, V] logits block,
    not the whole [B, T, V], is the peak intermediate, as the JAX
    package's ``_prompt_logprobs``."""
    B, T, _ = x.shape
    c = math.gcd(T, min(chunk, T))
    out = []
    for i in range(0, T, c):
        logits = (x[:, i:i + c] @ head).float()              # [B, c, V]
        if _split(mesh):
            logits = mesh.all_gather(logits, AXIS_TP, dim=-1)
        if cap > 0.0:
            logits = cap * torch.tanh(logits / cap)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, 2,
                           targets[:, i:i + c, None].long())[..., 0]
        out.append(tgt - lse)
    return torch.cat(out, dim=1)


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, active: torch.Tensor,
                   kv: KVCache, page_table: torch.Tensor,
                   write_then_attend: bool = True,
                   moe_dropped: Optional[torch.Tensor] = None,
                   rope_delta: Optional[torch.Tensor] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for ``tokens`` [B] at ``positions`` [B] int32
    (``active`` [B] bool masks empty slots). Writes each active row's
    K/V into the pools in place. Returns (logits [B, V] float32, kv).

    ``write_then_attend`` True: each layer writes the current token's
    K/V, then attends with a context that includes it. False: each layer
    attends to the ``where(active, positions, 0)`` cached tokens plus
    the current one, held apart in a staging buffer; the last layer's
    writer writes all layers' rows, before that layer attends (which
    reads only positions below ``positions``). ``moe_dropped`` as in
    ``forward_prefill``. ``rope_delta`` [B] (mrope models): each row
    rotates at ``positions + rope_delta`` (images compress their rope
    span, so a generated token's rope position trails its storage
    position); its KV is written at ``positions``."""
    check_supported(cfg)
    if cfg.mla:
        return _mla_forward_decode(params, cfg, tokens, positions, active,
                                   kv, page_table, write_then_attend, mesh)
    k_pages, v_pages = kv
    B = tokens.shape[0]
    x = _scale_embed(cfg, _embed(params, tokens[:, None], mesh))   # [B, 1, D]
    rope_at = positions if rope_delta is None else positions + rope_delta
    ropes = layer_cos_sin(cfg, rope_at.long()[:, None])
    zero = torch.zeros_like(positions)
    if write_then_attend:
        context = torch.where(active, positions + 1, zero)
    else:
        cache_lens = torch.where(active, positions, zero)
        k_stage, v_stage = _staging(cfg, (B,), k_pages)
    extras = _attn_extras(cfg)
    windows = _layer_windows(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)                                 # [B,1,H,Dh]
        cos, sin = ropes[i]
        kw = dict(sliding_window=windows[i], sinks=lp.get("sinks"), **extras)
        if write_then_attend:
            rope_kv_update_layer(q, k, v, cos, sin, k_pages, v_pages,
                                 page_table, positions, active, i)
            attn = paged_decode_attention(q[:, 0], k_pages, v_pages,
                                          page_table, context, i, **kw)
        else:
            if i < cfg.num_layers - 1:
                rope_kv_update_layer(q, k, v, cos, sin, layer=i,
                                     k_stage=k_stage, v_stage=v_stage)
            else:
                rope_kv_update_all_layers(q, k, v, cos, sin, k_pages,
                                          v_pages, page_table, positions,
                                          active, i, k_stage, v_stage)
            attn = paged_decode_attention_current(
                q[:, 0], k_pages, v_pages, page_table, cache_lens,
                k_stage[i], v_stage[i], i, **kw)
        x = _block_tail(lp, cfg, x,
                        _attn_out(lp, attn.reshape(B, 1, -1), mesh),
                        active[:, None], moe_dropped, mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (_head_logits(cfg, x[:, 0], _head(params), mesh),
            (k_pages, v_pages))


def forward_embedding(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      lengths: torch.Tensor, kv: KVCache) -> torch.Tensor:
    """Sequence embeddings (``/v1/embeddings``): a causal forward of
    ``tokens`` [B, T] (padded; ``lengths`` [B] true counts) from
    position 0, with no cache, the final hidden states mean-pooled over
    each row's valid tokens and L2-normalized -> [B, D] float32. Each
    layer attends through the fresh-window prefill kernel with its K/V
    as the fresh operands and no cached prefix: ``kv`` (the engine's
    pools) is passed for its layout and never read or written."""
    check_supported(cfg)
    if cfg.mla:
        raise NotImplementedError(
            "/v1/embeddings is not implemented for MLA models")
    k_pages, v_pages = kv
    B, T = tokens.shape
    dev = tokens.device
    x = _scale_embed(cfg, params["embed"][tokens])
    positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    ropes = layer_cos_sin(cfg, positions)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    start = torch.zeros_like(lengths)
    table = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lengths.long()[:, None]
    extras = _attn_extras(cfg)
    windows = _layer_windows(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)
        q, k = rotate(q, *ropes[i]), rotate(k, *ropes[i])
        attn = paged_prefill_attention_fresh(
            q, k, v, k_pages, v_pages, table, start, lengths, i,
            sliding_window=windows[i], sinks=lp.get("sinks"), **extras)
        x = _block_tail(lp, cfg, x, _attn_out(lp, attn.reshape(B, T, -1)),
                        valid)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps).float()
    mask = valid.float()
    pooled = (x * mask[..., None]).sum(dim=1) / \
        mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def forward_prefill_ring(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, lengths: torch.Tensor,
                         kv: KVCache, page_table: torch.Tensor, mesh: Mesh,
                         moe_dropped: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, KVCache]:
    """Sequence-parallel prefill of whole prompts: ``tokens`` [B, T]
    (T a multiple of the sp size; ``lengths`` [B] true counts, every
    prompt from position 0, nothing cached) split over the mesh's ``sp``
    axis, this rank taking the block [r * T / sp, (r + 1) * T / sp). Each
    layer rotates its block's q and k with the fused rope writer in its
    pool-less form (staged per layer), attends by ring attention
    (``parallel/ring.py``) and runs its MLP on the block; an MoE layer
    routes the whole sequence (gathered over sp), so that its groups and
    capacities are the unsplit forward's. After the layer loop the
    staged K/V are gathered over sp and written into every layer of the
    pools with one launch of the all-layer writer (K7). Returns (logits
    of each row's last valid token [B, V] float32, kv).

    As the JAX package's ``forward_prefill_ring``: no sliding window,
    Gemma layer body, latent attention or attention sinks (those long
    prompts take the chunked windows), and no prompt scores."""
    check_supported(cfg)
    if cfg.sliding_window or cfg.gemma or cfg.mla or cfg.gptoss:
        raise NotImplementedError(
            "ring prefill implements neither sliding-window masks, the "
            "gemma layer body, latent attention, nor attention sinks")
    k_pages, v_pages = kv
    B, T = tokens.shape
    n, r = mesh.size(AXIS_SP), mesh.index(AXIS_SP)
    if T % n:
        raise ValueError(f"ring prefill of {T} positions does not split "
                         f"over sp={n}")
    tl = T // n
    dev = tokens.device
    pos = r * tl + torch.arange(tl, device=dev)                    # global
    x = _embed(params, tokens[:, r * tl:(r + 1) * tl], mesh)
    ropes = layer_cos_sin(cfg, pos[None, :].expand(B, tl))
    valid = pos[None, :] < lengths.long()[:, None]                 # [B, tl]
    full_valid = torch.arange(T, device=dev)[None, :] \
        < lengths.long()[:, None]
    k_stage, v_stage = _staging(cfg, (B, tl), k_pages)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)
        cos, sin = ropes[i]
        rope_prefill_kv_update_layer(q, k, v, cos, sin, layer=i,
                                     k_stage=k_stage, v_stage=v_stage)
        attn = ring_attention(q, k_stage[i], v_stage[i], mesh, lengths)
        x = x + _attn_out(lp, attn.reshape(B, tl, -1), mesh)
        h = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        if cfg.is_moe:
            whole = mesh.all_gather(h, AXIS_SP, dim=1)
            m = _mlp(lp, cfg, whole, full_valid, moe_dropped, mesh)
            x = x + m[:, r * tl:(r + 1) * tl]
        else:
            x = x + _mlp(lp, cfg, h, valid, moe_dropped, mesh)
    k_all = mesh.all_gather(k_stage, AXIS_SP, dim=2)         # [L, B, T, ..]
    v_all = mesh.all_gather(v_stage, AXIS_SP, dim=2)
    zero = torch.zeros_like(lengths)
    paged_prefill_kv_update(k_pages, v_pages, k_all, v_all, page_table,
                            zero, lengths)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    # Each row's last valid token lies in one rank's block: that rank
    # contributes its hidden state, the others zeros.
    last = (lengths.long() - 1).clamp(min=0) - r * tl
    mine = (last >= 0) & (last < tl)
    last_x = x[torch.arange(B, device=dev), last.clamp(0, tl - 1)]
    last_x = mesh.all_reduce(last_x * mine[:, None].to(x.dtype), AXIS_SP)
    return (_head_logits(cfg, last_x, _head(params), mesh),
            (k_pages, v_pages))


# ---------------------------------------------------------------------------
# DeepSeek-V2/V3 multi-head latent attention (MLA)
#
# The pool holds one latent row per token, [c_hat (kv_a_norm-ed, rank r)
# | rope(k_pe)], as a single KV "head" (cfg.kv_cache_heads/dim). The kv_b
# up-projections are absorbed: scores = (W_bk^T q_nope) . c + q_pe . k_pe
# and out_h = W_bv (sum p c), HF's per-head math by associativity, so
# attention reads r + rope values per token. The rope sub-head rotates
# adjacent pairs (cfg.rope_interleave).
# ---------------------------------------------------------------------------

def _init_mla_params(cfg: ModelConfig, generator: torch.Generator, device,
                     dtype: torch.dtype) -> Params:
    """The JAX package's MLA layout: ``layers`` holds the first
    ``first_k_dense_replace`` (dense-MLP) layers, ``layers_moe`` the MoE
    layers after them."""
    D, Hq = cfg.hidden_size, cfg.num_heads
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim

    def w(shape, fan_in):
        return _random_weight(shape, fan_in, generator, device, dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def attn_block(L):
        blk = {
            "input_norm": ones(L, D),
            "kv_a": w((L, D, r + rope), D),
            "kv_a_norm": ones(L, r),
            "kv_b_k": w((L, Hq, nope, r), r),
            "kv_b_v": w((L, Hq, vd, r), r),
            "o_proj": w((L, Hq * vd, D), Hq * vd),
            "post_norm": ones(L, D),
        }
        if cfg.q_lora_rank:
            blk["q_a"] = w((L, D, cfg.q_lora_rank), D)
            blk["q_a_norm"] = ones(L, cfg.q_lora_rank)
            blk["q_b"] = w((L, cfg.q_lora_rank, Hq * cfg.qk_head_dim),
                           cfg.q_lora_rank)
        else:
            blk["q_proj"] = w((L, D, Hq * cfg.qk_head_dim), D)
        return blk

    k_dense = cfg.first_k_dense_replace if cfg.is_moe else cfg.num_layers
    n_moe = cfg.num_layers - k_dense
    Fi = cfg.intermediate_size
    dense = attn_block(k_dense)
    dense["gate_proj"] = w((k_dense, D, Fi), D)
    dense["up_proj"] = w((k_dense, D, Fi), D)
    dense["down_proj"] = w((k_dense, Fi, D), Fi)
    params: Params = {
        "embed": w((cfg.vocab_size, D), D),
        "layers": dense,
        "final_norm": ones(D),
    }
    if n_moe:
        Fe = cfg.moe_intermediate_size or Fi
        E = cfg.num_experts
        moe = attn_block(n_moe)
        moe["router"] = w((n_moe, D, E), D)
        if cfg.moe_scoring == "sigmoid":
            moe["router_bias"] = torch.zeros(n_moe, E, device=device,
                                             dtype=torch.float32)
        moe["gate_proj"] = w((n_moe, E, D, Fe), D)
        moe["up_proj"] = w((n_moe, E, D, Fe), D)
        moe["down_proj"] = w((n_moe, E, Fe, D), Fe)
        if cfg.n_shared_experts:
            Fs = Fe * cfg.n_shared_experts
            moe["shared_gate"] = w((n_moe, D, Fs), D)
            moe["shared_up"] = w((n_moe, D, Fs), D)
            moe["shared_down"] = w((n_moe, Fs, D), Fs)
        params["layers_moe"] = moe
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((D, cfg.vocab_size), D)
    return params


def _deepseek_gate(cfg: ModelConfig, x: torch.Tensor,
                   router_w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routing weights after DeepSeek's selection rules, as a dense
    [.., E] map.

    V2 (softmax scoring): softmax over float32 logits; group-limited
    routing zeroes every expert outside the top ``topk_group`` of
    ``n_group`` groups (a group scores its best member); the top-k
    selected scores are the weights, unnormalized. V3 (sigmoid scoring):
    selection uses the scores plus the per-expert ``bias`` and top-2-sum
    group scores; the weights are the raw sigmoid scores of the chosen
    experts, normalized when ``norm_topk_prob``. Both scale by
    ``routed_scaling_factor``."""
    logits = (x @ router_w).float()
    E = logits.shape[-1]
    sigmoid = cfg.moe_scoring == "sigmoid"
    scores = torch.sigmoid(logits) if sigmoid else torch.softmax(logits, -1)
    choice = scores + bias if (sigmoid and bias is not None) else scores
    if cfg.topk_method == "group_limited_greedy":
        G = cfg.n_group
        grouped = choice.reshape(*choice.shape[:-1], G, E // G)
        gs = (grouped.topk(2, dim=-1).values.sum(-1) if sigmoid
              else grouped.amax(dim=-1))
        gidx = gs.topk(cfg.topk_group, dim=-1).indices
        gmask = torch.zeros_like(gs).scatter_(-1, gidx, 1.0)
        choice = torch.where(gmask.repeat_interleave(E // G, dim=-1) > 0,
                             choice, torch.zeros_like(choice))
    topi = choice.topk(cfg.num_experts_per_tok, dim=-1).indices
    sel = torch.zeros_like(scores).scatter_(-1, topi, 1.0)
    weights = (scores if sigmoid else choice) * sel
    if sigmoid and cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor


def _mla_moe_mlp(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Routed experts behind the DeepSeek gate, plus the always-on shared
    experts. A capacity factor > 0 dispatches sparsely (the drop count is
    discarded, as in the JAX package); 0 runs the dense oracle. Under a
    mesh the routed share is reduced over (ep, tp) and the shared
    experts, whole on every rank, are added after it."""
    weights = _deepseek_gate(cfg, x, lp["router"], lp.get("router_bias"))
    if cfg.moe_capacity_factor > 0:
        routed, _ = moe_mlp(
            x, lp["router"], lp["gate_proj"], lp["up_proj"],
            lp["down_proj"], cfg.num_experts_per_tok,
            cfg.moe_capacity_factor, valid=valid,
            group_size=cfg.moe_group_size, norm_topk=False, gates=weights,
            expert_offset=_expert_offset(mesh, lp))
        routed = _reduce(mesh, routed, AXIS_EP_TP)
    else:
        routed = _experts_dense(lp, x, weights, mesh)
    if "shared_gate" not in lp:
        return routed
    return routed + (F.silu(x @ lp["shared_gate"]) * (x @ lp["shared_up"])) \
        @ lp["shared_down"]


def _mla_rope(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin of the rope sub-head for ``positions`` [B, T], and the
    rotation it takes."""
    cos, sin = rope_cos_sin(positions.long(), cfg.qk_rope_head_dim,
                            cfg.rope_theta, cfg.rope_scaling)
    return cos, sin, (rotate_interleaved if cfg.rope_interleave else rotate)


def _mla_q(cfg: ModelConfig, lp, h: torch.Tensor, rope) -> torch.Tensor:
    """The absorbed query of one layer: h [B, T, D] -> q_tilde [B, T, Hq,
    r + rope] = [W_bk^T q_nope | rope(q_pe)]; ``rope`` from ``_mla_rope``.
    Its rope and ``cat`` stay plain PyTorch."""
    cos, sin, rot = rope
    B, T, _ = h.shape
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        q = rms_norm(h @ lp["q_a"], lp["q_a_norm"], cfg.rms_norm_eps) \
            @ lp["q_b"]
    else:
        q = h @ lp["q_proj"]
    q = q.reshape(B, T, cfg.num_heads, cfg.qk_head_dim)
    q_eff = torch.einsum("bthn,hnr->bthr", q[..., :nope], lp["kv_b_k"])
    return torch.cat([q_eff, rot(q[..., nope:], cos, sin)], dim=-1)


def _latent_args(cfg: ModelConfig, lp, h: torch.Tensor, rope):
    """The latent-row kernels' leading arguments for one layer: ckv =
    h @ kv_a [B, T, r + rope], kv_a_norm, cos, sin, eps and the rope's
    pairing. The kernel builds [c_hat | rope(k_pe)] from them."""
    cos, sin, _ = rope
    return (h @ lp["kv_a"], lp["kv_a_norm"], cos, sin, cfg.rms_norm_eps,
            cfg.rope_interleave)


def _mla_out(cfg: ModelConfig, lp, attn: torch.Tensor,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """attn [..., Hq, r + rope] -> the absorbed value up-projection of its
    first r columns -> o_proj (reduced over tp under a mesh)."""
    o = torch.einsum("...hr,hvr->...hv", attn[..., :cfg.kv_lora_rank],
                     lp["kv_b_v"])
    return _reduce(mesh, o.reshape(*o.shape[:-2], -1) @ lp["o_proj"])


def _mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale: qk_head_dim^-0.5, times yarn's mscale squared (the
    query and the key side) when the checkpoint folds it in
    (``mla_yarn_mscale``, a nonzero mscale_all_dim)."""
    scale = cfg.qk_head_dim ** -0.5
    rs = cfg.rope_scaling
    if cfg.mla_yarn_mscale and rs is not None and rs[0] == "yarn":
        factor, msa = rs[1], rs[7] if len(rs) > 7 else 0.0
        if msa and factor > 1.0:
            m = 0.1 * msa * math.log(factor) + 1.0
            scale = scale * m * m
    return scale


def _mla_layers(params: Params):
    """(global layer index, layer weights, MoE?) over the dense layers,
    then the MoE layers."""
    li = 0
    for key, moe in (("layers", False), ("layers_moe", True)):
        stack = params.get(key)
        if stack is None:
            continue
        for i in range(stack["input_norm"].shape[0]):
            yield li, {k: v[i] for k, v in stack.items()}, moe
            li += 1


def _mla_mlp(cfg: ModelConfig, lp, h: torch.Tensor, moe: bool,
             valid: torch.Tensor, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    if moe:
        return _mla_moe_mlp(cfg, lp, h, valid, mesh)
    return _reduce(mesh, (F.silu(h @ lp["gate_proj"]) * (h @ lp["up_proj"]))
                   @ lp["down_proj"])


def _mla_forward_prefill(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, start_pos: torch.Tensor,
                         lengths: torch.Tensor, kv: KVCache,
                         page_table: torch.Tensor, write_then_attend: bool,
                         prompt_lp_targets: Optional[torch.Tensor] = None,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """``forward_prefill`` for MLA models. Attention is the plain
    ``mha_prefill_auto`` (dense up to 64 MiB of scores, the chunked
    online softmax past it) over the gathered latent pool
    (write-then-attend:
    after the latent form of K2 built and wrote the window's latent
    rows) or over the gathered prefix with the fresh
    window laid over it (attend-then-write: the windows staged per
    layer, K7 writes every layer's window after the loop), as the JAX
    package runs it through XLA."""
    k_pages, v_pages = kv
    B, T = tokens.shape
    x = _embed(params, tokens, mesh)
    positions = start_pos.long()[:, None] + torch.arange(
        T, device=tokens.device)[None, :]
    kv_lengths = start_pos + lengths
    valid = torch.arange(T, device=tokens.device)[None, :] \
        < lengths.long()[:, None]
    rope = _mla_rope(cfg, positions)
    scale = _mla_scale(cfg)
    if not write_then_attend:
        stage = _staging(cfg, (B, T), k_pages)
    for li, lp, moe in _mla_layers(params):
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q_t = _mla_q(cfg, lp, h, rope)
        lat_args = _latent_args(cfg, lp, h, rope)
        if write_then_attend:
            latent_prefill_kv_update_layer(*lat_args, k_pages, v_pages,
                                           page_table, start_pos, lengths, li)
            lat_all = gather_pages(k_pages[li], page_table)
        else:
            latent = latent_prefill_kv_update_layer(*lat_args, layer=li,
                                                    stage=stage)
            lat_all = overlay_fresh_kv(gather_pages(k_pages[li], page_table),
                                       latent, start_pos)
        attn = mha_prefill_auto(q_t, lat_all, lat_all, kv_lengths, start_pos,
                                scale=scale)
        x = x + _mla_out(cfg, lp, attn, mesh)
        h = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = x + _mla_mlp(cfg, lp, h, moe, valid, mesh)
    if not write_then_attend:
        paged_prefill_kv_update(k_pages, v_pages, stage, stage, page_table,
                                start_pos, lengths)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (lengths.long() - 1).clamp(min=0)
    last_x = x[torch.arange(B, device=x.device), last]
    out = (_head_logits(cfg, last_x, _head(params), mesh),
           (k_pages, v_pages))
    if prompt_lp_targets is None:
        return out
    # No final soft-cap on the MLA path's scores, as in the JAX package.
    return out + (_prompt_logprobs(x, _head(params), prompt_lp_targets,
                                   mesh=mesh),)


def _mla_forward_decode(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, positions: torch.Tensor,
                        active: torch.Tensor, kv: KVCache,
                        page_table: torch.Tensor, write_then_attend: bool,
                        mesh: Optional[Mesh] = None
                        ) -> Tuple[torch.Tensor, KVCache]:
    """``forward_decode`` for MLA models: every layer attends with K3''
    over its latent pool, after the latent form of K1 built and wrote
    the current latent row (write-then-attend), or with the current row
    held apart in a staging buffer and the last layer's latent writer
    writing every layer's row (attend-then-write)."""
    k_pages, v_pages = kv
    x = _embed(params, tokens[:, None], mesh)               # [B, 1, D]
    rope = _mla_rope(cfg, positions[:, None])
    scale = _mla_scale(cfg)
    zero = torch.zeros_like(positions)
    context = torch.where(active, positions + 1, zero)
    cache_lens = torch.where(active, positions, zero)
    if not write_then_attend:
        stage = _staging(cfg, (tokens.shape[0],), k_pages)
    for li, lp, moe in _mla_layers(params):
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q_t = _mla_q(cfg, lp, h, rope)
        lat_args = _latent_args(cfg, lp, h, rope)
        if write_then_attend:
            latent_kv_update_layer(*lat_args, k_pages, v_pages, page_table,
                                   positions, active, li)
            attn = paged_decode_attention_mla(q_t[:, 0], k_pages, page_table,
                                              context, li, scale)
        else:
            if li < cfg.num_layers - 1:
                latent_kv_update_layer(*lat_args, layer=li, stage=stage)
            else:
                latent_kv_update_all_layers(*lat_args, k_pages, v_pages,
                                            page_table, positions, active,
                                            li, stage)
            lat = stage[li]                                 # [B, 1, r+rope]
            attn = paged_decode_attention_mla_current(
                q_t[:, 0], k_pages, page_table, cache_lens, lat, li, scale)
        x = x + _mla_out(cfg, lp, attn, mesh)[:, None, :]
        h = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = x + _mla_mlp(cfg, lp, h, moe, active[:, None], mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (_head_logits(cfg, x[:, 0], _head(params), mesh),
            (k_pages, v_pages))
