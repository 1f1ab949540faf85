"""Decoder-only transformer over a paged KV cache: the dense families.

The counterpart of the JAX package's ``models/transformer.py`` for
dense, non-MLA, non-MoE models (Llama-2/3.x, Qwen2/2.5/3, Phi-3,
Mistral, Gemma-2), in both of its orders of the KV write
(``write_then_attend``):

- write-then-attend: every layer writes its fresh K/V into the pool
  first (the one-layer KV writer kernels), then its attention kernel
  reads everything, cached prefix and current tokens alike, from the
  pool;
- attend-then-write: every layer attends to the pool (the cached
  prefix) plus its fresh K/V, handed to the attention kernel as
  separate operands, and keeps them; after the layer loop they are
  stacked to [L, ...] and one launch of the all-layer writer puts them
  in the pool.

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
from xllm_service_tpu_torch.ops.attention import FULL_WINDOW
from xllm_service_tpu_torch.ops.kernels import (
    paged_decode_attention, paged_decode_attention_current, paged_kv_update,
    paged_kv_update_layer, paged_prefill_attention,
    paged_prefill_attention_fresh, paged_prefill_kv_update,
    paged_prefill_kv_update_layer, ragged_paged_attention)
from xllm_service_tpu_torch.ops.norm import rms_norm
from xllm_service_tpu_torch.ops.rope import rope_cos_sin, rotate

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]   # [L, P, ps, Hkv, D] each


def check_supported(cfg: ModelConfig) -> None:
    """Refuse the families whose layer body this package lacks."""
    missing = []
    if cfg.mla:
        missing.append("multi-head latent attention")
    if cfg.is_moe or cfg.gptoss:
        missing.append("mixture-of-experts MLPs")
    if cfg.rope_local_base_freq is not None:
        missing.append("per-layer rope bases")
    if cfg.rope_scaling is not None and cfg.rope_scaling[0] not in (
            "llama3", "linear"):
        missing.append(f"{cfg.rope_scaling[0]} rope scaling")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not supported by this "
            f"package yet")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: Optional[torch.dtype] = None) -> Params:
    """Random-init a parameter dict with the stacked-layer layout, drawn
    from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg)
    L, D, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * (1.0 / math.sqrt(fan_in))).to(dtype)

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
        "gate_proj": w((L, D, Fi), D),
        "up_proj": w((L, D, Fi), D),
        "down_proj": w((L, Fi, D), Fi),
    }
    if cfg.attention_bias:
        layers["q_bias"] = zeros(L, Hq * Dh)
        layers["k_bias"] = zeros(L, Hkv * Dh)
        layers["v_bias"] = zeros(L, Hkv * Dh)
    if cfg.gemma:
        layers["pre_ff_norm"] = ones(L, D)
        layers["post_ff_norm"] = ones(L, D)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Dh)
        layers["k_norm"] = ones(L, Dh)
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
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
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
    return x * torch.tensor(math.sqrt(cfg.hidden_size), dtype=x.dtype,
                            device=x.device)


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].t() if head is None else head


def _head_logits(cfg: ModelConfig, x: torch.Tensor,
                 head: torch.Tensor) -> torch.Tensor:
    """lm_head matmul, logits in float32, with Gemma-2's final soft-cap."""
    logits = (x @ head).float()
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


def _mlp(lp: Dict[str, torch.Tensor], cfg: ModelConfig,
         x: torch.Tensor) -> torch.Tensor:
    """Dense gated MLP: SiLU (Llama family) or tanh-GELU (Gemma)."""
    gate = x @ lp["gate_proj"]
    act = F.gelu(gate, approximate="tanh") if cfg.gemma else F.silu(gate)
    return (act * (x @ lp["up_proj"])) @ lp["down_proj"]


def _block_tail(lp, cfg: ModelConfig, x: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """Residual adds around attention output ``a`` and the MLP; Gemma's
    four-norm block norms each sublayer output before its add."""
    if cfg.gemma:
        x = x + rms_norm(a, lp["post_norm"], cfg.rms_norm_eps)
        h = rms_norm(x, lp["pre_ff_norm"], cfg.rms_norm_eps)
        return x + rms_norm(_mlp(lp, cfg, h), lp["post_ff_norm"],
                            cfg.rms_norm_eps)
    x = x + a
    h = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    return x + _mlp(lp, cfg, h)


def _attn_out(lp, a: torch.Tensor) -> torch.Tensor:
    a = a @ lp["o_proj"]
    return a + lp["o_bias"] if "o_bias" in lp else a


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def forward_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    start_pos: torch.Tensor, lengths: torch.Tensor,
                    kv: KVCache, page_table: torch.Tensor,
                    ragged: bool = False, write_then_attend: bool = True
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill ``tokens`` [B, T] (padded; ``lengths`` [B] int32 true
    counts) at positions start_pos[b] + t, with the cached prefix
    [0, start_pos[b]) already in the pools. Writes the window's K/V into
    the pools in place. Returns (logits of each row's last valid token
    [B, V] float32, kv).

    ``write_then_attend`` (see the module docstring): True writes each
    layer's window before its attention; False attends to the prefix
    and the fresh window, then writes all layers' windows in one launch.

    ``ragged``: the batch is the engine's ragged mix, each row a prefill
    window or a single decode continuation (length 1 at start_pos =
    context - 1, mid-page as often as not), and each layer attends with
    the ragged kernel instead of the prefill kernel. It requires
    write-then-attend, as in the JAX package. The writer is the same:
    this package's prefill KV writer takes any start (on the TPU the
    ragged step writes through the XLA scatter there, because the Pallas
    writer needs page-aligned starts)."""
    check_supported(cfg)
    if ragged and not write_then_attend:
        raise ValueError("the ragged mixed step requires write_then_attend")
    attend = ragged_paged_attention if ragged else paged_prefill_attention
    k_pages, v_pages = kv
    B, T = tokens.shape
    x = _scale_embed(cfg, params["embed"][tokens])                 # [B, T, D]
    positions = start_pos.long()[:, None] + torch.arange(
        T, device=tokens.device)[None, :]
    # Every layer rotates by the same positions: one cos/sin table.
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    extras = _attn_extras(cfg)
    windows = _layer_windows(cfg)
    k_fresh, v_fresh = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        kw = dict(sliding_window=windows[i], sinks=lp.get("sinks"), **extras)
        if write_then_attend:
            paged_prefill_kv_update_layer(k_pages, v_pages, k, v, page_table,
                                          start_pos, lengths, i)
            attn = attend(q, k_pages, v_pages, page_table, start_pos,
                          lengths, i, **kw)
        else:
            k_fresh.append(k)
            v_fresh.append(v)
            attn = paged_prefill_attention_fresh(
                q, k, v, k_pages, v_pages, page_table, start_pos, lengths, i,
                **kw)
        x = _block_tail(lp, cfg, x, _attn_out(lp, attn.reshape(B, T, -1)))
    if not write_then_attend:
        paged_prefill_kv_update(k_pages, v_pages, torch.stack(k_fresh),
                                torch.stack(v_fresh), page_table, start_pos,
                                lengths)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (lengths.long() - 1).clamp(min=0)
    last_x = x[torch.arange(B, device=x.device), last]
    return _head_logits(cfg, last_x, _head(params)), (k_pages, v_pages)


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, active: torch.Tensor,
                   kv: KVCache, page_table: torch.Tensor,
                   write_then_attend: bool = True
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for ``tokens`` [B] at ``positions`` [B] int32
    (``active`` [B] bool masks empty slots). Writes each active row's
    K/V into the pools in place. Returns (logits [B, V] float32, kv).

    ``write_then_attend`` True: each layer writes the current token's
    K/V, then attends with a context that includes it. False: each layer
    attends to the ``where(active, positions, 0)`` cached tokens plus
    the current one, held apart; one launch writes all layers' rows
    after the loop."""
    check_supported(cfg)
    k_pages, v_pages = kv
    B = tokens.shape[0]
    x = _scale_embed(cfg, params["embed"][tokens[:, None]])        # [B, 1, D]
    cos, sin = rope_cos_sin(positions.long()[:, None], cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scaling)
    zero = torch.zeros_like(positions)
    if write_then_attend:
        context = torch.where(active, positions + 1, zero)
    else:
        cache_lens = torch.where(active, positions, zero)
    k_cur, v_cur = [], []
    extras = _attn_extras(cfg)
    windows = _layer_windows(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h)                                 # [B,1,H,Dh]
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        kw = dict(sliding_window=windows[i], sinks=lp.get("sinks"), **extras)
        if write_then_attend:
            paged_kv_update_layer(k_pages, v_pages, k[:, 0], v[:, 0],
                                  page_table, positions, active, i)
            attn = paged_decode_attention(q[:, 0], k_pages, v_pages,
                                          page_table, context, i, **kw)
        else:
            k_cur.append(k[:, 0])
            v_cur.append(v[:, 0])
            attn = paged_decode_attention_current(
                q[:, 0], k_pages, v_pages, page_table, cache_lens, k[:, 0],
                v[:, 0], i, **kw)
        x = _block_tail(lp, cfg, x, _attn_out(lp, attn.reshape(B, 1, -1)))
    if not write_then_attend:
        paged_kv_update(k_pages, v_pages, torch.stack(k_cur),
                        torch.stack(v_cur), page_table, positions, active)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _head_logits(cfg, x[:, 0], _head(params)), (k_pages, v_pages)
