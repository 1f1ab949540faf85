"""Analytic roofline count of one forward program: FLOPs and bytes.

The engine's roofline table (``Engine.roofline``, read by
``obs/steptrace.py``) needs the work of each program it runs at warmup's
padded shapes. The JAX package takes it from XLA's ``cost_analysis()``;
this module counts it from the model and the shape alone, so that the
number is the same work whatever kernel implements it: a redesigned
kernel moves the measured time, never the count. It also does not share
``cost_analysis``'s habit of counting a scanned layer stack's body once:
every layer is counted.

The count, for a program key at its padded shape (every row of the
padded batch is paid, as a replay pays it):

- FLOPs, 2 per multiply-add: each layer's projections and MLP on every
  token of the key (for MoE only the routed ``k`` of ``E`` experts, the
  router, and the shared experts); the LM head on the rows that sample
  (one per row and forward); attention over each row's context, with
  contexts at the table width ``mp x page_size``, causal inside a
  prefill window, clipped by a sliding window.
- Bytes: every weight read once per forward at the model's dtype (for
  MoE ``min(E, N k)`` experts' weights, N the forward's tokens; of the
  embedding only the N rows looked up); the K/V (under MLA the latent
  row) read over each row's context and written for its new tokens; the
  float32 logits written.

``forward_cost_parts`` returns the GEMM and attention FLOPs apart (the
tests hold the GEMM part to ``torch.utils.flop_counter`` over the plain
forward, exactly).
"""

from __future__ import annotations

from typing import Dict, List

from xllm_service_tpu_torch.config import ModelConfig

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's sliding window (0 = full attention)."""
    if cfg.layer_sliding is None:
        return [cfg.sliding_window or 0] * cfg.num_layers
    return [cfg.sliding_window if s else 0 for s in cfg.layer_sliding]


def _keys(context: int, window: int) -> int:
    """Keys one query at the end of ``context`` tokens attends to."""
    return min(context, window) if window else context


def _attn_macs_per_key(cfg: ModelConfig) -> int:
    """Multiply-adds per (query token, key) of one layer: scores and the
    weighted sum of values, over every query head. Under MLA the scores
    run over the latent row (rank + rope) and the values over the rank
    (the absorbed form)."""
    if cfg.mla:
        return cfg.num_heads * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return 2 * cfg.num_heads * cfg.head_dim


def _kv_bytes_per_token(cfg: ModelConfig, wbytes: int) -> int:
    """Pool bytes of one token in one layer: K and V, or the latent
    row."""
    if cfg.mla:
        return cfg.kv_cache_dim * wbytes
    return 2 * cfg.num_kv_heads * cfg.head_dim * wbytes


def _moe_layers(cfg: ModelConfig) -> int:
    if not cfg.is_moe:
        return 0
    return cfg.num_layers - (cfg.first_k_dense_replace if cfg.mla else 0)


def _per_token_layer_params(cfg: ModelConfig, moe: bool) -> Dict[str, int]:
    """Weights of one layer, split into what every token multiplies
    ("dense": attention projections, a dense MLP, the router and shared
    experts) and one routed expert ("expert"), and the norms."""
    D = cfg.hidden_size
    Hq = cfg.num_heads
    if cfg.mla:
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        qd = Hq * cfg.qk_head_dim
        attn = (D * cfg.q_lora_rank + cfg.q_lora_rank * qd
                if cfg.q_lora_rank else D * qd)
        attn += Hq * cfg.qk_nope_head_dim * r       # absorbed key side
        attn += D * (r + rope)                      # kv_a
        attn += Hq * cfg.v_head_dim * r             # absorbed value side
        attn += Hq * cfg.v_head_dim * D             # o_proj
        norms = 2 * D + r + (cfg.q_lora_rank or 0)
    else:
        Dh = cfg.head_dim
        attn = D * Hq * Dh + 2 * D * cfg.num_kv_heads * Dh + Hq * Dh * D
        norms = (4 if cfg.gemma else 2) * D
        if cfg.qk_norm:
            norms += 2 * Dh
    Fi = cfg.intermediate_size
    if not moe:
        return {"dense": attn + 3 * D * Fi, "expert": 0, "norms": norms}
    Fe = cfg.moe_intermediate_size or Fi
    dense = attn + D * cfg.num_experts
    if cfg.mla and cfg.n_shared_experts:
        dense += 3 * D * Fe * cfg.n_shared_experts
    return {"dense": dense, "expert": 3 * D * Fe, "norms": norms}


def forward_cost_parts(cfg: ModelConfig, program: str, B: int, T: int,
                       mp: int, page_size: int,
                       decode_steps: int = 1) -> Dict[str, float]:
    """The count of ``forward_cost`` with its FLOPs split into
    ``gemm_flops`` (projections, MLP, router, experts, LM head) and
    ``attn_flops`` (scores and values), and ``weight_bytes`` /
    ``kv_bytes`` / ``logit_bytes`` apart.

    ``program``: ``prefill`` / ``ragged`` (B rows of a T-token window,
    the window at the end of a context of max(mp x page_size, T)) or
    ``decode`` / ``decode_multi`` (B rows of one token at a context of
    mp x page_size, ``decode_steps`` forwards for ``decode_multi``)."""
    if program in ("prefill", "ragged"):
        forwards, q_len = 1, T
    elif program == "decode":
        forwards, q_len = 1, 1
    elif program == "decode_multi":
        forwards, q_len = max(1, decode_steps), 1
    else:
        raise ValueError(f"unknown program {program!r}")
    wbytes = _DTYPE_BYTES.get(cfg.dtype, 2)
    D, V = cfg.hidden_size, cfg.vocab_size
    context = max(mp * page_size, q_len)
    N = B * q_len                       # tokens of one forward
    n_moe = _moe_layers(cfg)
    dense_layer = _per_token_layer_params(cfg, moe=False)
    moe_layer = _per_token_layer_params(cfg, moe=True) if n_moe else None
    k = cfg.num_experts_per_tok
    macs = 0
    weights = 0
    for moe, n in ((False, cfg.num_layers - n_moe), (True, n_moe)):
        if not n:
            continue
        lw = moe_layer if moe else dense_layer
        macs += n * N * (lw["dense"] + (k * lw["expert"] if moe else 0))
        experts = min(cfg.num_experts, N * k) if moe else 0
        weights += n * (lw["dense"] + experts * lw["expert"] + lw["norms"])
    macs += B * D * V                   # the LM head, one row per row
    weights += D * V + D + N * D        # head, final norm, embed rows
    attn_macs = 0
    kv_tokens_read = 0
    per_key = _attn_macs_per_key(cfg)
    for w in _layer_windows(cfg):
        keys = sum(_keys(context - q_len + t + 1, w) for t in range(q_len))
        attn_macs += B * keys * per_key
        kv_tokens_read += B * _keys(context, w + q_len - 1 if w else 0)
    kv_bytes = (kv_tokens_read + cfg.num_layers * N) \
        * _kv_bytes_per_token(cfg, wbytes)
    logit_bytes = B * V * 4
    weight_bytes = weights * wbytes
    return {
        "gemm_flops": float(2 * macs * forwards),
        "attn_flops": float(2 * attn_macs * forwards),
        "weight_bytes": float(weight_bytes * forwards),
        "kv_bytes": float(kv_bytes * forwards),
        "logit_bytes": float(logit_bytes * forwards),
        "tokens": float(N * forwards),
    }


def forward_cost(cfg: ModelConfig, program: str, B: int, T: int, mp: int,
                 page_size: int, decode_steps: int = 1) -> Dict[str, float]:
    """{"flops", "bytes", "tokens"} of one program at its padded shape
    (module docstring): the numerators of the roofline table."""
    p = forward_cost_parts(cfg, program, B, T, mp, page_size, decode_steps)
    return {"flops": p["gemm_flops"] + p["attn_flops"],
            "bytes": p["weight_bytes"] + p["kv_bytes"] + p["logit_bytes"],
            "tokens": p["tokens"]}
