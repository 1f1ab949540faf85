"""Sharding rules: which dimension of each parameter and of the KV pool
lies over which mesh axis, and the slicing of a full parameter tree to
one rank's shard.

The counterpart of the JAX package's ``parallel/sharding.py``, with its
rule tables: Megatron-style tensor parallelism (q/k/v, gate and up over
``tp`` on their output features, o and down on their input features),
the vocabulary of the embedding and of ``lm_head`` over ``tp``, experts
over ``ep`` (and their feature axes over ``tp``), KV heads over ``tp``
when they divide it. A rule reads "dimension d over axis a"; a leaf
takes the rule of its name whose rank matches its own (MoE expert
stacks and dense MLPs share names), as the JAX ``spec_for`` picks it.

GSPMD fixes the meaning of every leaf JAX leaves replicated; here that
is done by hand, and the model (``models/transformer.py``) follows
these rules:

- per-head leaves that JAX replicates are sliced to the rank's own heads
  (GPT-OSS ``sinks``; under MLA ``q_b``, ``kv_b_k``, ``kv_b_v``);
- leaves added after a row-parallel product (``o_bias``, the shared
  experts, MLA's replicated leaves) stay whole and are added once, after
  the reduce; a routed expert's ``down_bias`` is added on the ``tp``
  rank 0 of its expert only;
- the router (``router``, ``router_bias``) stays whole on every rank: the
  routing and the dispatch are global, as in the JAX ``moe_mlp`` (JAX
  lays the router over ``ep`` and gathers it back for the top-k);
- KV heads that do not divide ``tp`` are replicated over it: each rank
  holds a copy of the KV heads its query heads read (one head when tp
  is a multiple of the KV head count: MQA, or ``tiny`` at tp = 4), as
  GQA KV heads are duplicated across tp subgroups; a KV head count that
  neither divides tp nor is divided by it is refused.

``dp`` is a replica axis: every dp rank holds the same shard and runs
the same steps (the JAX package defines a ``batch_pspec`` over dp, but
its engine never applies it, so none is copied).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.parallel.mesh import (AXIS_EP, AXIS_TP, Mesh,
                                                  MeshSpec)


class Rule(NamedTuple):
    """Dimension ``dim`` of a leaf of rank ``ndim`` over mesh ``axis``."""
    ndim: int
    dim: int
    axis: str


# Per-leaf rules; layer weights carry a leading stacked-L axis (never
# sharded: the layer loop walks it).
_LAYER_RULES: Dict[str, Rule] = {
    "q_proj": Rule(3, 2, AXIS_TP),
    "k_proj": Rule(3, 2, AXIS_TP),
    "v_proj": Rule(3, 2, AXIS_TP),
    "q_bias": Rule(2, 1, AXIS_TP),
    "k_bias": Rule(2, 1, AXIS_TP),
    "v_bias": Rule(2, 1, AXIS_TP),
    "o_proj": Rule(3, 1, AXIS_TP),
    # Dense MLP.
    "gate_proj": Rule(3, 2, AXIS_TP),
    "up_proj": Rule(3, 2, AXIS_TP),
    "down_proj": Rule(3, 1, AXIS_TP),
}
# MoE expert stacks [L, E, ...]: experts over ep, features over tp (the
# second rule of a leaf; the 4-D shapes override the dense rules).
_MOE_LAYER_RULES: Dict[str, Tuple[Rule, ...]] = {
    "gate_proj": (Rule(4, 1, AXIS_EP), Rule(4, 3, AXIS_TP)),
    "up_proj": (Rule(4, 1, AXIS_EP), Rule(4, 3, AXIS_TP)),
    "down_proj": (Rule(4, 1, AXIS_EP), Rule(4, 2, AXIS_TP)),
    "gate_bias": (Rule(3, 1, AXIS_EP), Rule(3, 2, AXIS_TP)),
    "up_bias": (Rule(3, 1, AXIS_EP), Rule(3, 2, AXIS_TP)),
    "down_bias": (Rule(3, 1, AXIS_EP),),
}
# Per-head leaves JAX replicates, sliced here to the rank's heads
# (dimension d of a leaf of rank n, in units of whole heads).
_HEAD_RULES: Dict[str, Rule] = {
    "sinks": Rule(2, 1, AXIS_TP),
    "q_b": Rule(3, 2, AXIS_TP),
    "kv_b_k": Rule(4, 1, AXIS_TP),
    "kv_b_v": Rule(4, 1, AXIS_TP),
}
_KV_LEAVES = ("k_proj", "v_proj", "k_bias", "v_bias")
EMBED_RULE = Rule(2, 0, AXIS_TP)          # [V, D]: vocabulary over tp
LM_HEAD_RULE = Rule(2, 1, AXIS_TP)        # [D, V]


def kv_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether the KV heads split over ``tp`` (else they are replicated).
    MLA's single latent head never splits."""
    return tp > 1 and not cfg.mla and cfg.num_kv_heads % tp == 0


def kv_cache_pspec(cfg: ModelConfig, tp_size: int = 1
                   ) -> Tuple[Optional[str], ...]:
    """The KV pools [L, pages, page_size, Hkv, Dh], one axis (or None)
    per dimension: KV heads over tp when they split, else replicated."""
    if kv_split(cfg, tp_size):
        return (None, None, None, AXIS_TP, None)
    return (None, None, None, None, None)


def _check_heads(cfg: ModelConfig, tp: int) -> None:
    if tp == 1:
        return
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.num_heads} query heads do not "
                         f"split over tp={tp}")
    if not cfg.mla and cfg.num_kv_heads % tp and tp % cfg.num_kv_heads:
        raise ValueError(
            f"{cfg.name}: {cfg.num_kv_heads} KV heads neither split over "
            f"tp={tp} nor replicate across it")
    if cfg.vocab_size % tp:
        raise ValueError(f"{cfg.name}: vocabulary {cfg.vocab_size} does "
                         f"not split over tp={tp}")


def shard_config(cfg: ModelConfig, spec: MeshSpec) -> ModelConfig:
    """The model as one rank sees it: its query heads, its KV heads (the
    copy it holds when they are replicated), the head width unchanged.
    Everything else (the vocabulary, the expert count, the widths) is
    the full model's: the weights' shapes carry the rest."""
    tp = spec.tp
    _check_heads(cfg, tp)
    if spec.ep > 1 and cfg.num_experts % spec.ep:
        raise ValueError(f"{cfg.name}: {cfg.num_experts} experts do not "
                         f"split over ep={spec.ep}")
    if tp == 1:
        return cfg
    hq = cfg.num_heads // tp
    if cfg.mla:
        hkv = hq
    else:
        hkv = (cfg.num_kv_heads // tp if kv_split(cfg, tp)
               else max(1, cfg.num_kv_heads * hq // cfg.num_heads))
    return dataclasses.replace(cfg, num_heads=hq, num_kv_heads=hkv,
                               head_dim=cfg.head_dim)


def _slice(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    step = size // n
    return x.narrow(dim, index * step, step)


def _kv_slice(x: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
              dim: int) -> torch.Tensor:
    """A k/v projection or bias: its columns over tp when the KV heads
    split, else the columns of the KV head(s) the rank's query heads
    read."""
    tp, r = mesh.size(AXIS_TP), mesh.index(AXIS_TP)
    if kv_split(cfg, tp):
        return _slice(x, dim, r, tp)
    # tp is a multiple of Hkv: each KV head serves tp / Hkv ranks.
    per = tp // cfg.num_kv_heads
    return _slice(x, dim, r // per, cfg.num_kv_heads)


def leaf_rules(name: str, ndim: int, cfg: ModelConfig) -> Tuple[Rule, ...]:
    """The rules a leaf of ``name`` and rank ``ndim`` takes (empty:
    replicated)."""
    if name == "embed":
        return (EMBED_RULE,)
    if name == "lm_head":
        return (LM_HEAD_RULE,)
    if cfg.is_moe and name in _MOE_LAYER_RULES:
        rules = _MOE_LAYER_RULES[name]
        if rules[0].ndim == ndim:
            return rules
    rule = _LAYER_RULES.get(name)
    if rule is not None and rule.ndim == ndim:
        return (rule,)
    rule = _HEAD_RULES.get(name)
    if rule is not None and rule.ndim == ndim:
        return (rule,)
    return ()


def shard_leaf(name: str, x: torch.Tensor, mesh: Mesh,
               cfg: ModelConfig) -> torch.Tensor:
    """One leaf of the full tree sliced to this rank's shard (a copy, so
    that the full leaf can be freed)."""
    rules = leaf_rules(name, x.dim(), cfg)
    if not rules:
        return x
    for rule in rules:
        if mesh.size(rule.axis) == 1:
            continue
        if name in _KV_LEAVES and rule.axis == AXIS_TP:
            x = _kv_slice(x, cfg, mesh, rule.dim)
        else:
            x = _slice(x, rule.dim, mesh.index(rule.axis),
                       mesh.size(rule.axis))
    return x.contiguous().clone()


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 cfg: ModelConfig) -> Dict[str, Any]:
    """The full parameter tree sliced to this rank's shard, leaf by leaf
    by ``leaf_rules`` (a new tree; the full one is not changed)."""
    _check_heads(cfg, mesh.size(AXIS_TP))

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return shard_leaf(name, tree, mesh, cfg)
        return tree
    return walk(params)


def shard_kv_cache(kv, mesh: Mesh, cfg: ModelConfig):
    """Full KV pools [L, P, ps, Hkv, D] sliced to the heads this rank
    holds (all of them under MLA)."""
    tp = mesh.size(AXIS_TP)
    if tp == 1 or cfg.mla:
        return tuple(kv)
    out = []
    for x in kv:
        if kv_split(cfg, tp):
            x = _slice(x, 3, mesh.index(AXIS_TP), tp)
        else:
            x = _slice(x, 3, mesh.index(AXIS_TP) // (tp // cfg.num_kv_heads),
                       cfg.num_kv_heads)
        out.append(x.contiguous().clone())
    return tuple(out)
