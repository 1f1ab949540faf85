"""Mixture-of-experts dispatch: grouped top-k routing into capacity
buckets.

The counterpart of the JAX package's ``parallel/expert.py`` on one
device. Tokens are processed in groups of ``group_size``
(``ModelConfig.moe_group_size``); each group routes into its own
``[G, E, C_g]`` buckets with ``C_g = capacity(G, E, k, factor)``, so an
expert accepts at most ``C_g`` tokens per group. Buckets fill in token
order; a token routed past a full expert loses that expert's share and,
with ``norm_topk``, renormalizes over the experts it kept. Padding and
inactive tokens route nowhere and take no capacity. Dropped (token,
expert) assignments are counted.

Everything is plain PyTorch: the dispatch and combine masks are
``[groups, G, E, C]`` tensors and the expert MLPs are batched matrix
products over the expert axis (``torch.einsum``), as the JAX package
leaves them to XLA. Every expert's weights are read once per call,
whatever the routing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def capacity(group_tokens: int, num_experts: int, k: int,
             factor: float) -> int:
    """Per-expert bucket size of one group: >= 1, a multiple of 8 and at
    most ``group_tokens``."""
    c = int(group_tokens * k * factor / num_experts) + 1
    c = -(-c // 8) * 8
    return min(c, group_tokens)


def topk_dispatch(gates: torch.Tensor, k: int, cap: int,
                  valid: Optional[torch.Tensor] = None,
                  norm_topk: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route each token of a group to its top-``k`` experts with capacity
    ``cap``.

    gates: [..., N, E] float32 routing scores (leading axes are groups);
    ``valid`` [..., N] bool keeps padding / inactive tokens out of
    routing. Returns ``dispatch`` [..., N, E, C] (0/1 token -> bucket
    slot) and ``combine`` [..., N, E, C] (dispatch x routing weight).
    A token's slot in an expert's bucket is the count of earlier
    assignments to that expert, ranks first: every token's first choice
    precedes every second choice, and within a rank earlier tokens come
    first (the JAX package's per-rank cumsum, here one cumsum over the
    rank-major assignments)."""
    E = gates.shape[-1]
    topv, topi = torch.topk(gates, k, dim=-1)               # [..., N, k]
    if norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    oh = F.one_hot(topi.transpose(-1, -2), E)               # [..., k, N, E]
    if valid is not None:
        oh = oh * valid.long()[..., None, :, None]
    flat = oh.flatten(-3, -2)                               # [..., k*N, E]
    earlier = (flat.cumsum(dim=-2) - flat).reshape(oh.shape)
    # A token picks an expert at most once, so one rank at most is
    # nonzero per (token, expert) and the sums over ranks pick it out.
    routed = oh.sum(dim=-3)                                 # [..., N, E]
    slot = (earlier * oh).sum(dim=-3)
    weight = (oh * topv.transpose(-1, -2)[..., None]).sum(dim=-3)
    keep = (routed > 0) & (slot < cap)
    # Dropped and unrouted pairs one-hot into the extra slot `cap`, which
    # is cut off.
    dispatch = F.one_hot(torch.where(keep, slot, torch.full_like(slot, cap)),
                         cap + 1)[..., :cap].to(gates.dtype)
    combine = dispatch * weight[..., None]
    if norm_topk:
        # Renormalize over the surviving experts, so that a token that
        # lost one to capacity does not shrink toward zero.
        w = combine.sum(dim=(-2, -1), keepdim=True)
        combine = torch.where(w > 0, combine / w.clamp(min=1e-9), combine)
    return dispatch, combine


def gptoss_glu(hg: torch.Tensor, hu: torch.Tensor) -> torch.Tensor:
    """GPT-OSS's clamped GLU of the gate and up projections."""
    hg = hg.clamp(max=7.0)
    hu = hu.clamp(-7.0, 7.0)
    return (hu + 1.0) * (hg * torch.sigmoid(1.702 * hg))


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, gate_w: torch.Tensor,
            up_w: torch.Tensor, down_w: torch.Tensor, k: int,
            capacity_factor: float = 2.0,
            valid: Optional[torch.Tensor] = None,
            group_size: int = 512, norm_topk: bool = True,
            gates: Optional[torch.Tensor] = None,
            expert_style: str = "swiglu",
            gate_b: Optional[torch.Tensor] = None,
            up_b: Optional[torch.Tensor] = None,
            down_b: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse gated MoE layer, group by group.

    x: [B, T, D]; router_w [D, E]; gate/up [E, D, F]; down [E, F, D];
    ``valid`` [B, T] bool marks real tokens. Tokens flatten to [N, D] and
    pad to a multiple of the group size (padding is invalid). ``gates``
    [B, T, E] is a caller-selected routing map with exactly k nonzero
    weights per token (DeepSeek's gate, scaling applied, or GPT-OSS's
    softmax over its chosen logits; ``norm_topk`` must then be False);
    without it the router's softmax routes. ``expert_style``: "swiglu"
    (silu(gate) * up) or "gptoss" (the clamped GLU: gate <= 7, up in
    [-7, 7], (up + 1) * gate * sigmoid(1.702 * gate)). ``gate_b`` /
    ``up_b`` [E, F] and ``down_b`` [E, D] are per-expert biases; the
    down bias rides the combine weights with the rest of the expert's
    output. Returns ``(out [B, T, D], dropped)``, ``dropped`` the int64
    count of (token, expert) assignments lost to capacity."""
    B, T, D = x.shape
    N = B * T
    E = router_w.shape[-1]
    xf = x.reshape(N, D)
    vf = (torch.ones(N, dtype=torch.bool, device=x.device) if valid is None
          else valid.reshape(N).bool())
    G = min(group_size, N)
    pad = (-N) % G
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        vf = F.pad(vf, (0, pad))
    n_g = (N + pad) // G
    xg = xf.reshape(n_g, G, D)
    vg = vf.reshape(n_g, G)
    if gates is None:
        gates = torch.softmax((xg @ router_w).float(), dim=-1)
    else:
        gf = gates.reshape(N, -1).float()
        if pad:
            gf = F.pad(gf, (0, 0, 0, pad))
        gates = gf.reshape(n_g, G, -1)
    cap = capacity(G, E, k, capacity_factor)
    dispatch, combine = topk_dispatch(gates, k, cap, vg, norm_topk)
    x_e = torch.einsum("gnd,gnec->gecd", xg, dispatch.to(x.dtype))
    hg = torch.einsum("gecd,edf->gecf", x_e, gate_w)
    hu = torch.einsum("gecd,edf->gecf", x_e, up_w)
    if gate_b is not None:
        hg = hg + gate_b[None, :, None, :]
    if up_b is not None:
        hu = hu + up_b[None, :, None, :]
    h = gptoss_glu(hg, hu) if expert_style == "gptoss" else F.silu(hg) * hu
    y_e = torch.einsum("gecf,efd->gecd", h, down_w)        # [g, E, C, D]
    if down_b is not None:
        y_e = y_e + down_b[None, :, None, :]
    out = torch.einsum("gecd,gnec->gnd", y_e, combine.to(x.dtype))
    out = out.reshape(-1, D)[:N].reshape(B, T, D)
    # Every valid token asks for k experts; the rest were dropped.
    dropped = k * vf.sum() - dispatch.sum().long()
    return out, dropped
