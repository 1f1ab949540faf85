"""Rotary position embeddings (Llama/Qwen "neox" half-rotation layout).

Cos/sin come from integer positions on the fly, in float32. ``scaling``
is the hashable tuple ``ModelConfig.rope_scaling`` carries:
``("llama3", factor, low_freq, high_freq, original_max_pos)`` or
``("linear", factor, 0, 0, 0)``; None is unscaled. The 3-D multimodal
rope and YaRN are not part of this package yet and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

RopeScaling = Tuple  # ("llama3", f, lo, hi, orig) | ("linear", f, 0, 0, 0)


def rope_inv_freq(head_dim: int, theta: float,
                  scaling: Optional[RopeScaling] = None,
                  device=None) -> torch.Tensor:
    """Per-band inverse frequencies [head_dim/2], float32, with the
    checkpoint's frequency scaling applied."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    inv = 1.0 / (theta ** exps)
    if scaling is None:
        return inv
    kind = scaling[0]
    if kind == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * math.pi / inv
        # Three bands by wavelength vs the original training context:
        # short waves untouched, long waves slowed by `factor`, the
        # band between interpolated.
        smooth = ((orig / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        scaled = (1.0 - smooth) * inv / factor + smooth * inv
        return torch.where(wavelen > orig / low_f, inv / factor,
                           torch.where(wavelen < orig / high_f, inv, scaled))
    if kind == "linear":
        return inv / float(scaling[1])
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not supported by this package")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[RopeScaling] = None):
    """float32 cos/sin for integer ``positions`` (any shape), with a
    trailing ``head_dim/2`` axis."""
    freq = rope_inv_freq(head_dim, theta, scaling, device=positions.device)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation of ``x`` [..., seq, (heads,) dim] by precomputed
    float32 ``cos``/``sin`` [..., seq, dim/2] (``rope_cos_sin``)."""
    half = x.shape[-1] // 2
    if x.dim() == cos.dim() + 1:     # head axis present: [..., seq, H, dim]
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by ``positions``
    [..., seq]: the first half of head_dim pairs with the second."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling)
    return rotate(x, cos, sin)


def rope_for(cfg_scaling, x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """Model-level dispatch for 1-D positions (the multimodal 3-D rope
    of the JAX package is not ported)."""
    if cfg_scaling is not None and cfg_scaling[0] == "mrope":
        raise NotImplementedError("mrope is not supported by this package")
    return apply_rope(x, positions, theta, cfg_scaling)
