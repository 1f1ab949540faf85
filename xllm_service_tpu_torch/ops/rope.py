"""Rotary position embeddings: the Llama/Qwen "neox" half-rotation
layout, and DeepSeek's adjacent-pair rotation for its rope sub-head.

Cos/sin come from integer positions on the fly, in float32. ``scaling``
is the hashable tuple ``ModelConfig.rope_scaling`` carries:
``("llama3", factor, low_freq, high_freq, original_max_pos)``,
``("linear", factor, 0, 0, 0)`` or ``("yarn", factor, beta_fast,
beta_slow, original_max_pos, attention_factor, truncate,
mscale_all_dim)``; None is unscaled. The 3-D multimodal rope is not part
of this package yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

RopeScaling = Tuple  # ("llama3", f, lo, hi, orig) | ("linear", f, 0, 0, 0)
#   | ("yarn", factor, beta_fast, beta_slow, orig, attn_factor, truncate,
#      mscale_all_dim)


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
    if kind == "yarn":
        # NTK-by-parts (YaRN section 3.2): bands doing more than
        # beta_fast rotations over the original context keep their
        # frequency, fewer than beta_slow are slowed by `factor`, a
        # linear ramp blends the bands between. The attention factor is
        # applied to cos/sin (rope_cos_sin).
        (_, factor, beta_fast, beta_slow, orig, _attn,
         truncate) = scaling[:7]

        def correction_dim(rot):
            return (head_dim * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(theta)))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0.0), min(high, head_dim - 1.0)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(half, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0.0, 1.0)
        extrap_w = 1.0 - ramp
        return inv / factor * (1.0 - extrap_w) + inv * extrap_w
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not supported by this package")


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[RopeScaling] = None):
    """float32 cos/sin for integer ``positions`` (any shape), with a
    trailing ``head_dim/2`` axis. YaRN's attention factor scales both."""
    freq = rope_inv_freq(head_dim, theta, scaling, device=positions.device)
    angles = positions.float()[..., None] * freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scaling is not None and scaling[0] == "yarn":
        cos, sin = cos * scaling[5], sin * scaling[5]
    return cos, sin


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


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           theta: float,
                           scaling: Optional[RopeScaling] = None
                           ) -> torch.Tensor:
    """Adjacent-pair rotation: (x[2i], x[2i+1]) rotate by angle i, the
    convention of DeepSeek's rope sub-head. ``x`` is [..., seq, dim] or
    [..., seq, heads, dim]; ``positions`` [..., seq]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling)
    return rotate_interleaved(x, cos, sin)


def rotate_interleaved(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair rotation of ``x`` [..., seq, (heads,) dim] by
    precomputed float32 ``cos``/``sin`` [..., seq, dim/2]."""
    if x.dim() == cos.dim() + 1:     # head axis present
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope_for(cfg_scaling, x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """Model-level dispatch for 1-D positions (the multimodal 3-D rope
    of the JAX package is not ported)."""
    if cfg_scaling is not None and cfg_scaling[0] == "mrope":
        raise NotImplementedError("mrope is not supported by this package")
    return apply_rope(x, positions, theta, cfg_scaling)
