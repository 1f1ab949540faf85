"""Rotary position embeddings: the Llama/Qwen "neox" half-rotation
layout, and DeepSeek's adjacent-pair rotation for its rope sub-head.

Cos/sin come from integer positions on the fly, in float32. ``scaling``
is the hashable tuple ``ModelConfig.rope_scaling`` carries:
``("llama3", factor, low_freq, high_freq, original_max_pos)``,
``("linear", factor, 0, 0, 0)`` or ``("yarn", factor, beta_fast,
beta_slow, original_max_pos, attention_factor, truncate,
mscale_all_dim)``, or ``("mrope", (s_t, s_h, s_w))``; None is unscaled.

The Qwen2-VL multimodal rope (``apply_mrope``) rotates by three position
streams (temporal, height, width), each owning a contiguous section of
the half axis's frequency bands. ``mrope_cos_sin`` builds its cos/sin
tables [..., T, head_dim/2] in the same float32 layout as
``rope_cos_sin``: the fused rope + KV-write kernels take them unchanged.
Text tokens carry equal streams, which is exactly standard rope.

Gemma-3 rotates by a base per layer type (the JAX package's
``_layer_rope`` and ``apply_rope_dynamic``): ``layer_rope`` is the
``[L]`` (theta, linear factor) table from the config, and
``layer_cos_sin`` makes one cos/sin set per distinct row (two for
Gemma-3: local and global) from the same positions, shared by every
layer of its type.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

RopeScaling = Tuple  # ("llama3", f, lo, hi, orig) | ("linear", f, 0, 0, 0)
#   | ("mrope", (s_t, s_h, s_w))
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
    if kind == "mrope":
        return inv          # the sections select streams; bands unscaled
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


def layer_rope(cfg) -> Optional[List[Tuple[float, float]]]:
    """[L] (theta, linear factor) per layer when the rope base differs by
    layer type (Gemma-3), else None (JAX ``_layer_rope``): sliding layers
    use ``rope_local_base_freq`` unscaled, full layers ``rope_theta``
    with the linear factor. A uniform model is all local when it has a
    window, else all global."""
    if cfg.rope_local_base_freq is None:
        return None
    factor = (float(cfg.rope_scaling[1])
              if cfg.rope_scaling is not None
              and cfg.rope_scaling[0] == "linear" else 1.0)
    pattern = cfg.layer_sliding
    if pattern is None:
        pattern = (cfg.sliding_window is not None,) * cfg.num_layers
    return [(float(cfg.rope_local_base_freq), 1.0) if s
            else (float(cfg.rope_theta), factor) for s in pattern]


def rope_cos_sin_dynamic(positions: torch.Tensor, head_dim: int,
                         theta: float, factor: float):
    """float32 cos/sin of the half-rotation rope at base ``theta`` with
    positions divided by ``factor`` (JAX ``apply_rope_dynamic``)."""
    return rope_cos_sin(positions, head_dim, theta,
                        None if factor == 1.0
                        else ("linear", factor, 0.0, 0.0, 0))


def layer_cos_sin(cfg, positions: torch.Tensor) -> List[Tuple[torch.Tensor,
                                                              torch.Tensor]]:
    """Each layer's float32 (cos, sin) for ``positions``: one set for a
    model with one base (``rope_cos_sin`` with the config's scaling),
    one set per distinct ``layer_rope`` row otherwise, the same tensors
    shared by every layer of a row."""
    rows = layer_rope(cfg)
    if rows is None:
        cs = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                          cfg.rope_scaling)
        return [cs] * cfg.num_layers
    sets = {r: rope_cos_sin_dynamic(positions, cfg.head_dim, *r)
            for r in dict.fromkeys(rows)}
    return [sets[r] for r in rows]


def apply_rope_dynamic(x: torch.Tensor, positions: torch.Tensor,
                       theta: float, factor: float) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] at base ``theta`` with a
    linear ``factor`` (JAX ``apply_rope_dynamic``)."""
    cos, sin = rope_cos_sin_dynamic(positions, x.shape[-1], theta, factor)
    return rotate(x, cos, sin)


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


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]):
    """The sectioned float32 cos/sin tables of the multimodal rope:
    ``positions3`` [..., 3, T] (temporal, height, width streams) ->
    [..., T, head_dim/2] each, band j taking the stream of the section
    it falls in (``sections`` sums to head_dim/2)."""
    freq = rope_inv_freq(head_dim, theta, device=positions3.device)
    ang = positions3.float()[..., None] * freq          # [..., 3, T, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    parts_c, parts_s, off = [], [], 0
    for i, s in enumerate(sections):
        parts_c.append(cos[..., i, :, off:off + s])
        parts_s.append(sin[..., i, :, off:off + s])
        off += s
    return torch.cat(parts_c, dim=-1), torch.cat(parts_s, dim=-1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Rotate ``x`` [..., T, heads, head_dim] by the three position
    streams ``positions3`` [..., 3, T] (the JAX package's
    ``apply_mrope``)."""
    cos, sin = mrope_cos_sin(positions3, x.shape[-1], theta, sections)
    return rotate(x, cos, sin)


def rope_for(cfg_scaling, x: torch.Tensor, positions: torch.Tensor,
             theta: float, positions3: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Model-level dispatch: standard or scaled rope for 1-D positions,
    the multimodal rope when the config carries sections (its streams
    broadcast from ``positions`` when ``positions3`` is None: standard
    rope by construction)."""
    if cfg_scaling is not None and cfg_scaling[0] == "mrope":
        if positions3 is None:
            positions3 = positions.unsqueeze(-2).expand(
                *positions.shape[:-1], 3, positions.shape[-1])
        return apply_mrope(x, positions3, theta, cfg_scaling[1])
    return apply_rope(x, positions, theta, cfg_scaling)
