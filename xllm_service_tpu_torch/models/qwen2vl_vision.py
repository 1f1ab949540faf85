"""The Qwen2-VL and Qwen2.5-VL vision towers (the JAX package's
``models/qwen2vl_vision.py``), for a model directory that carries one.

- The Conv3D patch embedding (kernel = stride over pre-flattened
  patches) is one matmul on [C * tp * P * P] rows.
- 2-D rotary embeddings: per-patch (h, w) ids in the merge-block-major
  order the HF image processor emits; half of each head rotates by the
  h frequencies, half by the w ones.
- Qwen2-VL blocks: LayerNorm, biased qkv and proj, a QuickGELU MLP.
  Qwen2.5-VL blocks: RMSNorm, a biased SwiGLU MLP, and window attention
  (merge cells regrouped into square windows; the
  ``fullatt_block_indexes`` layers attend across the whole image), the
  merged rows restored to image order at the end.
- Per-image (per-frame) full attention by a segment-id equality mask.
- The PatchMerger: ln_q, each spatial_merge_size^2 consecutive patches
  concatenated, a 2-layer exact-GELU MLP into the language model's width.

The attention is plain PyTorch (einsum and softmax), as the JAX towers
run it through XLA: no Pallas kernel lies on a tower. Parameters are a
dict in the JAX tree's layout (per-block weights stacked over [depth],
``x @ W`` with ``W`` [in, out]) on an explicit device; matmuls run in
the parameters' dtype, norms, rope and softmax in float32. Grid
geometry (rope ids, segments, window order) is host numpy, computed once
per grid: the serving path resizes every image to one fixed grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from xllm_service_tpu_torch.ops.norm import layer_norm, rms_norm

Qwen2VLVisionParams = Dict[str, Any]

# The HF Qwen2VLImageProcessor's normalization (OPENAI_CLIP_MEAN/STD).
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    """``vision_config`` of a Qwen2-VL config.json, plus the serving
    side's fixed resize target (``image_size``)."""

    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    mlp_ratio: float = 4.0
    in_channels: int = 3
    hidden_size: int = 3584          # the language model's width (output)
    image_size: int = 224
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_image(self) -> int:
        """Merged tokens one fixed-grid image gives (the placeholder
        expansion's count)."""
        return self.grid_side ** 2 // self.spatial_merge_size ** 2

    @classmethod
    def from_hf_config(cls, d: Dict[str, Any],
                       image_size: int = 224) -> "Qwen2VLVisionConfig":
        """``d`` = config.json["vision_config"] of a qwen2_vl checkpoint.
        A resize target that does not tile into merged patches is refused
        here, at load."""
        _check_image_size(d, image_size)
        return cls(
            depth=d.get("depth", 32),
            embed_dim=d.get("embed_dim", 1280),
            num_heads=d.get("num_heads", 16),
            patch_size=d.get("patch_size", 14),
            temporal_patch_size=d.get("temporal_patch_size", 2),
            spatial_merge_size=d.get("spatial_merge_size", 2),
            mlp_ratio=d.get("mlp_ratio", 4.0),
            in_channels=d.get("in_channels", 3),
            hidden_size=d.get("hidden_size", 3584),
            image_size=image_size)

    @classmethod
    def tiny(cls, hidden_size: int = 48) -> "Qwen2VLVisionConfig":
        return cls(depth=2, embed_dim=64, num_heads=4, patch_size=4,
                   mlp_ratio=2.0, hidden_size=hidden_size, image_size=16)


def _check_image_size(d: Dict[str, Any], image_size: int) -> None:
    unit = d.get("patch_size", 14) * d.get("spatial_merge_size", 2)
    if image_size <= 0 or image_size % unit != 0:
        raise ValueError(
            f"vision image_size {image_size} must be a positive "
            f"multiple of patch_size*spatial_merge_size ({unit})")


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    """``vision_config`` of a Qwen2.5-VL config.json."""

    depth: int = 32
    embed_dim: int = 1280            # vision_config.hidden_size
    num_heads: int = 16
    intermediate_size: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_size: int = 3584          # out_hidden_size (the LM's width)
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    image_size: int = 224
    dtype: str = "float32"

    head_dim = Qwen2VLVisionConfig.head_dim
    patch_dim = Qwen2VLVisionConfig.patch_dim
    grid_side = Qwen2VLVisionConfig.grid_side
    tokens_per_image = Qwen2VLVisionConfig.tokens_per_image

    @classmethod
    def from_hf_config(cls, d: Dict[str, Any],
                       image_size: int = 224) -> "Qwen25VLVisionConfig":
        _check_image_size(d, image_size)
        return cls(
            depth=d.get("depth", 32),
            embed_dim=d.get("hidden_size", 1280),
            num_heads=d.get("num_heads", 16),
            intermediate_size=d.get("intermediate_size", 3420),
            patch_size=d.get("patch_size", 14),
            temporal_patch_size=d.get("temporal_patch_size", 2),
            spatial_merge_size=d.get("spatial_merge_size", 2),
            in_channels=d.get("in_channels", 3),
            hidden_size=d.get("out_hidden_size", 3584),
            window_size=d.get("window_size", 112),
            fullatt_block_indexes=tuple(
                d.get("fullatt_block_indexes", (7, 15, 23, 31))),
            image_size=image_size)


def init_vision_params(cfg, generator: torch.Generator, device,
                       dtype: torch.dtype = None) -> Qwen2VLVisionParams:
    """Random weights in the tree the checkpoint reader gives (either
    tower), drawn in float32 from ``generator`` (on ``device``) and cast
    to ``dtype`` (default the config's). Norm weights are ones, biases
    zeros, as the JAX ``init_vision_params``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    D, L = cfg.embed_dim, cfg.depth
    M = D * cfg.spatial_merge_size ** 2

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    blocks = {"norm1_w": ones(L, D), "qkv_w": w((L, D, 3 * D), D),
              "qkv_b": zeros(L, 3 * D), "proj_w": w((L, D, D), D),
              "proj_b": zeros(L, D), "norm2_w": ones(L, D)}
    merger = {"ln_q_w": ones(D), "mlp0_w": w((M, M), M), "mlp0_b": zeros(M),
              "mlp2_w": w((M, cfg.hidden_size), M),
              "mlp2_b": zeros(cfg.hidden_size)}
    if isinstance(cfg, Qwen25VLVisionConfig):
        Fi = cfg.intermediate_size
        blocks.update(gate_w=w((L, D, Fi), D), gate_b=zeros(L, Fi),
                      up_w=w((L, D, Fi), D), up_b=zeros(L, Fi),
                      down_w=w((L, Fi, D), Fi), down_b=zeros(L, D))
    else:
        Fi = int(cfg.embed_dim * cfg.mlp_ratio)
        blocks.update(norm1_b=zeros(L, D), norm2_b=zeros(L, D),
                      fc1_w=w((L, D, Fi), D), fc1_b=zeros(L, Fi),
                      fc2_w=w((L, Fi, D), Fi), fc2_b=zeros(L, D))
        merger["ln_q_b"] = zeros(D)
    return {"patch_embed": w((cfg.patch_dim, D), cfg.patch_dim),
            "blocks": blocks, "merger": merger}


# ---------------------------------------------------------------------------
# Host-side geometry (numpy, once per grid)
# ---------------------------------------------------------------------------

def rot_pos_ids(grid_thw: Sequence[Tuple[int, int, int]],
                merge: int) -> np.ndarray:
    """Per-patch (h, w) position ids in the merge-block-major order the
    image processor flattens patches in (HF ``rot_pos_emb``) -> [S, 2]
    int32."""
    out: List[np.ndarray] = []
    for t, h, w in grid_thw:
        hp = np.broadcast_to(np.arange(h, dtype=np.int32)[:, None], (h, w))
        hp = hp.reshape(h // merge, merge, w // merge, merge) \
            .transpose(0, 2, 1, 3).reshape(-1)
        wp = np.broadcast_to(np.arange(w, dtype=np.int32)[None, :], (h, w))
        wp = wp.reshape(h // merge, merge, w // merge, merge) \
            .transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def segment_ids(grid_thw: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """[S] int32 attention segment per patch: each temporal frame is its
    own full-attention segment (HF's cu_seqlens)."""
    segs: List[np.ndarray] = []
    n = 0
    for t, h, w in grid_thw:
        for _ in range(t):
            segs.append(np.full(h * w, n, np.int32))
            n += 1
    return np.concatenate(segs)


def rotary_cos_sin(cfg, grid_thw: Sequence[Tuple[int, int, int]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [S, head_dim] float32: the first half of the angles from
    the h position, the second from w, then duplicated (the rotate_half
    layout, HF's cat((freqs, freqs)))."""
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32)
                                  / dim))
    ids = rot_pos_ids(grid_thw, cfg.spatial_merge_size)
    freqs = ids[:, :, None].astype(np.float32) * inv_freq[None, None, :]
    emb = freqs.reshape(ids.shape[0], -1)
    emb = np.concatenate([emb, emb], axis=-1)
    return np.cos(emb), np.sin(emb)


def flatten_image(pixels: np.ndarray, cfg, normalize: bool = True
                  ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """[H, W, 3] (or [T, H, W, 3]) in [0, 1] -> the flattened patch rows
    the tower takes, in the HF image processor's order (reshape to (t,
    tp, C, h/m, m, P, w/m, m, P), transpose (0, 3, 6, 4, 7, 2, 1, 5, 8)),
    and the grid (t, h, w). A lone frame is repeated to fill
    temporal_patch_size, as the processor does."""
    if pixels.ndim == 3:
        pixels = pixels[None]
    T, H, W, C = pixels.shape
    P, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    if normalize:
        pixels = (pixels.astype(np.float32) - CLIP_MEAN) / CLIP_STD
    x = pixels.transpose(0, 3, 1, 2)
    if T % tp:
        x = np.concatenate([x] + [x[-1:]] * (tp - T % tp), axis=0)
        T = x.shape[0]
    gt, gh, gw = T // tp, H // P, W // P
    x = x.reshape(gt, tp, C, gh // m, m, P, gw // m, m, P)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (x.reshape(gt * gh * gw, C * tp * P * P).astype(np.float32),
            (gt, gh, gw))


def window_order(cfg: Qwen25VLVisionConfig,
                 grid_thw: Sequence[Tuple[int, int, int]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(window_index [S/m^2], window segment ids [S]) (HF
    ``get_window_index``): merge cells regroup into square windows of
    window_size/merge/patch cells a side (ragged edges keep partial
    windows); the index permutes merge cells, the segment ids mark each
    patch's window in the permuted order."""
    m = cfg.spatial_merge_size
    win = cfg.window_size // m // cfg.patch_size
    order: List[np.ndarray] = []
    seg: List[np.ndarray] = []
    base = wid = 0
    for t, h, w in grid_thw:
        lh, lw = h // m, w // m
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % win, (-lw) % win
        padded = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)),
                        constant_values=-100)
        nh, nw = (lh + pad_h) // win, (lw + pad_w) // win
        padded = padded.reshape(t, nh, win, nw, win) \
            .transpose(0, 1, 3, 2, 4).reshape(t * nh * nw, win * win)
        for row in padded:
            cells = row[row != -100]
            if cells.size:
                order.append(cells + base)
                seg.append(np.full(cells.size * m * m, wid, np.int32))
                wid += 1
        base += t * lh * lw
    return (np.concatenate(order).astype(np.int32), np.concatenate(seg))


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------

def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attend(x: torch.Tensor, lp: Dict[str, torch.Tensor], i: int, cfg,
            cos: torch.Tensor, sin: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """One block's rotary, masked softmax attention over the whole
    sequence: h [S, D] -> the projected output [S, D]."""
    S = x.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    qkv = (x @ lp["qkv_w"][i] + lp["qkv_b"][i]).reshape(S, 3, H, Dh)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q32, k32 = q.float(), k.float()
    q = (q32 * cos + _rotate_half(q32) * sin).to(q.dtype)
    k = (k32 * cos + _rotate_half(k32) * sin).to(k.dtype)
    logits = torch.einsum("shd,thd->hst", q.float(), k.float()) \
        / math.sqrt(Dh)
    logits = torch.where(mask[None], logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    attn = torch.einsum("hst,thd->shd", p.to(v.dtype), v)
    return attn.reshape(S, -1) @ lp["proj_w"][i] + lp["proj_b"][i]


def _merge(x: torch.Tensor, mg: Dict[str, torch.Tensor], cfg,
           norm) -> torch.Tensor:
    """The PatchMerger: [S, D] -> [S/m^2, hidden_size]."""
    x = norm(x)
    x = x.reshape(x.shape[0] // cfg.spatial_merge_size ** 2, -1)
    x = F.gelu(x @ mg["mlp0_w"] + mg["mlp0_b"])
    return x @ mg["mlp2_w"] + mg["mlp2_b"]


def encode_patches(params: Qwen2VLVisionParams, cfg: Qwen2VLVisionConfig,
                   patches: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The Qwen2-VL tower: patches [S, C*tp*P*P] -> merged embeddings
    [S/m^2, hidden_size]. cos/sin [S, head_dim] and seg [S] come from
    ``rotary_cos_sin`` / ``segment_ids`` of the grid (on the params'
    device); merge blocks are consecutive in sequence order
    (``flatten_image``)."""
    bl = params["blocks"]
    dtype = bl["qkv_w"].dtype
    x = patches.to(dtype) @ params["patch_embed"]
    mask = seg[:, None] == seg[None, :]
    cos_h, sin_h = cos[:, None, :], sin[:, None, :]
    for i in range(cfg.depth):
        h = layer_norm(x, bl["norm1_w"][i], bl["norm1_b"][i])
        x = x + _attend(h, bl, i, cfg, cos_h, sin_h, mask)
        h = layer_norm(x, bl["norm2_w"][i], bl["norm2_b"][i])
        h = _quick_gelu(h @ bl["fc1_w"][i] + bl["fc1_b"][i])
        x = x + (h @ bl["fc2_w"][i] + bl["fc2_b"][i])
    mg = params["merger"]
    return _merge(x, mg, cfg,
                  lambda t: layer_norm(t, mg["ln_q_w"], mg["ln_q_b"]))


def encode_patches_v25(params: Qwen2VLVisionParams,
                       cfg: Qwen25VLVisionConfig, patches: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       seg_full: torch.Tensor, seg_win: torch.Tensor,
                       reverse_index: torch.Tensor) -> torch.Tensor:
    """The Qwen2.5-VL tower. patches, cos/sin and the segments arrive in
    window order (``window_order`` on the host); ``reverse_index``
    restores the merged rows at the end. Each layer attends within its
    window, the ``fullatt_block_indexes`` layers within the image."""
    bl = params["blocks"]
    dtype = bl["qkv_w"].dtype
    x = patches.to(dtype) @ params["patch_embed"]
    mask_full = seg_full[:, None] == seg_full[None, :]
    mask_win = seg_win[:, None] == seg_win[None, :]
    cos_h, sin_h = cos[:, None, :], sin[:, None, :]
    for i in range(cfg.depth):
        mask = mask_full if i in cfg.fullatt_block_indexes else mask_win
        h = rms_norm(x, bl["norm1_w"][i], 1e-6)
        x = x + _attend(h, bl, i, cfg, cos_h, sin_h, mask)
        h = rms_norm(x, bl["norm2_w"][i], 1e-6)
        h = F.silu(h @ bl["gate_w"][i] + bl["gate_b"][i]) \
            * (h @ bl["up_w"][i] + bl["up_b"][i])
        x = x + (h @ bl["down_w"][i] + bl["down_b"][i])
    mg = params["merger"]
    x = _merge(x, mg, cfg, lambda t: rms_norm(t, mg["ln_q_w"], 1e-6))
    return x[reverse_index]


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def encode_images_fixed_grid(params: Qwen2VLVisionParams,
                             cfg: Qwen2VLVisionConfig,
                             pixel_batch: np.ndarray,
                             fn=None) -> np.ndarray:
    """The serving entry: [N, image_size, image_size, 3] in [0, 1] ->
    merged embeddings [N, tokens_per_image, hidden] float32 (host). One
    tower call per image, all on the one fixed grid, attention [S, S]
    per image. ``fn`` replaces ``encode_patches`` (same arguments)."""
    fn = fn or encode_patches
    device = params["patch_embed"].device
    grid0 = geo = None
    outs = []
    for img in pixel_batch:
        patches, grid = flatten_image(img, cfg)
        if grid != grid0:           # the same for every image: once
            cos, sin = rotary_cos_sin(cfg, [grid])
            geo = (_on(cos, device), _on(sin, device),
                   _on(segment_ids([grid]), device))
            grid0 = grid
        outs.append(fn(params, cfg, _on(patches, device), *geo)
                    .float().cpu().numpy())
    return np.stack(outs)


def encode_images_fixed_grid_v25(params: Qwen2VLVisionParams,
                                 cfg: Qwen25VLVisionConfig,
                                 pixel_batch: np.ndarray,
                                 fn=None) -> np.ndarray:
    """The Qwen2.5-VL serving entry: the window machinery computed once
    on the host, one tower call per image."""
    fn = fn or encode_patches_v25
    device = params["patch_embed"].device
    m2 = cfg.spatial_merge_size ** 2
    grid0 = cached = None
    outs = []
    for img in pixel_batch:
        patches, grid = flatten_image(img, cfg)
        if grid != grid0:
            cos, sin = rotary_cos_sin(cfg, [grid])
            seg_full = segment_ids([grid])
            widx, seg_win = window_order(cfg, [grid])
            # The patch-level permutation from the merge-cell one.
            perm = (widx[:, None] * m2
                    + np.arange(m2, dtype=np.int32)[None, :]).reshape(-1)
            cached = (perm, [_on(a, device) for a in (
                cos[perm], sin[perm], seg_full[perm], seg_win,
                np.argsort(widx).astype(np.int64))])
            grid0 = grid
        perm, geo = cached
        outs.append(fn(params, cfg, _on(patches[perm], device), *geo)
                    .float().cpu().numpy())
    return np.stack(outs)


def tower_flops(cfg, images: int = 1) -> float:
    """Modeled FLOPs of ``images`` fixed-grid images through the tower:
    2 x the multiply-adds of every matmul, attention over the whole
    [S, S] per layer (its masked entries are computed too)."""
    S = cfg.grid_side ** 2           # one frame: t = 1 after the fold
    D = cfg.embed_dim
    M = D * cfg.spatial_merge_size ** 2
    if isinstance(cfg, Qwen25VLVisionConfig):
        mlp = 3 * D * cfg.intermediate_size
    else:
        mlp = 2 * D * int(cfg.embed_dim * cfg.mlp_ratio)
    per_layer = S * (3 * D * D + D * D + mlp) + 2 * S * S * D
    merger = (S // cfg.spatial_merge_size ** 2) * (M * M
                                                   + M * cfg.hidden_size)
    return 2.0 * images * (S * cfg.patch_dim * D + cfg.depth * per_layer
                           + merger)
