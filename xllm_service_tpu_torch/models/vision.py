"""The synthetic ViT of the EPD path: the vision encoder a worker serves
for a catalog model without a checkpoint tower (the JAX package's
``models/vision.py``).

Pixels [B, H, W, 3] resized to a fixed grid are cut into P x P patches,
projected, given a learned position embedding, run through bidirectional
pre-norm blocks (RMSNorm, one fused qkv projection, softmax attention,
a tanh-GELU MLP) and projected into the language model's hidden size:
one embedding row per patch, spliced over the prompt's image tokens.
The attention is plain PyTorch (einsum and softmax), as the JAX encoder
runs it through XLA: no Pallas kernel lies on the tower. Matmuls run in
the config's dtype, norms and softmax in float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.ops.norm import rms_norm

VisionParams = Dict[str, Any]


def num_patches(image_size: int, patch_size: int) -> int:
    return (image_size // patch_size) ** 2


class VisionConfig:
    """The encoder's static shape (the JAX ``VisionConfig``)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 hidden_size: int = 1024, intermediate_size: int = 4096,
                 num_layers: int = 24, num_heads: int = 16,
                 output_size: int = 4096, dtype: str = "bfloat16") -> None:
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.output_size = output_size
        self.dtype = dtype

    @property
    def tokens_per_image(self) -> int:
        return num_patches(self.image_size, self.patch_size)

    @classmethod
    def tiny(cls, output_size: int = 64) -> "VisionConfig":
        return cls(image_size=16, patch_size=4, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=2,
                   output_size=output_size)

    @classmethod
    def for_model(cls, model_cfg: ModelConfig) -> "VisionConfig":
        """A Qwen2-VL-sized encoder for ``model_cfg``'s hidden size."""
        return cls(output_size=model_cfg.hidden_size)


def init_vision_params(cfg: VisionConfig, generator: torch.Generator,
                       device) -> VisionParams:
    """Random N(0, 1/fan_in) weights in the JAX tree's layout, drawn from
    ``generator`` (on ``device``)."""
    dtype = getattr(torch, cfg.dtype)
    D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    P = cfg.patch_size

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "patch_embed": w((P * P * 3, D), P * P * 3),
        "pos_embed": w((num_patches(cfg.image_size, P), D), D),
        "layers": {
            "input_norm": ones(L, D),
            "qkv": w((L, D, 3 * D), D),
            "o_proj": w((L, D, D), D),
            "post_norm": ones(L, D),
            "up_proj": w((L, D, Fi), D),
            "down_proj": w((L, Fi, D), Fi),
        },
        "final_norm": ones(D),
        "proj": w((D, cfg.output_size), D),
    }


def patchify(pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, P*P*3]."""
    B, H, W, C = pixels.shape
    P = patch_size
    x = pixels.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // P) * (W // P), P * P * C)


def encode_image(params: VisionParams, cfg: VisionConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] in [0, 1] (on the params' device) -> patch
    embeddings [B, n_patches, output_size] in the config's dtype."""
    dtype = getattr(torch, cfg.dtype)
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    x = patchify(pixels.to(dtype), cfg.patch_size) @ params["patch_embed"]
    x = x + params["pos_embed"][None]
    lys = params["layers"]
    scale = 1.0 / math.sqrt(Dh)
    for i in range(cfg.num_layers):
        B, T, _ = x.shape
        h = rms_norm(x, lys["input_norm"][i], 1e-5)
        qkv = (h @ lys["qkv"][i]).reshape(B, T, 3, H, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
        p = torch.softmax(logits, dim=-1)                 # bidirectional
        attn = torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)
        x = x + attn.reshape(B, T, -1) @ lys["o_proj"][i]
        h = rms_norm(x, lys["post_norm"][i], 1e-5)
        x = x + F.gelu(h @ lys["up_proj"][i], approximate="tanh") \
            @ lys["down_proj"][i]
    x = rms_norm(x, params["final_norm"], 1e-5)
    return (x @ params["proj"]).to(dtype)
