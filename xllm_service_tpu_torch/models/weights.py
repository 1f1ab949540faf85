"""Parameter conversion from the JAX package's pytree layout.

The JAX package keeps parameters as a plain dict of arrays (per-layer
weights stacked over [L], ``x @ W`` with ``W`` [in, out]); this package
keeps the same dict with torch tensors. ``params_from_jax`` takes that
tree with numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``
on the JAX side) and gives tensors on ``device``, so both packages
compute the same function from the same weights;
``vision_params_from_jax`` does the same for the vision towers' trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models.transformer import (
    Params, check_supported, torch_dtype)

# Leaves kept in float32 whatever the model dtype: GPT-OSS sink logits
# and DeepSeek-V3's expert selection bias.
_FLOAT32_LEAVES = ("sinks", "router_bias")
# Stacks of per-layer weights: every family's layers, and under MLA the
# MoE layers after the dense ones.
_LAYER_STACKS = ("layers", "layers_moe")


def _tensor(x: Any, device, dtype: torch.dtype) -> torch.Tensor:
    # numpy has no bfloat16 of its own: a bfloat16 leaf arrives as the
    # ml_dtypes extension type, which widens to float32 exactly.
    arr = np.array(x, dtype=np.float32)          # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX parameter tree (numpy leaves) as this package's params."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg)

    def conv(name: str, x: Any) -> torch.Tensor:
        return _tensor(x, device,
                       torch.float32 if name in _FLOAT32_LEAVES else dtype)

    params: Params = {k: conv(k, v) for k, v in tree.items()
                      if k not in _LAYER_STACKS}
    for stack in _LAYER_STACKS:
        if stack in tree:
            params[stack] = {k: conv(k, v) for k, v in tree[stack].items()}
    return params


def vision_params_from_jax(tree: Dict[str, Any], device,
                           dtype: torch.dtype = torch.float32
                           ) -> Dict[str, Any]:
    """A JAX vision tower's parameters (``models/qwen2vl_vision.py``'s
    Qwen2-VL or Qwen2.5-VL tree, or ``models/vision.py``'s synthetic ViT;
    numpy leaves) as the same nested dict of ``dtype`` tensors on
    ``device``."""
    return {k: (vision_params_from_jax(v, device, dtype)
                if isinstance(v, dict) else _tensor(v, device, dtype))
            for k, v in tree.items()}
