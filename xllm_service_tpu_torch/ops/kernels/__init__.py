"""Hand-written CUDA kernels of the serving path, with their wrappers.

Each wrapper checks its arguments, then:

- for tensors on the CPU, runs the kernel's plain PyTorch version (the
  ``*_plain`` function of the same module);
- for CUDA tensors, launches the kernel (built from ``csrc/`` at first
  use by ``_build``) on the current stream, adds one to its ``launches``
  count, and raises if the launch failed. There is no fallback.

The kernels replace the Pallas kernels of the JAX package that the
write-then-attend serving path launches:

=====================================  ===================================
wrapper                                Pallas kernel replaced
=====================================  ===================================
kv_update.paged_kv_update_layer        kv_update.py paged_kv_update_layer
kv_update.paged_prefill_kv_update_     kv_update.py
layer                                  paged_prefill_kv_update_layer
paged_attention.paged_decode_          paged_attention.py
attention                              paged_decode_attention_pallas
prefill_attention.paged_prefill_       prefill_attention.py
attention                              paged_prefill_attention_pallas
=====================================  ===================================
"""

from __future__ import annotations

from typing import Callable, Dict, List

from xllm_service_tpu_torch.ops.kernels.kv_update import (
    paged_kv_update_layer, paged_prefill_kv_update_layer)
from xllm_service_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention)
from xllm_service_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention)

WRAPPERS: List[Callable] = [paged_kv_update_layer,
                            paged_prefill_kv_update_layer,
                            paged_decode_attention, paged_prefill_attention]


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts",
           "paged_kv_update_layer", "paged_prefill_kv_update_layer",
           "paged_decode_attention", "paged_prefill_attention"]
