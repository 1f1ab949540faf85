"""Hand-written CUDA kernels of the serving path, with their wrappers.

Each wrapper checks its arguments, then:

- for tensors on the CPU, runs the kernel's plain PyTorch version (the
  ``*_plain`` function of the same module);
- for CUDA tensors, launches the kernel (built from ``csrc/`` at first
  use by ``_build``) on the current stream, adds one to its ``launches``
  count, and raises if the launch failed. There is no fallback. Called
  while a CUDA graph is captured, it adds the kernel to the graph, and
  each replay of the graph counts it (``_launch.count_launch``).

The kernels replace the Pallas kernels of the JAX package that the
serving path launches in both orderings of the KV write: write-then-
attend (each layer writes its fresh K/V into the pool, then attends to
the pool; the ragged mixed step ``EngineConfig.ragged_attn`` included)
and attend-then-write (``EngineConfig.write_then_attend=False``: each
layer attends to the pool plus its fresh K/V, and one launch writes all
layers' rows after the layer loop, or, in a decode step, the last
layer's writer does). Pallas files are under
``xllm_service_tpu/ops/pallas/``:

=====================================  ===================================
wrapper                                Pallas kernel replaced
=====================================  ===================================
kv_update.rope_kv_update_layer         kv_update.py paged_kv_update_layer
                                       (fused with the rope of q and k)
kv_update.rope_prefill_kv_update_      kv_update.py
layer                                  paged_prefill_kv_update_layer
                                       (fused with the rope of q and k)
kv_update.latent_kv_update_layer       kv_update.py paged_kv_update_layer
                                       (fused with the MLA latent row)
kv_update.latent_prefill_kv_update_    kv_update.py
layer                                  paged_prefill_kv_update_layer
                                       (fused with the MLA latent row)
kv_update.rope_kv_update_all_layers    kv_update.py paged_kv_update_layer
                                       and paged_kv_update (the last
                                       layer's writer, all layers)
kv_update.latent_kv_update_all_layers  kv_update.py paged_kv_update_layer
                                       and paged_kv_update (MLA)
kv_update.paged_kv_update_layer        kv_update.py paged_kv_update_layer
                                       (unfused; off the serving path)
kv_update.paged_prefill_kv_update_     kv_update.py
layer                                  paged_prefill_kv_update_layer
                                       (unfused; off the serving path)
kv_update.paged_kv_update              kv_update.py paged_kv_update
                                       (unfused; off the serving path)
kv_update.paged_prefill_kv_update      kv_update.py paged_prefill_kv_update
paged_attention.paged_decode_          paged_attention.py
attention                              paged_decode_attention_pallas
paged_attention.paged_decode_          paged_attention.py
attention_current                      paged_decode_attention_pallas
                                       (k_cur/v_cur form)
paged_attention.paged_decode_          paged_attention.py
attention_mla                          paged_decode_attention_pallas
                                       (MLA latent pool as K and V)
paged_attention.paged_decode_          paged_attention.py
attention_mla_current                  paged_decode_attention_pallas
                                       (MLA, k_cur/v_cur form)
prefill_attention.paged_prefill_       prefill_attention.py
attention                              paged_prefill_attention_pallas
                                       (from_pool form)
prefill_attention.paged_prefill_       prefill_attention.py
attention_fresh                        paged_prefill_attention_pallas
                                       (two-source form)
ragged_attention.ragged_paged_         ragged_attention.py
attention                              ragged_paged_attention_pallas
=====================================  ===================================

Each wrapper has its own launch count, also where two share device
code, so a run shows which ordering it went through.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from xllm_service_tpu_torch.ops.kernels.kv_update import (
    latent_kv_update_all_layers, latent_kv_update_layer,
    latent_prefill_kv_update_layer, paged_kv_update, paged_kv_update_layer,
    paged_prefill_kv_update, paged_prefill_kv_update_layer,
    rope_kv_update_all_layers, rope_kv_update_layer,
    rope_prefill_kv_update_layer)
from xllm_service_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_current,
    paged_decode_attention_mla, paged_decode_attention_mla_current)
from xllm_service_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_fresh)
from xllm_service_tpu_torch.ops.kernels.ragged_attention import (
    ragged_paged_attention)

WRAPPERS: List[Callable] = [paged_kv_update_layer,
                            paged_prefill_kv_update_layer,
                            paged_decode_attention, paged_prefill_attention,
                            ragged_paged_attention, paged_kv_update,
                            paged_prefill_kv_update,
                            paged_decode_attention_current,
                            paged_prefill_attention_fresh,
                            paged_decode_attention_mla,
                            paged_decode_attention_mla_current,
                            rope_kv_update_layer,
                            rope_prefill_kv_update_layer,
                            latent_kv_update_layer,
                            latent_prefill_kv_update_layer,
                            rope_kv_update_all_layers,
                            latent_kv_update_all_layers]


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts",
           "paged_kv_update_layer", "paged_prefill_kv_update_layer",
           "paged_decode_attention", "paged_prefill_attention",
           "ragged_paged_attention", "paged_kv_update",
           "paged_prefill_kv_update", "paged_decode_attention_current",
           "paged_prefill_attention_fresh", "paged_decode_attention_mla",
           "paged_decode_attention_mla_current", "rope_kv_update_layer",
           "rope_prefill_kv_update_layer", "latent_kv_update_layer",
           "latent_prefill_kv_update_layer", "rope_kv_update_all_layers",
           "latent_kv_update_all_layers"]
