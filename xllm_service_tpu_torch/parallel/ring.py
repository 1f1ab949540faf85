"""Ring attention: exact causal attention over a sequence split over the
mesh's ``sp`` axis.

The counterpart of the JAX package's ``parallel/ring.py``. Each rank
keeps its query block and passes its KV block around the ring of the
sp group (``Mesh.ring_shift``, the JAX ``ppermute`` by +1), folding each
block it holds into a float32 online-softmax accumulator
(``ops/attention.flash_fold``, the numerics the chunked prefill path
shares): its own block first, then sp - 1 shift-and-fold steps, so that
after s steps it holds the block of rank (r - s) mod sp. The last block
is not shifted onward. Technique per Liu et al., "Ring Attention with
Blockwise Transformers".
"""

from __future__ import annotations

from typing import Optional

import torch

from xllm_service_tpu_torch.ops.attention import (_group_heads,
                                                  flash_finalize, flash_fold)
from xllm_service_tpu_torch.parallel.mesh import AXIS_SP, Mesh

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, kv_lengths: Optional[torch.Tensor] = None,
                   axis: str = AXIS_SP) -> torch.Tensor:
    """Causal GQA attention of this rank's blocks: q [B, Tq, Hq, D] at
    global positions ``index(axis) * Tq + t``, k/v [B, Tk, Hkv, D] at
    ``index(axis) * Tk + t``. ``kv_lengths`` [B] masks keys by global
    position. Returns the local output block [B, Tq, Hq, D] in q's
    dtype."""
    n, r = mesh.size(axis), mesh.index(axis)
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qg = _group_heads(q, Hkv).float()                        # [B,Tq,Hkv,G,D]
    scale = D ** -0.5
    q_pos = r * Tq + torch.arange(Tq, device=dev)            # [Tq] global
    o = torch.zeros((B, Tq, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Tq, Hkv, G), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Tq, Hkv, G), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for s in range(n):
        if s:
            kb = mesh.ring_shift(kb, axis)
            vb = mesh.ring_shift(vb, axis)
        src = (r - s) % n
        k_pos = src * Tk + torch.arange(Tk, device=dev)      # [Tk] global
        mask = (k_pos[None, :] <= q_pos[:, None])[None]       # [1, Tq, Tk]
        if kv_lengths is not None:
            mask = mask & (k_pos[None, None, :]
                           < kv_lengths.long()[:, None, None])
        o, m, l = flash_fold(o, m, l, qg, kb, vb, mask[:, :, None, None, :],
                             scale)
    return flash_finalize(o, l).reshape(B, Tq, Hq, D).to(q.dtype)
