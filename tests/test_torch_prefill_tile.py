"""The prefill tile of the CUDA kernels (``csrc/flash_tile.cuh``) and
what the wrappers around it must agree with.

The tile code runs only on a GPU (``chip_smoke.py`` holds it against the
plain versions there). Here: its geometry, read from the source text,
against the wrappers' tile rows, query tile and group check (a mismatch
would only show on the card), and the plain versions of K4 and K4'
against the JAX package's XLA reference ``mha_prefill`` in float32, over
windows that span several 64-key chunks and start and end mid-chunk.
Tolerance atol = rtol = 1e-5 (float32, different summation order); query
rows past a row's length are zeros in the port and not compared."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.ops.kernels import _build, prefill_attention
from xllm_service_tpu_torch.ops.kernels import (
    paged_prefill_attention, paged_prefill_attention_fresh)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
SMEM_PER_BLOCK = 232448          # bytes a block may use on an H100


def _geometry():
    text = (_build.CSRC / "flash_tile.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kRows", "kKeys", "kThreads", "kStages")}


def test_tile_rows_and_query_tile_follow_the_source():
    geo = _geometry()
    rows = geo["kRows"]
    assert prefill_attention._TILE_ROWS == rows
    assert rows == 16 * geo["kThreads"] // 32       # 16 rows per warp
    for G in range(1, rows + 1):
        qb = prefill_attention.query_tile(G)
        assert qb == rows // G and qb * G <= rows


def test_staging_and_shared_memory_fit_every_head_dim():
    geo = _geometry()
    for D in prefill_attention._HEAD_DIMS:
        vpr = D // 8                                # 16-byte vectors a row
        assert geo["kThreads"] % vpr == 0
        assert geo["kKeys"] % (geo["kThreads"] // vpr) == 0
        assert geo["kRows"] * vpr % geo["kThreads"] == 0
        smem = 1024 + geo["kRows"] * D * 2 \
            + 2 * geo["kStages"] * geo["kKeys"] * D * 2
        assert smem <= SMEM_PER_BLOCK
    # The ragged kernel's decode rows are tuned for the same block.
    assert geo["kThreads"] == 256


@pytest.mark.parametrize("G, ok", [(1, True), (128, True), (129, False)])
def test_group_check_follows_the_tile_rows(G, ok):
    q = torch.zeros(1, 1, G, 64, dtype=torch.bfloat16)
    k_pages = torch.zeros(1, 2, 16, 1, 64, dtype=torch.bfloat16)
    if ok:
        prefill_attention.check_cuda_shapes(q, k_pages)
    else:
        with pytest.raises(ValueError, match="query group"):
            prefill_attention.check_cuda_shapes(q, k_pages)


@pytest.fixture(autouse=True)
def _launches_stay_zero():
    kernels.reset_launch_counts()
    yield
    # CPU tensors never launch a kernel.
    assert all(n == 0 for n in kernels.launch_counts().values())


ARG_SETS = ("plain", "window", "cap_scale", "sinks_window")


def _args(name, sinks):
    # W = 90 ends mid-chunk for every query position of the second row.
    return {"plain": {}, "window": {"sliding_window": 90},
            "cap_scale": {"logits_soft_cap": 30.0, "scale": 0.1},
            "sinks_window": {"sinks": sinks, "sliding_window": 70}}[name]


@pytest.mark.parametrize("fresh", [False, True], ids=["pool", "fresh"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("case", ARG_SETS)
def test_plain_prefill_matches_xla_reference(fresh, G, case):
    rng = np.random.default_rng(31 + G)
    L, ps, Hkv, D, B, T = 2, 16, 2, 64, 2, 320
    Hq = Hkv * G
    q_start = np.array([0, 200], np.int32)          # 200: mid-chunk
    lens = np.array([320, 250], np.int32)
    MP = -(-int((q_start + T).max()) // ps)
    P = B * MP + 1
    kp = rng.normal(size=(L, P, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, ps, Hkv, D)).astype(np.float32)
    pt = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k_new = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v_new = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    sinks = rng.normal(size=(Hq,)).astype(np.float32)
    layer = 1
    # The reference's keys: the layer's pages in table order, with the
    # window's rows at positions q_start + t. Write-then-attend holds them
    # in the pool; attend-then-write passes them apart, its pool slots
    # stale.
    k_ref = kp[layer][pt].reshape(B, MP * ps, Hkv, D)
    v_ref = vp[layer][pt].reshape(B, MP * ps, Hkv, D)
    for b in range(B):
        s = int(q_start[b])
        k_ref[b, s:s + T], v_ref[b, s:s + T] = k_new[b], v_new[b]
    if not fresh:
        kp[layer][pt] = k_ref.reshape(B, MP, ps, Hkv, D)
        vp[layer][pt] = v_ref.reshape(B, MP, ps, Hkv, D)
    extras = _args(case, sinks)
    jx = {k: (jnp.asarray(v) if k == "sinks" else v)
          for k, v in extras.items()}
    want = np.asarray(jatt.mha_prefill(
        jnp.asarray(q), jnp.asarray(k_ref), jnp.asarray(v_ref),
        jnp.asarray(q_start + lens), jnp.asarray(q_start), **jx))
    tx = {k: (torch.from_numpy(v) if k == "sinks" else v)
          for k, v in extras.items()}
    t = torch.from_numpy
    if fresh:
        got = paged_prefill_attention_fresh(
            t(q), t(k_new), t(v_new), t(kp), t(vp), t(pt), t(q_start),
            t(lens), layer, **tx)
    else:
        got = paged_prefill_attention(t(q), t(kp), t(vp), t(pt), t(q_start),
                                      t(lens), layer, **tx)
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_allclose(got.numpy()[b, :n], want[b, :n], **TOL)
        assert not got.numpy()[b, n:].any()         # rows past the length
