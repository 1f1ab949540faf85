"""The port's parallel layer against the JAX package's, on the CPU.

The port's ranks are processes of one module-wide pool
(``tests/torch_rank_pool.py``), joined for each case in a gloo world
rendezvousing at a ``FileStore`` in the module's temporary directory; the
JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
with the JAX package's ``make_mesh`` / ``shard_params``. Cases:

- ``mha_prefill_chunked`` and ``mha_prefill_auto`` (both sides of the
  64 MiB cut; sinks, a window, a soft-cap) against the JAX functions,
  2e-4 in float32;
- ``ring_attention`` at sp = 2 and 4 against JAX
  ``ring_attention_sharded``, valid rows, 2e-4;
- ``tiny`` prefill and decode logits at tp = 2 (KV heads split), tp = 4
  (KV heads replicated), a tiny MoE at ep = 2 x tp = 2 (logits and
  ``moe_dropped``), tiny DeepSeek-V2-Lite / V3 at tp = 2 (and V3 at
  ep = 2 x tp = 2) and a tiny GPT-OSS at ep = 2 x tp = 2 (sinks and
  biases perturbed), each against JAX's sharded forward on the same
  weights;
- an engine at sp = 2 whose long prompt takes the ring step, its
  temperature-0 stream equal to the JAX engine's at sp = 2; engines at
  tp = 2 (split and ragged steps) equal to the unsharded engine; the
  rank control's forwards against the unsharded forward;
- a worker at ``--tp 2`` (its rank 1 a child it starts) and a world the
  caller started (``--dist-*``), whose ``/v1/completions`` texts equal
  the JAX worker's at tp = 2;
- a step fault under a mesh (rank 0 raising mid-forward, a follower
  exiting) stopping the worker with an error, not a hang;
- the refusals: NCCL with two ranks on one card, CUDA graphs under a
  mesh, the paths a mesh does not shard; and the mesh's geometry and
  the KV rule against the JAX package's.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import attention as jatt
from xllm_service_tpu.parallel import mesh as jmesh
from xllm_service_tpu.parallel import sharding as jsharding
from xllm_service_tpu.parallel.ring import ring_attention_sharded
from xllm_service_tpu.runtime.checkpoint import save_checkpoint
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import attention as tatt
from xllm_service_tpu_torch.parallel import mesh as tmesh
from xllm_service_tpu_torch.parallel import sharding as tsharding
from xllm_service_tpu_torch.runtime import ranks

from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401
from tests.torch_rank_pool import RankPool

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _ambient(mesh):
    return jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh


# ---------------------------------------------------------------------------
# The chunked prefill attention
# ---------------------------------------------------------------------------

CHUNK_CASES = {
    "plain": dict(),
    "sinks": dict(sinks=True),
    "window": dict(sliding_window=7),
    "softcap": dict(logits_soft_cap=5.0),
    "window_sinks_softcap": dict(sliding_window=11, sinks=True,
                                 logits_soft_cap=3.0),
}


def _attn_inputs(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    sinks = rng.standard_normal((Hq,)).astype(np.float32)
    return q, k, v, sinks


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_prefill_matches_jax(case):
    """A window of 13 queries at start [27, 5] over 40 keys in chunks of
    16 (the last one short): every chunk folded, also the ones the JAX
    path skips."""
    kw = dict(CHUNK_CASES[case])
    q, k, v, sinks = _attn_inputs(3, 2, 13, 40, 4, 2, 8)
    lengths = np.array([40, 18], np.int32)
    start = np.array([27, 5], np.int32)
    s = kw.pop("sinks", False)
    got = tatt.mha_prefill_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), torch.from_numpy(start), chunk_size=16,
        sinks=torch.from_numpy(sinks) if s else None, **kw)
    want = jatt.mha_prefill_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(start), chunk_size=16,
        sinks=jnp.asarray(sinks) if s else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, T, Hq, S): 4 * B * Hq * T * S bytes of scores around the 64 MiB cut.
AUTO_SHAPES = {"dense": (1, 256, 4, 256),
               "at_cut": (1, 2048, 4, 2048),
               "chunked": (1, 2304, 4, 2304)}


@pytest.mark.parametrize("name", sorted(AUTO_SHAPES))
def test_prefill_auto_matches_jax(name):
    """The dense or chunked branch by score bytes, its chunk
    (32 MiB / (4 B Hq T), in [128, 1024], a multiple of 128), and the
    output against the JAX ``mha_prefill_auto`` with a window and a
    soft-cap."""
    B, T, Hq, S = AUTO_SHAPES[name]
    q, k, v, _ = _attn_inputs(5, B, T, S, Hq, 2, 8)
    lengths = np.array([S - 37], np.int32)
    start = np.zeros(B, np.int32)
    kw = dict(logits_soft_cap=4.0, sliding_window=300)
    chunk = tatt.prefill_chunk(B, T, Hq, S)
    assert chunk == (0 if 4 * B * Hq * T * S <= 64 << 20 else max(
        128, min(1024, (32 << 20) // (4 * B * Hq * T) // 128 * 128)))
    assert (chunk > 0) == (name == "chunked")
    before = dict(tatt.PREFILL_BRANCH_CALLS)
    got = tatt.mha_prefill_auto(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), torch.from_numpy(start), **kw)
    branch = "chunked" if chunk else "dense"
    assert tatt.PREFILL_BRANCH_CALLS[branch] == before[branch] + 1
    want = jatt.mha_prefill_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(start), **kw)
    n = int(lengths[0])
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(want)[:, :n],
                               **TOL)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(pool, sp):
    q, k, v, _ = _attn_inputs(7, 2, 32, 32, 4, 2, 8)
    lengths = np.array([32, 27], np.int32)
    blocks = pool.run({"sp": sp}, "ring", q, k, v, lengths)
    got = np.concatenate(blocks, axis=1)
    ring = ring_attention_sharded(jmesh.make_mesh(jmesh.MeshSpec(sp=sp)),
                                  "sp")
    want = np.asarray(jax.jit(ring)(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lengths)))
    for b in range(2):
        n = int(lengths[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


# ---------------------------------------------------------------------------
# Sharded forwards
# ---------------------------------------------------------------------------

_MLA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=48, num_layers=3, num_heads=4,
            num_kv_heads=4, head_dim=8, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            num_experts=4, num_experts_per_tok=2, n_shared_experts=1,
            first_k_dense_replace=1, routed_scaling_factor=1.5,
            norm_topk_prob=False, max_position_embeddings=512,
            rope_theta=10000.0, dtype="float32")
MODELS = {
    "tiny": dict(name="tiny", vocab_size=256, hidden_size=64,
                 intermediate_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                 max_position_embeddings=512, dtype="float32"),
    "tiny_moe": dict(name="tiny", vocab_size=256, hidden_size=64,
                     intermediate_size=128, num_layers=2, num_heads=4,
                     num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                     max_position_embeddings=512, num_experts=4,
                     num_experts_per_tok=2, moe_capacity_factor=0.5,
                     dtype="float32"),
    "v2_lite": dict(_MLA, name="tiny-v2-lite",
                    rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True,
                                  0.707), mla_yarn_mscale=True),
    # GPT-OSS: sinks, biased q/k/v/o, alternating 6-token windows,
    # clamped-GLU experts with biases behind a biased router.
    "gptoss": dict(name="tiny", vocab_size=256, hidden_size=64,
                   intermediate_size=128, num_layers=3, num_heads=4,
                   num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                   max_position_embeddings=512, attention_bias=True,
                   sliding_window=6, layer_sliding=(True, False, True),
                   num_experts=4, num_experts_per_tok=2,
                   norm_topk_prob=False, gptoss=True,
                   moe_intermediate_size=48, dtype="float32"),
    "v3": dict(_MLA, name="tiny-v3", q_lora_rank=24, num_experts=8,
               n_group=2, topk_group=1, topk_method="group_limited_greedy",
               moe_scoring="sigmoid", routed_scaling_factor=2.5,
               norm_topk_prob=True),
}
FORWARD_CASES = {
    "tp2": ("tiny", dict(tp=2)),
    "tp4_kv_replicated": ("tiny", dict(tp=4)),
    "moe_ep2_tp2": ("tiny_moe", dict(ep=2, tp=2)),
    "v2_lite_tp2": ("v2_lite", dict(tp=2)),
    "v3_tp2": ("v3", dict(tp=2)),
    "v3_ep2_tp2": ("v3", dict(ep=2, tp=2)),
    "gptoss_ep2_tp2": ("gptoss", dict(ep=2, tp=2)),
}
# Leaves JAX initializes at zero or one, perturbed so that a rank adding
# one twice, or another rank's slice, shows.
_PERTURB = ("sinks", "o_bias", "q_bias", "k_bias", "v_bias", "gate_bias",
            "up_bias", "down_bias", "router_bias")


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                    if k in _PERTURB else _perturbed(v, rng))
                for k, v in tree.items()}
    return tree


def _jax_sharded_forward(jcfg, jparams, spec, prefill, decode, P, ps):
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec))
    sp_params = jsharding.shard_params(jparams, mesh, jcfg)
    kv = jtf.init_kv_cache(jcfg, P, ps, jnp.float32)
    sp_kv = jsharding.shard_kv_cache(kv, mesh, jcfg)
    toks, start, lengths, table = (jnp.asarray(a) for a in prefill)
    dt, dpos, dact, dtable = (jnp.asarray(a) for a in decode)
    with _ambient(mesh):
        last, _, kv, st1 = jax.jit(
            jtf.forward_prefill, static_argnums=(1,),
            static_argnames=("return_stats",))(
                sp_params, jcfg, toks, start, lengths, sp_kv, table,
                return_stats=True)
        dlog, _, st2 = jax.jit(
            jtf.forward_decode, static_argnums=(1,),
            static_argnames=("return_stats",))(
                sp_params, jcfg, dt, dpos, dact.astype(bool), kv, dtable,
                return_stats=True)
    return (np.asarray(last), np.asarray(dlog), int(st1["moe_dropped"]),
            int(st2["moe_dropped"]))


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_sharded_forward_matches_jax(pool, case):
    model, spec = FORWARD_CASES[case]
    jcfg = JaxModelConfig(**MODELS[model])
    tcfg = ModelConfig(**MODELS[model])
    jparams = _perturbed(jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(2))),
        np.random.default_rng(3))
    params = _numpy(params_from_jax(jparams, tcfg, "cpu"))
    rng = np.random.default_rng(11)
    B, T, ps, P = 2, 8, 4, 16
    prefill = (rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32),
               np.zeros(B, np.int32), np.array([8, 5], np.int32),
               np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    decode = (np.array([3, 7], np.int32), np.array([8, 5], np.int32),
              np.array([1, 1], np.int32), prefill[3])
    got = pool.run(spec, "forward", tcfg, params, prefill, decode, P, ps)
    want = _jax_sharded_forward(jcfg, jparams, spec, prefill, decode, P, ps)
    for rank_out in got:
        np.testing.assert_allclose(rank_out[0], want[0], **TOL)
        np.testing.assert_allclose(rank_out[1], want[1], **TOL)
        # The MoE drop count is the unsharded one (MLA models discard
        # theirs, as the JAX package: 0 on both sides).
        assert rank_out[2:] == want[2:]
    if model == "tiny_moe":
        assert want[2] > 0, "the case must drop some assignments"


# ---------------------------------------------------------------------------
# The engine at sp = 2 and the worker at tp = 2
# ---------------------------------------------------------------------------

def test_sp2_engine_ring_stream_matches_jax(pool):
    """A 40-token prompt past the 8-token bucket: the port's engine
    prefills it in ONE ring step (counted under ``prefill_ring``) and
    its greedy stream equals the JAX engine's at sp = 2 (which the JAX
    tests hold to the single-chip chunked windows)."""
    jcfg = JaxModelConfig(**MODELS["tiny"])
    tcfg = ModelConfig(**MODELS["tiny"])
    ecfg = dict(page_size=4, num_pages=32, max_model_len=64,
                max_batch_size=4, max_prefill_tokens=8, prefill_buckets=(8,))
    prompt = [(i * 11 + 2) % 50 for i in range(14)]
    short = [5, 9, 2]
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ecfg),
                     mesh=jmesh.make_mesh(jmesh.MeshSpec(sp=2)), seed=0)
    for rid, p in (("r0", prompt), ("r1", short)):
        jeng.add_request(JaxRequest(rid, list(p), sampling=JaxSampling(
            max_tokens=5, temperature=0.0)))
    want = {"r0": [], "r1": []}
    for _ in range(60):
        if not jeng.has_work():
            break
        for out in jeng.step():
            want[out.request_id].extend(out.new_token_ids)
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    params = _numpy(params_from_jax(jparams, tcfg, "cpu"))
    streams, ring_steps, windows, compiled = pool.run(
        {"sp": 2}, "engine_streams", tcfg, EngineConfig(**ecfg), params,
        [prompt, short], 5)[0]
    assert streams == [want["r0"], want["r1"]]
    assert ring_steps == {"cpu": 1}
    assert windows[0][0] == len(prompt)
    assert compiled["prefill_ring"] == 1


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_tp2_engine_streams_match_unsharded(pool, ragged):
    """An engine at tp = 2 (its follower making every runner call rank
    0 makes) serves three prompts, two past the 8-token bucket, in the
    split sections or with ragged mixed steps, with the unsharded engine's
    greedy streams (which the other port tests hold to the JAX
    engine's)."""
    from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
    from xllm_service_tpu_torch.utils.types import SamplingParams
    tcfg = ModelConfig(**MODELS["tiny"])
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(JaxModelConfig(**MODELS["tiny"]),
                                    jax.random.PRNGKey(6)))
    tparams = params_from_jax(jparams, tcfg, "cpu")
    ecfg = EngineConfig(page_size=4, num_pages=32, max_model_len=64,
                        max_batch_size=4, max_prefill_tokens=12,
                        prefill_buckets=(4, 8), ragged_attn=ragged)
    prompts = [[3, 8, 1], [(i * 5 + 1) % 90 for i in range(27)],
               [(i * 3 + 7) % 60 for i in range(11)]]
    ref = Engine(tcfg, ecfg, params=tparams, device="cpu")
    for i, p in enumerate(prompts):
        ref.add_request(EngineRequest(f"r{i}", list(p), sampling=SamplingParams(
            max_tokens=6, temperature=0.0)))
    want = {f"r{i}": [] for i in range(len(prompts))}
    while ref.has_work():
        for out in ref.step():
            want[out.request_id].extend(out.new_token_ids)
    streams, _, windows, _ = pool.run(
        {"tp": 2}, "engine_streams", tcfg, ecfg, _numpy(tparams), prompts,
        6)[0]
    assert streams == [want[f"r{i}"] for i in range(len(prompts))]
    assert ref.ragged_steps > 0 or not ragged


@pytest.mark.parametrize("spec", [dict(tp=2), dict(sp=2)],
                         ids=["tp2", "sp2"])
def test_rank_control_forwards_match_unsharded(pool, spec):
    """``ranks.control``'s forwards (what ``chip_smoke.py`` phase 17
    holds against the unsharded forward on the card) on every rank at
    once: rank 0's prefill and decode logits, and at sp = 2 the ring
    prefill's, equal the unsharded float32 forward's; the collectives a
    tp = 2 forward makes are 2 a layer, the embedding's and the head's."""
    from xllm_service_tpu_torch.models import transformer as ttf
    tcfg = ModelConfig(**MODELS["tiny"])
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(JaxModelConfig(**MODELS["tiny"]),
                                    jax.random.PRNGKey(4)))
    tparams = params_from_jax(jparams, tcfg, "cpu")
    ids = [(i * 7 + 3) % 200 for i in range(13)]
    ecfg = EngineConfig(page_size=4, num_pages=16, max_model_len=64,
                        prefill_buckets=(8,))
    lp, ld, lr, reps = pool.run(spec, "control_logits", tcfg, ecfg,
                                _numpy(tparams), ids, 9, 16)[0]
    # Every rank's counters, gathered to rank 0 in rank order.
    assert [r["rank"] for r in reps] == [0, 1]
    assert reps[1]["collectives"] == reps[0]["collectives"]
    rep = reps[0]
    kv = ttf.init_kv_cache(tcfg, 8, 4, "cpu", torch.float32)
    table = torch.arange(1, 6, dtype=torch.int32)[None]
    want_p, kv = ttf.forward_prefill(
        tparams, tcfg, torch.tensor([ids]), torch.zeros(1, dtype=torch.int32),
        torch.tensor([13], dtype=torch.int32), kv, table,
        write_then_attend=False)
    want_d, _ = ttf.forward_decode(
        tparams, tcfg, torch.tensor([9]), torch.tensor([13],
                                                       dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), kv, table, write_then_attend=False)
    np.testing.assert_allclose(lp, want_p[0].numpy(), **TOL)
    np.testing.assert_allclose(ld, want_d[0].numpy(), **TOL)
    if "sp" in spec:
        np.testing.assert_allclose(lr, want_p[0].numpy(), **TOL)
    else:
        layers = tcfg.num_layers
        assert rep["collectives"]["all_reduce"] == 2 * (2 * layers + 1)
        assert rep["collectives"]["all_gather"] == 2


_JAX_WORKER = r'''
import dataclasses, json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.environ["XLLM_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")
from http.client import HTTPConnection
from xllm_service_tpu.config import EngineConfig
from xllm_service_tpu.parallel import MeshSpec, make_mesh
from xllm_service_tpu.runtime import worker as jw
from xllm_service_tpu.service.coordination import InMemoryStore
orig = jw.resolve_model_config
jw.resolve_model_config = lambda name, model_dir="": dataclasses.replace(
    orig(name, model_dir), dtype="float32")
ecfg = EngineConfig(page_size=16, num_pages=64, max_model_len=256,
                    max_batch_size=4, max_prefill_tokens=128,
                    prefill_buckets=(32, 64), tp=2)
w = jw.Worker(jw.WorkerOptions(model="m", model_dir=sys.argv[1]),
              InMemoryStore(), engine_cfg=ecfg,
              mesh=make_mesh(MeshSpec(tp=2))).start()
try:
    host, port = w.name.rsplit(":", 1)
    for prompt in json.loads(sys.argv[2]):
        conn = HTTPConnection(host, int(port), timeout=120)
        conn.request("POST", "/v1/completions", body=json.dumps(
            {"model": "m", "prompt": prompt, "max_tokens": 12,
             "temperature": 0.0, "ignore_eos": True}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        print("TEXT:" + json.dumps(json.loads(r.read())["choices"][0]["text"]),
              flush=True)
finally:
    w.stop()
'''

_PORT_WORKER = r'''
import dataclasses, os, sys
sys.path.insert(0, os.environ["XLLM_REPO"])
from xllm_service_tpu_torch.runtime import worker as tw
orig = tw.resolve_model_config
tw.resolve_model_config = lambda name, model_dir="": dataclasses.replace(
    orig(name, model_dir), dtype="float32")
sys.exit(tw.main(sys.argv[1:]))
'''

PROMPTS = ["the quick brown fox jumps", "a page table of sixty-four"]
_PORT_ARGS = ["--model", "m", "--device", "cpu", "--tp", "2", "--no-warmup",
              "--page-size", "16", "--num-pages", "64", "--max-model-len",
              "256", "--max-prefill-tokens", "128", "--prefill-buckets",
              "32,64", "--max-batch-size", "4"]


def _texts(addr: str):
    host, p = addr.rsplit(":", 1)
    out = []
    for prompt in PROMPTS:
        conn = HTTPConnection(host, int(p), timeout=120)
        conn.request("POST", "/v1/completions", body=json.dumps(
            {"model": "m", "prompt": prompt, "max_tokens": 12,
             "temperature": 0.0, "ignore_eos": True}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 200, body
        out.append(body["choices"][0]["text"])
    return out


def test_tp2_worker_text_matches_jax(tmp_path):
    """On a float32 directory of the JAX writer, at tp = 2 on the CPU
    (gloo), two port worker set-ups serve the JAX worker's tp = 2 texts:
    one at ``--tp 2`` that starts and stops its rank 1 itself, and a
    world the caller started (``--dist-coordinator``,
    ``--dist-num-processes``, ``--dist-process-id``: process 1 runs the
    follower loop, process 0 is the worker). The first one's
    /v1/embeddings, not sharded, answers 501."""
    d = str(tmp_path / "model")
    cfg = dataclasses.replace(JaxModelConfig.tiny(), dtype="float32")
    save_checkpoint(jax.tree_util.tree_map(
        np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0))), cfg, d)
    env = {**os.environ, "XLLM_REPO": str(ROOT)}

    def start(*args, log=None):
        return subprocess.Popen(
            [sys.executable, "-c", _PORT_WORKER, *_PORT_ARGS,
             "--model-dir", d, *args], stdout=subprocess.PIPE,
            stderr=open(log, "w") if log else subprocess.DEVNULL,
            text=True, env=env)

    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_WORKER, d, json.dumps(PROMPTS)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    dist = ["--dist-coordinator", f"127.0.0.1:{tmesh.free_port()}",
            "--dist-num-processes", "2"]
    procs = [start(log=str(tmp_path / "self.log")),
             start(*dist, "--dist-process-id", "1",
                   log=str(tmp_path / "dist1.log")),
             start(*dist, "--dist-process-id", "0")]
    try:
        got = {}
        for name, proc in (("self", procs[0]), ("dist", procs[2])):
            addr = re.search(r"http=(\S+)", proc.stdout.readline()).group(1)
            got[name] = _texts(addr)
            if name == "self":
                host, p = addr.rsplit(":", 1)
                conn = HTTPConnection(host, int(p), timeout=120)
                conn.request("POST", "/v1/embeddings", body=json.dumps(
                    {"model": "m", "input": "abc"}),
                    headers={"Content-Type": "application/json"})
                assert conn.getresponse().status == 501
        out, _ = jax_proc.communicate(timeout=240)
        want = [json.loads(line[5:]) for line in out.splitlines()
                if line.startswith("TEXT:")]
        assert len(want) == len(PROMPTS)
        assert got["self"] == want and got["dist"] == want
        procs[0].terminate()
        procs[2].terminate()
        assert procs[1].wait(60) == 0
    finally:
        for proc in procs + [jax_proc]:
            if proc.poll() is None:
                proc.kill()
            proc.wait(60)
    # Each follower left when its worker stopped, after following it (a
    # rank the worker starts writes to the worker's stderr).
    for log in (tmp_path / "self.log", tmp_path / "dist1.log"):
        assert "rank 1: followed" in log.read_text()


@pytest.mark.parametrize("where", ["rank0_mid_forward", "follower_exits"])
def test_step_fault_under_mesh_stops_the_worker(monkeypatch, where):
    """A fault under a mesh is not contained (the ranks are out of
    step): rank 0 raising inside a sharded forward, after its follower
    has joined the step, or a follower that exits, ends every request
    with a 500, stops the engine loop and the follower, and leaves no
    collective waiting; the worker then stops at once. Before it, the
    idle worker's keep-alives reach the follower uncounted."""
    from xllm_service_tpu_torch.models import transformer as ttf
    from xllm_service_tpu_torch.runtime import worker as tw
    ecfg = EngineConfig(page_size=4, num_pages=32, max_model_len=64,
                        max_prefill_tokens=16, prefill_buckets=(8, 16),
                        tp=2)
    # Keep-alives every 50 ms while idle: the follower skips them, and
    # they are not counted as the steps' broadcasts.
    monkeypatch.setattr(ranks, "KEEPALIVE_S", 0.05)
    w = tw.Worker(tw.WorkerOptions(model="tiny", device="cpu",
                                   warmup=False, dist_backend="gloo"),
                  engine_cfg=ecfg,
                  model_cfg=ModelConfig(**MODELS["tiny"])).start()
    host, port = w.name.rsplit(":", 1)

    def complete(prompt):
        conn = HTTPConnection(host, int(port), timeout=60)
        conn.request("POST", "/v1/completions", body=json.dumps(
            {"model": "tiny", "prompt": prompt, "max_tokens": 4,
             "temperature": 0.0}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    follower = w._rank_procs[0]
    try:
        assert complete("served at tp 2")[0] == 200
        sent = w.mesh.counts["broadcast"]
        last = w.mesh.last_broadcast
        deadline = time.monotonic() + 20.0
        while w.mesh.last_broadcast <= last + 0.2 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert w.mesh.last_broadcast > last + 0.2
        assert w.mesh.counts["broadcast"] == sent
        assert complete("served after keep-alives")[0] == 200
        if where == "rank0_mid_forward":
            mlp = ttf._mlp

            def faulty(*args, **kwargs):
                # Rank 0 leaves after layer 0's attention all-reduce:
                # its follower waits in the MLP's.
                raise RuntimeError("planted fault in a sharded forward")
            monkeypatch.setattr(ttf, "_mlp", faulty)
            t0 = time.monotonic()
            status, body = complete("the step that faults")
            monkeypatch.setattr(ttf, "_mlp", mlp)
            assert status == 500, body
            assert "planted fault" in w.engine_error
        else:
            follower.kill()
            t0 = time.monotonic()
            deadline = t0 + 30.0
            while w.engine_error is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert "rank 1 exited" in (w.engine_error or "")
        assert time.monotonic() - t0 < 30.0
        assert not w._engine_loop_alive
        assert follower.poll() is not None
        assert complete("after the fault")[0] == 500
    finally:
        # A stop that waits on a collective fails the test, not hangs it.
        stopper = threading.Thread(target=w.stop, daemon=True)
        stopper.start()
        stopper.join(30.0)
        if follower.poll() is None:
            follower.kill()
        assert not stopper.is_alive(), "the worker's stop hung"


# ---------------------------------------------------------------------------
# Refusals and geometry
# ---------------------------------------------------------------------------

def test_nccl_two_ranks_on_one_card_raises():
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        ranks.plan_devices(2, "cuda", "nccl", device_count=1)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        tmesh.check_backend("nccl", ["host/GPU-0", "host/GPU-0"])
    with pytest.raises(ValueError, match="gloo"):
        ranks.plan_devices(2, "cpu", "nccl")
    # Two cards for two ranks, or gloo on one: allowed.
    assert ranks.plan_devices(2, "cuda", "nccl", device_count=2) == [
        "cuda:0", "cuda:1"]
    assert ranks.plan_devices(2, "cuda", "gloo", device_count=1) == [
        "cuda:0", "cuda:0"]
    tmesh.check_backend("gloo", ["host/GPU-0", "host/GPU-0"])


REFUSED_CONFIGS = {
    "cuda_graphs": dict(cuda_graphs=True),
    "decode_pipeline": dict(decode_steps=4, decode_pipeline=True),
    "spill_tier": dict(kv_spill_mb=1.0),
}


@pytest.mark.parametrize("name", sorted(REFUSED_CONFIGS))
def test_engine_config_refused_under_mesh(pool, name):
    cfg = ModelConfig(**MODELS["tiny"])
    ecfg = EngineConfig(page_size=4, num_pages=16, max_model_len=64,
                        prefill_buckets=(8,), **REFUSED_CONFIGS[name])
    msgs = pool.run({"tp": 2}, "refusal", cfg, ecfg)
    assert all(m is not None and "mesh" in m for m in msgs), msgs


def test_unsharded_paths_raise_under_mesh(pool):
    cfg = ModelConfig(**MODELS["tiny"])
    ecfg = EngineConfig(page_size=4, num_pages=16, max_model_len=64,
                        prefill_buckets=(8,))
    for msgs in pool.run({"tp": 2}, "engine_refusals", cfg, ecfg):
        assert len(msgs) == 5
        assert all(m is not None and "not sharded" in m for m in msgs), msgs


@pytest.mark.parametrize("spec", [dict(dp=2, tp=4), dict(ep=2, sp=2, tp=2),
                                  dict(dp=2, ep=2, sp=2)])
def test_mesh_coords_match_jax(spec):
    """A rank's (dp, ep, sp, tp) coordinates are its device's place in
    the JAX mesh's grid (tp fastest)."""
    jm = jmesh.make_mesh(jmesh.MeshSpec(**spec))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    ts = tmesh.MeshSpec(**spec)
    for rank in range(ts.num_devices):
        c = ts.coords(rank)
        assert ids[c["dp"], c["ep"], c["sp"], c["tp"]] == jm.devices.flat[
            rank].id
        assert ts.rank_of(c) == rank


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_kv_rule_matches_jax(tp):
    for model in ("tiny", "v2_lite"):
        jcfg = JaxModelConfig(**MODELS[model])
        tcfg = ModelConfig(**MODELS[model])
        assert tuple(jsharding.kv_cache_pspec(jcfg, tp)) == \
            tsharding.kv_cache_pspec(tcfg, tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_kv_cache_holds_the_heads_the_rank_reads(tp):
    """Each rank's pools and k/v projection columns hold exactly the KV
    heads its query heads read: split at tp = 2, one replicated head a
    rank at tp = 4 (``tiny``'s 2 KV heads), the rank's view of the model
    counting them."""
    cfg = ModelConfig(**MODELS["tiny"])
    L, Hq, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    spec = tmesh.MeshSpec(tp=tp)
    heads = torch.arange(Hkv, dtype=torch.float32)
    pool = heads[None, None, None, :, None].expand(L, 3, 4, Hkv, Dh)
    cols = heads.repeat_interleave(Dh)[None, None].expand(L, 8, Hkv * Dh)
    hq, G = Hq // tp, Hq // Hkv
    for r in range(tp):
        m = tmesh.Mesh(spec, r, "gloo", "cpu", {})
        scfg = tsharding.shard_config(cfg, spec)
        want = sorted({(r * hq + j) // G for j in range(hq)})
        k, v = tsharding.shard_kv_cache((pool, pool), m, cfg)
        assert k.shape[3] == v.shape[3] == scfg.num_kv_heads == len(want)
        assert k[0, 0, 0, :, 0].tolist() == want
        kp = tsharding.shard_leaf("k_proj", cols, m, cfg)
        assert kp[0, 0, ::Dh].tolist() == want
        assert scfg.num_heads == hq
