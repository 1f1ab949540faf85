"""The port's mixture-of-experts path against the JAX package's, on the
CPU in float32.

- ``parallel/expert.py``: ``capacity`` equal; ``topk_dispatch`` and
  ``moe_mlp`` with capacity low enough that assignments drop, ``valid``
  masks, ``norm_topk`` on and off and a caller-given routing map, against
  JAX: dispatch masks and drop counts equal, combine weights and outputs
  within atol = rtol = 1e-5 (float32, different summation orders).
  Inputs have no ties (``torch.topk`` and ``jax.lax.top_k`` may break
  ties apart).
- Forwards of ``ModelConfig.tiny(num_experts=4)`` (Mixtral-style
  routing), a Qwen3-MoE variant (unnormalized top-k) and the dense
  oracle (capacity factor 0), in both orders of the KV write: logits and
  pools within atol = rtol = 1e-4.
- The engine: temperature-0 streams and per-step ledger identical to the
  JAX engine's.
- The worker serving ``tiny-moe``: texts equal to the JAX worker's.
"""

import dataclasses
import json
from http.client import HTTPConnection

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.parallel import expert as jexpert
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel import expert as texpert
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# parallel/expert.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(8, 64, 6, 2.0), (512, 64, 6, 2.0),
                                  (16, 4, 2, 0.5), (5, 8, 2, 8.0),
                                  (512, 8, 2, 1.25)])
def test_capacity_matches_jax(args):
    assert texpert.capacity(*args) == jexpert.capacity(*args)
    # DeepSeek-V2-Lite's decode step of 8 rows: every expert a bucket of 8.
    assert texpert.capacity(8, 64, 6, 2.0) == 8


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("with_valid", [True, False])
def test_topk_dispatch_matches_jax(norm_topk, with_valid):
    """12 tokens, 6 experts, top-3 into buckets of 4: some assignments
    drop; invalid tokens route nowhere."""
    rng = np.random.default_rng(21)
    N, E, k, cap = 12, 6, 3, 4
    gates = np.asarray(jax.nn.softmax(jnp.asarray(_f32(rng, N, E)), -1))
    valid = rng.random(N) > 0.3 if with_valid else None
    jd, jc = jexpert.topk_dispatch(
        jnp.asarray(gates), k, cap,
        None if valid is None else jnp.asarray(valid), norm_topk)
    td, tc = texpert.topk_dispatch(_t(gates), k, cap,
                                   None if valid is None else _t(valid),
                                   norm_topk)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc)
    kept = int(td.sum())
    asked = k * (N if valid is None else int(valid.sum()))
    assert kept < asked                       # the capacity bites
    if valid is not None:
        assert not td.numpy()[~valid].any()


MOE_CASES = {
    "norm": dict(norm_topk=True),
    "unnormalized": dict(norm_topk=False),
    "valid": dict(norm_topk=True, valid=True),
    "caller_gates": dict(norm_topk=False, gates=True, valid=True),
    "no_drops": dict(norm_topk=True, capacity_factor=8.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    """B x T = 3 x 21 tokens in groups of 32 (the last group padded), 8
    experts, top-2, capacity factor 0.5 (buckets of 8 where a group asks
    8 of each expert on average) unless stated: outputs and drop counts
    equal."""
    kw = dict(MOE_CASES[case])
    rng = np.random.default_rng(31)
    B, T, D, E, Fe, k = 3, 21, 16, 8, 12, 2
    x = _f32(rng, B, T, D)
    router = _f32(rng, D, E)
    gate, up = _f32(rng, E, D, Fe) * 0.3, _f32(rng, E, D, Fe) * 0.3
    down = _f32(rng, E, Fe, D) * 0.3
    valid = rng.random((B, T)) > 0.25 if kw.pop("valid", False) else None
    gates = None
    if kw.pop("gates", False):
        # A DeepSeek-style map: k nonzero scaled weights per token.
        g = np.asarray(jax.nn.softmax(jnp.asarray(x @ router), -1))
        top = np.argsort(-g, axis=-1)[..., :k]
        gates = np.zeros_like(g)
        np.put_along_axis(gates, top, np.take_along_axis(g, top, -1) * 1.5,
                          -1)
    cf = kw.pop("capacity_factor", 0.5)
    jout, jdrop = jexpert.moe_mlp(
        jnp.asarray(x), jnp.asarray(router), jnp.asarray(gate),
        jnp.asarray(up), jnp.asarray(down), k, cf,
        valid=None if valid is None else jnp.asarray(valid), group_size=32,
        gates=None if gates is None else jnp.asarray(gates), **kw)
    tout, tdrop = texpert.moe_mlp(
        _t(x), _t(router), _t(gate), _t(up), _t(down), k, cf,
        valid=None if valid is None else _t(valid), group_size=32,
        gates=None if gates is None else _t(gates), **kw)
    _close(tout, jout)
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) == 0) == (case == "no_drops")


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

VARIANTS = {
    "mixtral": {},
    "qwen3_moe": {"qk_norm": True, "norm_topk_prob": False,
                  "qwen_moe": True, "moe_intermediate_size": 48},
    "dense_oracle": {"moe_capacity_factor": 0.0},
    "low_capacity": {"moe_capacity_factor": 0.5},
}


def _setup(variant, vocab=96):
    kw = dict(VARIANTS[variant], dtype="float32")
    jcfg = dataclasses.replace(
        JaxModelConfig.tiny(vocab_size=vocab, num_experts=4), **kw)
    tcfg = dataclasses.replace(
        ModelConfig.tiny(vocab_size=vocab, num_experts=4), **kw)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def test_moe_params_layout():
    _, tcfg, _, tparams = _setup("mixtral")
    ttf.check_supported(tcfg)
    assert tuple(tparams["layers"]["gate_proj"].shape) == (2, 4, 64, 128)
    mine = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tparams["layers"].items()}


@pytest.mark.parametrize("write_then_attend", [True, False],
                         ids=["write_then_attend", "attend_then_write"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_forward_matches_jax(variant, write_then_attend):
    """Two prefill windows (padding in the second; padded tokens take no
    capacity), then two decode steps, one row inactive on the second:
    logits and pools. Write-then-attend decode logits of an inactive row
    are padding and are not compared."""
    jcfg, tcfg, jparams, tparams = _setup(variant)
    rng = np.random.default_rng(0)
    P, ps, B, MP = 24, 8, 2, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompt = rng.integers(3, 96, size=(B, 27)).astype(np.int32)
    lens = np.array([27, 19], np.int32)
    wta = write_then_attend
    for start, T in ((0, 16), (16, 16)):
        win = np.zeros((B, T), np.int32)
        n = np.clip(lens - start, 0, T).astype(np.int32)
        for b in range(B):
            win[b, :n[b]] = prompt[b, start:start + n[b]]
        st = np.full((B,), start, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(win), jnp.asarray(st),
            jnp.asarray(n), jkv, jnp.asarray(pt), write_then_attend=wta)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, _t(win).long(), _t(st), _t(n), tkv, _t(pt),
            write_then_attend=wta)
        _close(tl, jl, MODEL_TOL)
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    pos = lens.copy()
    for active in (np.array([1, 1], bool), np.array([1, 0], bool)):
        jl, jkv = jtf.forward_decode(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jkv, jnp.asarray(pt),
            write_then_attend=wta)
        tl, tkv = ttf.forward_decode(
            tparams, tcfg, _t(tok).long(), _t(pos), _t(active), tkv, _t(pt),
            write_then_attend=wta)
        rows = active if wta else np.ones_like(active)
        _close(tl.numpy()[rows], np.asarray(jl)[rows], MODEL_TOL)
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    for i in (0, 1):
        _close(tkv[i], jkv[i], MODEL_TOL)


def test_moe_ragged_forward_matches_jax():
    """The ragged mixed step routes its rows like any batch: two decode
    rows and two windows in one T = 16 bucket."""
    jcfg, tcfg, jparams, tparams = _setup("mixtral")
    rng = np.random.default_rng(1)
    P, ps, B, MP = 32, 8, 4, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    for tokens, start, lens, ragged in (
            (rng.integers(3, 96, size=(B, 16)), [0] * 4, [13, 16, 0, 10],
             False),
            (rng.integers(3, 96, size=(B, 16)), [13, 16, 0, 10],
             [1, 1, 16, 6], True)):
        tokens = tokens.astype(np.int32)
        start, lens = np.array(start, np.int32), np.array(lens, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(start),
            jnp.asarray(lens), jkv, jnp.asarray(pt), write_then_attend=True,
            page_aligned_prefill=not ragged, ragged=ragged)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, _t(tokens).long(), _t(start), _t(lens), tkv,
            _t(pt), ragged=ragged)
        rows = lens > 0
        _close(tl.numpy()[rows], np.asarray(jl)[rows], MODEL_TOL)
    for i in (0, 1):
        _close(tkv[i], jkv[i], MODEL_TOL)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=160, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))
WORKLOAD = {1: [(9, 6)], 2: [(40, 5), (6, 4)]}


def _drive(engine, request, sampling):
    """Run WORKLOAD to idle; returns (streams, per-step ledger)."""
    rng = np.random.default_rng(0)
    feed = {step: [(f"r{step}-{i}", rng.integers(3, 128, size=n).tolist(), m)
                   for i, (n, m) in enumerate(reqs)]
            for step, reqs in WORKLOAD.items()}
    streams, ledger, step = {}, [], 0
    while engine.has_work() or step < max(feed):
        step += 1
        for rid, toks, max_tokens in feed.get(step, []):
            engine.add_request(request(rid, toks, sampling(
                max_tokens=max_tokens, temperature=0.0, ignore_eos=True)))
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
        assert step < 200, "engine did not drain"
    return streams, ledger


@pytest.mark.parametrize("write_then_attend", [False, True])
def test_moe_engine_matches_jax(write_then_attend):
    jcfg, tcfg, jparams, tparams = _setup("mixtral", vocab=128)
    kw = dict(ENGINE_KW, write_then_attend=write_then_attend)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **kw, decode_steps=1, enable_prefix_cache=False), params=jparams)
    jst, jled = _drive(jeng, JaxRequest, JaxSampling)
    teng = Engine(tcfg, EngineConfig(**kw, enable_prefix_cache=False),
                  params=tparams, device="cpu")
    tst, tled = _drive(teng, EngineRequest, SamplingParams)
    assert tst == jst
    assert tled == jled
    assert len(tst) == 3


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _post(addr, path, obj):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_worker_serves_tiny_moe():
    """``--model tiny-moe`` names the same shape in both workers; the
    port's takes a vocabulary of 512 (the byte tokenizer's ids run past
    256), so both are given that float32 configuration here."""
    tcfg = torch_worker.resolve_model_config("tiny-moe")
    assert tcfg.num_experts == 4 and tcfg.vocab_size == 512
    ttf.check_supported(tcfg)
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512,
                                                   num_experts=4),
                               dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny-moe", lambda: jcfg)
    jw = jax_worker.Worker(jax_worker.WorkerOptions(model="tiny-moe"),
                           InMemoryStore()).start()
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jtf.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, "cpu")
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny-moe", device="cpu"),
        model_cfg=tcfg, params=params).start()
    try:
        for path, body in (
                ("/v1/completions", {"prompt": "expert buckets",
                                     "max_tokens": 9, "temperature": 0.0}),
                ("/v1/chat/completions", {"messages": [
                    {"role": "user", "content": "route me"}],
                    "max_tokens": 7, "temperature": 0.0})):
            (js, jr), (ts, tr) = _post(jw.name, path, body), \
                _post(tw.name, path, body)
            assert js == ts == 200, (jr, tr)
            key = (lambda c: c["message"]["content"]) if "messages" in body \
                else (lambda c: c["text"])
            assert key(tr["choices"][0]) == key(jr["choices"][0])
            assert tr["usage"] == jr["usage"]
    finally:
        tw.stop()
        jw.stop()
        mp.undo()
