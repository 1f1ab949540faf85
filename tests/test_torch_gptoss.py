"""GPT-OSS in the port against the JAX package, on the CPU, at tiny
shapes: three layers (sliding, full, sliding), windows of 6, attention
sinks, biased q/k/v/o, yarn rope, 4 experts top-2 behind the biased
router, clamped-GLU experts with biases.

- ``dequant_mxfp4`` bit-equal to JAX's on random blocks and every scale;
- ``moe_mlp(expert_style="gptoss")``: outputs and drop counts on the
  capacity path, and the dense oracle;
- ``forward_prefill`` / ``forward_decode`` logits and pools in both
  orders of the KV write (atol = rtol = 1e-4, float32), and a ragged
  step;
- the engines' greedy streams, per-step ledger and ``moe_dropped_tokens``;
- a port worker serving a ``transformers`` ``GptOssForCausalLM``
  directory in the bf16 and the MXFP4 dialect with the JAX worker's
  texts.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import (EngineConfig as JaxEngineConfig,
                                     InstanceType as JaxInstanceType,
                                     ModelConfig as JaxModelConfig)
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.parallel import expert as jexpert
from xllm_service_tpu.runtime import checkpoint as jck
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import \
    InMemoryStore as JaxInMemoryStore
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.parallel import expert as texpert
from xllm_service_tpu_torch.runtime import checkpoint as tck
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_checkpoint import _float32, _same_leaves
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
GPTOSS = dict(attention_bias=True, sliding_window=6,
              layer_sliding=(True, False, True), num_layers=3,
              num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
              gptoss=True, moe_intermediate_size=48,
              rope_scaling=("yarn", 32.0, 32.0, 1.0, 64,
                            1.3465735902799727, False, 0.0),
              dtype="float32")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _setup(vocab=96, **kw):
    """Both packages' configs and weights: JAX ``init_params`` with the
    biases, sinks and router bias drawn (they init to zeros)."""
    kw = dict(GPTOSS, **kw)
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=vocab), **kw)
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=vocab), **kw)
    jp = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("sinks", "o_bias", "q_bias", "k_bias", "v_bias",
              "router_bias", "gate_bias", "up_bias", "down_bias"):
        jp["layers"][k] = (0.5 * rng.standard_normal(
            jp["layers"][k].shape)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg, "cpu")


# ---------------------------------------------------------------------------
# MXFP4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 4, 16), (2, 7, 3, 16)])
def test_dequant_mxfp4_bit_equal_to_jax(shape):
    """Random codes and every E8M0 scale (0-255: subnormal results, and
    infinities past the float32 range, as ``np.ldexp`` gives them)."""
    rng = np.random.default_rng(shape[1])
    blocks = rng.integers(0, 256, size=shape, dtype=np.uint8)
    scales = rng.integers(0, 256, size=shape[:-1], dtype=np.uint8)
    scales.reshape(-1)[:256] = np.arange(256)[:scales.size]
    want = jck.dequant_mxfp4(blocks, scales)
    got = tck.dequant_mxfp4(_t(blocks), _t(scales))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


# ---------------------------------------------------------------------------
# The experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no_drops"])
def test_gptoss_moe_mlp_matches_jax(cf):
    """The capacity path with GPT-OSS's routing map (softmax over the
    top-k biased logits), expert biases and the clamped GLU: outputs and
    drop counts; 3 x 21 tokens in groups of 32."""
    rng = np.random.default_rng(5)
    B, T, D, E, Fe, k = 3, 21, 16, 8, 12, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, router, rbias = f(B, T, D), f(D, E), f(E)
    gate, up, down = 2 * f(E, D, Fe), 2 * f(E, D, Fe), 0.3 * f(E, Fe, D)
    gb, ub, db = f(E, Fe), f(E, Fe), f(E, D)
    valid = rng.random((B, T)) > 0.2
    logits = x @ router + rbias
    top = np.argsort(-logits, axis=-1)[..., :k]
    tv = np.take_along_axis(logits, top, -1)
    w = np.exp(tv - tv.max(-1, keepdims=True))
    gates = np.zeros_like(logits)
    np.put_along_axis(gates, top, w / w.sum(-1, keepdims=True), -1)
    jout, jdrop = jexpert.moe_mlp(
        jnp.asarray(x), jnp.asarray(router), jnp.asarray(gate),
        jnp.asarray(up), jnp.asarray(down), k, cf, valid=jnp.asarray(valid),
        group_size=32, norm_topk=False, gates=jnp.asarray(gates),
        expert_style="gptoss", gate_b=jnp.asarray(gb), up_b=jnp.asarray(ub),
        down_b=jnp.asarray(db))
    tout, tdrop = texpert.moe_mlp(
        _t(x), _t(router), _t(gate), _t(up), _t(down), k, cf,
        valid=_t(valid), group_size=32, norm_topk=False, gates=_t(gates),
        expert_style="gptoss", gate_b=_t(gb), up_b=_t(ub), down_b=_t(db))
    _close(tout, jout, dict(atol=1e-5, rtol=1e-5))
    assert int(tdrop) == int(jdrop)
    assert (int(tdrop) == 0) == (cf > 1)


@pytest.mark.parametrize("cf", [0.0, 0.5, 2.0],
                         ids=["dense_oracle", "low_capacity", "default"])
def test_gptoss_mlp_matches_jax(cf):
    """The layer's MLP (router, top-k, softmax over the k, experts) on
    the dense oracle and the capacity path: outputs and drops."""
    jcfg, tcfg, jp, tp = _setup(moe_capacity_factor=cf)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jl = {k: jnp.asarray(v[1]) for k, v in jp["layers"].items()}
    tl = {k: v[1] for k, v in tp["layers"].items()}
    jout, jdrop = jtf._mlp(jl, jcfg, jnp.asarray(x))
    drop = torch.zeros((), dtype=torch.int64)
    tout = ttf._mlp(tl, tcfg, _t(x), moe_dropped=drop)
    _close(tout, jout)
    assert int(drop) == int(jdrop)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return _setup()


@pytest.mark.parametrize("write_then_attend", [True, False],
                         ids=["write_then_attend", "attend_then_write"])
def test_gptoss_forward_matches_jax(tiny, write_then_attend):
    """Two prefill windows past the window of 6 (lengths 27 and 19), then
    two decode steps, one row inactive on the second: logits and
    pools."""
    jcfg, tcfg, jparams, tparams = tiny
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
        _close(tl, jl)
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
        _close(tl.numpy()[rows], np.asarray(jl)[rows])
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    for i in (0, 1):
        _close(tkv[i], jkv[i])


def test_gptoss_ragged_forward_matches_jax(tiny):
    """The ragged mixed step: decode rows past the window beside a
    window, each layer with its own window and the sinks."""
    jcfg, tcfg, jparams, tparams = tiny
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
        _close(tl.numpy()[rows], np.asarray(jl)[rows])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=160, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))


def _drive(engine, request, sampling):
    """Greedy requests of 9, 40 and 6 tokens (the second past the
    window, chunked) to idle; returns (streams, per-step ledger)."""
    rng = np.random.default_rng(0)
    feed = {step: [(f"r{step}-{i}", rng.integers(3, 128, size=n).tolist(),
                    m) for i, (n, m) in enumerate(reqs)]
            for step, reqs in {1: [(9, 8)], 2: [(40, 7), (6, 6)]}.items()}
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
                       engine.last_step_decode_tokens))
        assert step < 200, "engine did not drain"
    return streams, ledger


@pytest.mark.parametrize("write_then_attend", [False, True])
def test_gptoss_engine_matches_jax(write_then_attend):
    """Greedy streams, the step ledger and the capacity drops of the two
    engines (capacity factor 0.5, so that experts overflow)."""
    jcfg, tcfg, jparams, tparams = _setup(vocab=128,
                                          moe_capacity_factor=0.5)
    kw = dict(ENGINE_KW, write_then_attend=write_then_attend)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **kw, decode_steps=1, enable_prefix_cache=False), params=jparams)
    jst, jled = _drive(jeng, JaxRequest, JaxSampling)
    teng = Engine(tcfg, EngineConfig(**kw, enable_prefix_cache=False),
                  params=tparams, device="cpu")
    tst, tled = _drive(teng, EngineRequest, SamplingParams)
    assert tst == jst and len(tst) == 3
    assert tled == jled
    assert teng.moe_dropped_tokens == jeng.moe_dropped_tokens > 0


# ---------------------------------------------------------------------------
# A port worker on a transformers GPT-OSS directory
# ---------------------------------------------------------------------------

def _hf_dir(path: str) -> str:
    """A random ``GptOssForCausalLM`` (vocab 512 for the byte tokenizer;
    sinks, biases and norms drawn), saved by ``save_pretrained``."""
    from transformers import GptOssConfig, GptOssForCausalLM
    torch.manual_seed(0)
    cfg = GptOssConfig(
        vocab_size=512, hidden_size=64, intermediate_size=64,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=6, max_position_embeddings=256)
    model = GptOssForCausalLM(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "bias" in name or "sinks" in name:
                p.add_(0.3 * torch.randn_like(p))
            elif "experts" in name:
                p.mul_(20.0)
    model.save_pretrained(path)
    return path


def _to_mxfp4(src: str, dst: str) -> str:
    """The same model in the MXFP4 dialect: each expert stack as random
    E2M1 codes and E8M0 scales in [119, 127], the rest as it was."""
    from safetensors.numpy import load_file, save_file
    os.makedirs(dst)
    rng = np.random.default_rng(3)
    tensors = load_file(os.path.join(src, "model.safetensors"))
    out = {}
    for k, v in tensors.items():
        if k.endswith("experts.gate_up_proj") or \
                k.endswith("experts.down_proj"):
            E, rows_in, rows_out = v.shape          # [E, in, out]
            out[k + "_blocks"] = rng.integers(
                0, 256, size=(E, rows_out, rows_in // 32, 16),
                dtype=np.uint8)
            out[k + "_scales"] = rng.integers(
                119, 128, size=(E, rows_out, rows_in // 32), dtype=np.uint8)
        else:
            out[k] = v
    save_file(out, os.path.join(dst, "model.safetensors"))
    with open(os.path.join(src, "config.json")) as f, \
            open(os.path.join(dst, "config.json"), "w") as g:
        g.write(f.read())
    return dst


PROMPTS = ("sinks and windows", "an expert bucket", "yarn rope")


def _texts(addr):
    out = []
    for p in PROMPTS:
        status, resp = http_json("POST", addr, "/v1/completions", {
            "prompt": p, "max_tokens": 10, "temperature": 0.0,
            "ignore_eos": True}, timeout=120.0)
        assert status == 200, resp
        out.append((resp["choices"][0]["text"], resp["usage"]))
    return out


@pytest.mark.parametrize("dialect", ["bf16", "mxfp4"])
def test_worker_serves_gptoss_directory_as_jax(tmp_path, dialect):
    """The directory's config resolved alike, bit-equal float32 leaves
    from both loaders, and the JAX worker's temperature-0 texts."""
    d = _hf_dir(str(tmp_path / "bf16"))
    if dialect == "mxfp4":
        d = _to_mxfp4(d, str(tmp_path / "mxfp4"))
    jcfg = jax_worker.resolve_model_config("gpt", d)
    tcfg = torch_worker.resolve_model_config("gpt", d)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.gptoss and tcfg.layer_sliding == (True, False, True)
    f32 = dataclasses.replace(tcfg, dtype="float32")
    mine = tck.load_checkpoint(d, f32, "cpu")
    _same_leaves(mine, jck.load_checkpoint(
        d, dataclasses.replace(jcfg, dtype="float32")))
    assert mine["layers"]["sinks"].dtype == torch.float32
    mp = pytest.MonkeyPatch()
    _float32(mp)
    ecfg = dict(page_size=16, num_pages=64, max_model_len=256,
                max_batch_size=4, max_prefill_tokens=256,
                prefill_buckets=(32, 64, 128))
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="gpt", device="cpu", model_dir=d),
        engine_cfg=EngineConfig(**ecfg)).start()
    jw = jax_worker.Worker(
        jax_worker.WorkerOptions(port=0, model="gpt", model_dir=d,
                                 instance_type=JaxInstanceType.DEFAULT),
        JaxInMemoryStore(sweep_interval_s=0.05),
        engine_cfg=JaxEngineConfig(**ecfg)).start()
    try:
        assert tw.primary_runtime().timings["source"] == "checkpoint"
        assert tck.param_digests(tw.engine.params) == \
            tck.param_digests(mine)
        assert _texts(tw.name) == _texts(jw.name)
    finally:
        tw.stop()
        jw.stop()
        mp.undo()
