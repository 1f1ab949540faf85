"""Gemma-3 in the port against the JAX package, on the CPU in float32.

A tiny Gemma-3: six layers (five local with a 16-token window, one
global), head_dim 64 (a kernel instantiation), per-layer rope bases
(local 10k unscaled, global 1M with an 8x linear factor), qk-norm,
Gemma's four-norm block and scaled tied embeddings. The weights are the
JAX ``init_params``, carried across by ``params_from_jax``; the prompts
are longer than the window.

Pinned:
- ``forward_prefill`` (two chunked windows), ``forward_decode`` and the
  ragged mixed step (write-then-attend; the other order is held by the
  engine streams) give the
  JAX forwards' logits within atol = rtol = 1e-4 (float32 through six
  layers; the frameworks sum in different orders);
- the engines' temperature-0 token streams, in both write orders, equal
  the JAX engine's;
- a ``--model-dir`` of a random-init ``transformers`` Gemma-3 text model
  resolves to the JAX config and loads to the JAX loader's leaves, bit
  for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# transformers without its TensorFlow half (as tests/test_torch_qwen2vl.py).
os.environ.setdefault("USE_TF", "0")

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime import checkpoint as jck
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import rope as trope
from xllm_service_tpu_torch.runtime import checkpoint as tck
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_checkpoint import _both_configs, _same_leaves
from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401
from tests.test_torch_ragged import _drive, _feed

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 128
GEMMA3 = dict(gemma=True, qk_norm=True, num_layers=6, num_heads=4,
              num_kv_heads=2, head_dim=64, sliding_window=16,
              layer_sliding=(True,) * 5 + (False,), rope_theta=1e6,
              rope_local_base_freq=1e4,
              rope_scaling=("linear", 8.0, 0.0, 0.0, 0),
              query_pre_attn_scalar=64, tie_word_embeddings=True,
              dtype="float32")
ENGINE_KW = dict(page_size=8, num_pages=96, max_model_len=96,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))
# {step: [(prompt length, max_tokens)]}: two prompts past the window.
WORKLOAD = {1: [(40, 8), (9, 6)], 2: [(27, 7)]}


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                               **GEMMA3)
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB), **GEMMA3)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_layer_rope_table_matches_jax(model):
    """The [L, 2] (theta, factor) table, and the uniform collapses (all
    local with a window, all global without)."""
    jcfg, tcfg, _, _ = model
    for j, t in ((jcfg, tcfg),
                 (dataclasses.replace(jcfg, layer_sliding=None),
                  dataclasses.replace(tcfg, layer_sliding=None)),
                 (dataclasses.replace(jcfg, layer_sliding=None,
                                      sliding_window=None),
                  dataclasses.replace(tcfg, layer_sliding=None,
                                      sliding_window=None))):
        np.testing.assert_array_equal(
            np.asarray(trope.layer_rope(t), np.float32),
            np.asarray(jtf._layer_rope(j)))
    assert trope.layer_rope(ModelConfig.tiny()) is None
    sets = trope.layer_cos_sin(tcfg, torch.arange(5)[None])
    assert len({id(s) for s in sets}) == 2
    x = np.random.default_rng(0).standard_normal((1, 5, 2, 64)).astype(
        np.float32)
    pos = np.arange(5, dtype=np.int32)[None]
    _close(trope.apply_rope_dynamic(torch.from_numpy(x),
                                    torch.from_numpy(pos), 1e6, 8.0),
           jtf.apply_rope_dynamic(jnp.asarray(x), jnp.asarray(pos),
                                  jnp.float32(1e6), jnp.float32(8.0)))


def test_prefill_then_decode_match_jax(model, write_then_attend=True):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    P, ps, B, MP = 24, 8, 2, 8
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompt = rng.integers(3, VOCAB, size=(B, 45)).astype(np.int32)
    lens = np.array([45, 30], np.int32)
    for start, T in ((0, 32), (32, 16)):
        win = np.zeros((B, T), np.int32)
        n = np.clip(lens - start, 0, T).astype(np.int32)
        for b in range(B):
            win[b, :n[b]] = prompt[b, start:start + n[b]]
        st = np.full((B,), start, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(win), jnp.asarray(st),
            jnp.asarray(n), jkv, jnp.asarray(pt),
            write_then_attend=write_then_attend)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, torch.from_numpy(win).long(),
            torch.from_numpy(st), torch.from_numpy(n), tkv,
            torch.from_numpy(pt), write_then_attend=write_then_attend)
        live = n > 0
        _close(tl[torch.from_numpy(live)], np.asarray(jl)[live])
    _close(tkv[0], jkv[0])
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    active = np.ones(B, bool)
    jl, jkv = jtf.forward_decode(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(lens),
        jnp.asarray(active), jkv, jnp.asarray(pt),
        write_then_attend=write_then_attend)
    tl, tkv = ttf.forward_decode(
        tparams, tcfg, torch.from_numpy(tok).long(), torch.from_numpy(lens),
        torch.from_numpy(active), tkv, torch.from_numpy(pt),
        write_then_attend=write_then_attend)
    _close(tl, jl)
    _close(tkv[0], jkv[0])
    _close(tkv[1], jkv[1])


def test_ragged_step_matches_jax(model):
    """One ragged mix: a decode row at position 36 (its window trims the
    first 21 tokens) beside a 20-token prefill window."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    P, ps, B, MP = 24, 8, 2, 8
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    # Row 0's context: 36 tokens prefilled first.
    ctx = rng.integers(3, VOCAB, size=(1, 36)).astype(np.int32)
    win = np.zeros((B, 36), np.int32)
    win[0] = ctx[0]
    n = np.array([36, 0], np.int32)
    st = np.zeros(B, np.int32)
    _, _, jkv = jtf.forward_prefill(
        jparams, jcfg, jnp.asarray(win), jnp.asarray(st), jnp.asarray(n),
        jkv, jnp.asarray(pt), write_then_attend=True)
    _, tkv = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(win).long(), torch.from_numpy(st),
        torch.from_numpy(n), tkv, torch.from_numpy(pt))
    mix = np.zeros((B, 20), np.int32)
    mix[0, 0] = 7
    mix[1] = rng.integers(3, VOCAB, size=20)
    st = np.array([36, 0], np.int32)
    n = np.array([1, 20], np.int32)
    jl, _, jkv = jtf.forward_prefill(
        jparams, jcfg, jnp.asarray(mix), jnp.asarray(st), jnp.asarray(n),
        jkv, jnp.asarray(pt), ragged=True, write_then_attend=True)
    tl, tkv = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(mix).long(), torch.from_numpy(st),
        torch.from_numpy(n), tkv, torch.from_numpy(pt), ragged=True)
    _close(tl, jl)
    _close(tkv[0], jkv[0])


@pytest.fixture(scope="module")
def jax_streams(model):
    jcfg, _, jparams, _ = model
    engine = JaxEngine(jcfg, JaxEngineConfig(
        **ENGINE_KW, decode_steps=1, enable_prefix_cache=False),
        params=jparams)
    return _drive(engine, _feed(WORKLOAD, seed=3), JaxRequest,
                  JaxSampling)[0]


@pytest.mark.parametrize("write_then_attend", [True, False])
def test_engine_streams_match_jax(model, jax_streams, write_then_attend):
    _, tcfg, _, tparams = model
    engine = Engine(tcfg, EngineConfig(
        **ENGINE_KW, enable_prefix_cache=False,
        write_then_attend=write_then_attend), params=tparams, device="cpu")
    assert engine.write_then_attend is write_then_attend
    mine = _drive(engine, _feed(WORKLOAD, seed=3), EngineRequest,
                  SamplingParams)[0]
    assert mine == jax_streams
    assert sorted(len(v) for v in mine.values()) == [6, 7, 8]


def test_model_dir_loads_as_jax(tmp_path):
    """A random-init ``transformers`` Gemma3ForCausalLM saved to a
    directory: the same config in both packages and bit-equal bf16
    leaves."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
        num_hidden_layers=6, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, sliding_window=16, query_pre_attn_scalar=64,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        max_position_embeddings=256)
    torch.manual_seed(0)
    model = transformers.Gemma3ForCausalLM(hf_cfg)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    jcfg, tcfg = _both_configs(str(tmp_path), "bfloat16")
    assert tcfg.rope_local_base_freq == 10000.0
    assert tcfg.layer_sliding == (True,) * 5 + (False,)
    _same_leaves(tck.load_checkpoint(str(tmp_path), tcfg, "cpu"),
                 jck.load_checkpoint(str(tmp_path), jcfg))
