"""The port's dense transformer against the JAX package's, in the
write-then-attend form, on the same weights (``params_from_jax`` of
``init_params(cfg, PRNGKey(0))``), on the CPU in float32.

Tolerance: atol = rtol = 1e-4 on logits and pools (float32 through a
few layers; the two frameworks sum in different orders). Decode logits
of inactive rows are not compared: they are padding."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)

# Family deltas the dense path carries: Llama (tiny), Qwen2 (qkv bias),
# Qwen3 (q/k norm), Gemma-2 (alternating windows, soft-caps, attention
# scale, four-norm block, GELU, tied scaled embeddings), Mistral v0.1
# (uniform window), Llama-3 rope scaling.
FAMILIES = {
    "llama": {},
    "qwen2": {"attention_bias": True},
    "qwen3": {"qk_norm": True},
    "gemma2": {"gemma": True, "sliding_window": 6,
               "layer_sliding": (True, False),
               "attn_logit_softcapping": 30.0,
               "final_logit_softcapping": 20.0,
               "query_pre_attn_scalar": 32, "tie_word_embeddings": True},
    "mistral": {"sliding_window": 9},
    "llama3_rope": {"rope_scaling": ("llama3", 8.0, 1.0, 4.0, 64),
                    "tie_word_embeddings": True},
}


def _configs(family):
    kw = dict(FAMILIES[family], dtype="float32")
    return (dataclasses.replace(JaxModelConfig.tiny(vocab_size=96), **kw),
            dataclasses.replace(ModelConfig.tiny(vocab_size=96), **kw))


def _setup(family):
    jcfg, tcfg = _configs(family)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_params_from_jax_layout():
    jcfg, tcfg, jparams, tparams = _setup("gemma2")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(tparams) - 1 + len(tparams["layers"])
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tparams
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # init_params of the port gives the same tree shape.
    mine = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tparams["layers"].items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_two_windows_then_decode(family):
    jcfg, tcfg, jparams, tparams = _setup(family)
    rng = np.random.default_rng(0)
    P, ps, B, MP = 24, 8, 2, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompt = rng.integers(3, 96, size=(B, 27)).astype(np.int32)
    lens = np.array([27, 19], np.int32)
    # Two chunked windows: [0, 16) then the rest from start_pos 16.
    for start, T in ((0, 16), (16, 16)):
        win = np.zeros((B, T), np.int32)
        n = np.clip(lens - start, 0, T).astype(np.int32)
        for b in range(B):
            win[b, :n[b]] = prompt[b, start:start + n[b]]
        st = np.full((B,), start, np.int32)
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(win), jnp.asarray(st),
            jnp.asarray(n), jkv, jnp.asarray(pt), write_then_attend=True)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, torch.from_numpy(win).long(),
            torch.from_numpy(st), torch.from_numpy(n), tkv,
            torch.from_numpy(pt))
        _close(tl, jl)
    _close(tkv[0], jkv[0])
    _close(tkv[1], jkv[1])
    # Two decode steps, one row inactive on the second.
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    pos = lens.copy()
    for active in (np.array([1, 1], bool), np.array([1, 0], bool)):
        jl, jkv = jtf.forward_decode(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jkv, jnp.asarray(pt),
            write_then_attend=True)
        tl, tkv = ttf.forward_decode(
            tparams, tcfg, torch.from_numpy(tok).long(),
            torch.from_numpy(pos), torch.from_numpy(active), tkv,
            torch.from_numpy(pt))
        # Inactive rows are padding: the JAX reference attends them to
        # the mean of V, the kernels to zeros. Active rows only.
        _close(tl[torch.from_numpy(active)], np.asarray(jl)[active])
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    _close(tkv[0], jkv[0])
    _close(tkv[1], jkv[1])


def test_unsupported_families_refused():
    for cfg in (ModelConfig.tiny(num_experts=4), ModelConfig.deepseek_v2_lite(),
                ModelConfig.gemma3_12b()):
        with pytest.raises(NotImplementedError):
            ttf.check_supported(cfg)
