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
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

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
    """Every family of the worker's catalog is accepted (Gemma-3's
    per-layer rope bases since they were ported; MoE, MLA, GPT-OSS,
    Gemma-2 and the mrope of Qwen2-VL before); a rope scaling this
    package lacks is still refused."""
    from xllm_service_tpu_torch.runtime.worker import _MODEL_REGISTRY
    mrope = dataclasses.replace(ModelConfig.tiny(),
                                rope_scaling=("mrope", (2, 3, 3)))
    for cfg in [f() for f in _MODEL_REGISTRY.values()] + [mrope]:
        ttf.check_supported(cfg)
    with pytest.raises(NotImplementedError):
        ttf.check_supported(dataclasses.replace(
            ModelConfig.tiny(), rope_scaling=("dynamic", 2.0, 0, 0, 0)))


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_ragged_forward_matches_jax(family):
    """One ragged forward: two decode rows (length 1, starting mid-page),
    a first window and a continuation window, after a plain prefill has
    put the decode rows' and the continuation's prefixes in the pools."""
    jcfg, tcfg, jparams, tparams = _setup(family)
    rng = np.random.default_rng(1)
    P, ps, B, MP = 32, 8, 4, 6
    jkv = jtf.init_kv_cache(jcfg, P, ps)
    tkv = ttf.init_kv_cache(tcfg, P, ps, "cpu")
    pt = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    prompts = [rng.integers(3, 96, size=n).astype(np.int32)
               for n in (13, 21, 16, 22)]

    def both(tokens, start, lens, ragged=False):
        nonlocal jkv, tkv
        jl, _, jkv = jtf.forward_prefill(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(start),
            jnp.asarray(lens), jkv, jnp.asarray(pt), write_then_attend=True,
            page_aligned_prefill=not ragged, ragged=ragged)
        tl, tkv = ttf.forward_prefill(
            tparams, tcfg, torch.from_numpy(tokens).long(),
            torch.from_numpy(start), torch.from_numpy(lens), tkv,
            torch.from_numpy(pt), ragged=ragged)
        return np.asarray(jl), tl

    # Prefixes: rows 0 and 1 whole (they decode next), row 3's first 10
    # tokens (its continuation comes next), nothing for row 2.
    pre = np.zeros((B, 24), np.int32)
    pre_lens = np.array([13, 21, 0, 10], np.int32)
    for b in (0, 1, 3):
        pre[b, :pre_lens[b]] = prompts[b][:pre_lens[b]]
    jl, tl = both(pre, np.zeros(B, np.int32), pre_lens)
    _close(tl[[0, 1, 3]], jl[[0, 1, 3]])
    # The ragged batch in a T = 16 bucket: decode rows at 13 and 21 (both
    # mid-page), row 2's first window, row 3's window from 10.
    tokens = np.zeros((B, 16), np.int32)
    tokens[0, 0], tokens[1, 0] = jl[0].argmax(), jl[1].argmax()
    tokens[2, :16] = prompts[2]
    tokens[3, :12] = prompts[3][10:]
    start = np.array([13, 21, 0, 10], np.int32)
    lens = np.array([1, 1, 16, 12], np.int32)
    jl, tl = both(tokens, start, lens, ragged=True)
    _close(tl, jl)
    _close(tkv[0], jkv[0])
    _close(tkv[1], jkv[1])
