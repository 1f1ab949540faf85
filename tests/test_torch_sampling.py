"""The port's sampling surface (``ops/sampling.py``) and prompt scores
(``forward_prefill(prompt_lp_targets=...)``) against the JAX package's,
on the CPU.

Pinned here:

- threefry2x32 in plain torch: ``PRNGKey``, ``fold_in``, ``split`` and
  ``random_bits`` bit-equal to ``jax.random`` (jax 0.9,
  ``jax_threefry_partitionable``) over seeds, positions and shapes; the
  Gumbel noise of a seeded row within 1e-6 of ``jax.random.gumbel``;
- ``sample_tokens`` against JAX ``sample_tokens`` on random logits with
  mixed rows (greedy, temperature, top-k, top-p, seeded, penalties over
  counts, ``logit_bias``): token ids equal on greedy and seeded rows;
- ``apply_penalties``, ``update_counts``, the bias scatter-add,
  ``batch_bias`` and ``compute_top_logprobs`` within 1e-6 (ids equal
  except at ties under 1e-6); the packed pair equal to the JAX
  package's, seeds outside int32 refused by both with OverflowError and
  negative seeds unseeded on both;
- prompt logprobs of a dense (with and without the final soft-cap) and
  an MLA prefill within 1e-4 of the JAX forward's;
- ``parse_openai_sampling``, ``validate_sampling`` and the ``logit_bias``
  refusals equal to the JAX package's on every option above.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.ops import sampling as jsamp
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import sampling as tsamp
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_decode_graph import MLA
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

SEEDS = [0, 1, 7, 2 ** 31 - 1]
POSITIONS = [0, 1, 4095]
SHAPES = [(7,), (3, 5), (257,)]


def _key(seed):
    return tsamp.prng_key(torch.tensor(seed))


def _words(key):
    return [int(key[0]), int(key[1])]


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("position", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_equal_jax(seed, position):
    jk = jax.random.PRNGKey(seed)
    assert _words(_key(seed)) == np.asarray(jk).astype(np.int64).tolist()
    jf = jax.random.fold_in(jk, position)
    tf = tsamp.fold_in(_key(seed), torch.tensor(position))
    assert _words(tf) == np.asarray(jf).astype(np.int64).tolist()
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jf, shape)).astype(np.int64)
        np.testing.assert_array_equal(tsamp.random_bits(tf, shape).numpy(),
                                      want)
    np.testing.assert_array_equal(
        tsamp.split(tf, 5).numpy(),
        np.asarray(jax.random.split(jf, 5)).astype(np.int64))


def test_threefry_batched_keys_equal_jax():
    """[B] keys at once (the sampler's form): row b's bits are those of
    row b's key alone."""
    seeds = torch.tensor([0, 5, 2 ** 31 - 1, 123])
    positions = torch.tensor([3, 0, 4095, 77])
    key = tsamp.fold_in(tsamp.prng_key(seeds), positions)
    bits = tsamp.random_bits(key, (50,)).numpy()
    for b in range(4):
        jf = jax.random.fold_in(jax.random.PRNGKey(int(seeds[b])),
                                int(positions[b]))
        np.testing.assert_array_equal(
            bits[b], np.asarray(jax.random.bits(jf, (50,))).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_gumbel_close_to_jax(seed):
    noise = tsamp.seeded_gumbel(torch.tensor([seed] * 3),
                                torch.tensor(POSITIONS), 1000).numpy()
    for row, pos in enumerate(POSITIONS):
        want = np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.PRNGKey(seed), pos), (1000,)))
        np.testing.assert_allclose(noise[row], want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The sampler against JAX sample_tokens
# ---------------------------------------------------------------------------

def _mixed_rows(rng, V):
    """(port params, JAX params) of a mixed batch: greedy, greedy with
    penalties and a bias, temperature, top-k, top-p, seeded rows (one
    with top-k, one with penalties and a bias), a negative seed."""
    ban = int(rng.integers(V))
    rows = [dict(temperature=0.0),
            dict(temperature=0.0, presence_penalty=0.5,
                 frequency_penalty=0.7, logit_bias={ban: -100.0, 3: 5.0}),
            dict(temperature=0.8),
            dict(temperature=1.0, top_k=5),
            dict(temperature=0.9, top_p=0.8),
            dict(temperature=0.8, top_p=0.9, seed=1234),
            dict(temperature=1.2, top_k=20, seed=7),
            dict(temperature=0.7, seed=2 ** 31 - 1, presence_penalty=0.4,
                 frequency_penalty=0.3, logit_bias={5: 3.0}),
            dict(temperature=1.0, seed=-3)]
    return ([SamplingParams(**r) for r in rows],
            [JaxSampling(**r) for r in rows])


@pytest.mark.parametrize("case", range(4))
def test_sample_tokens_match_jax(case):
    rng = np.random.default_rng(case)
    V = 300
    tparams, jparams = _mixed_rows(rng, V)
    B = len(tparams)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32) \
        * (rng.random((B, V)) < 0.05)
    positions = rng.integers(0, 5000, size=B).astype(np.int32)
    f32, i32 = jsamp.SamplingTensors.pack_batch(jparams)
    ids, vals = JaxEngine._batch_bias(jparams, B, V)
    want = np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits),
        jsamp.SamplingTensors.unpack(jnp.asarray(f32), jnp.asarray(i32)),
        jax.random.PRNGKey(case), positions=jnp.asarray(positions),
        counts=jnp.asarray(counts), bias_ids=ids, bias_vals=vals))
    got = tsamp.sample_tokens(
        torch.from_numpy(logits), tparams, torch.Generator().manual_seed(0),
        positions=positions.tolist(),
        counts=torch.from_numpy(counts)).numpy()
    compared = [i for i, p in enumerate(tparams)
                if p.temperature == 0.0
                or (p.seed is not None and p.seed >= 0)]
    assert len(compared) == 5
    np.testing.assert_array_equal(got[compared], want[compared])
    # The banned token never comes out of the biased greedy row.
    assert got[1] != next(t for t, v in tparams[1].logit_bias.items()
                          if v < 0)


def test_seeded_row_is_batch_independent():
    """A seeded row's token is the same alone and among other rows,
    whatever the generator holds."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy((rng.normal(size=(3, 64)) * 2)
                              .astype(np.float32))
    seeded = SamplingParams(temperature=1.0, top_p=0.95, seed=42)
    for pos in range(20):
        alone = tsamp.sample_tokens(logits[1:2], [seeded],
                                    torch.Generator().manual_seed(pos),
                                    positions=[pos])
        mixed = tsamp.sample_tokens(
            logits, [SamplingParams(temperature=0.5), seeded,
                     SamplingParams(temperature=0.0)],
            torch.Generator().manual_seed(99), positions=[3, pos, 9])
        assert int(alone[0]) == int(mixed[1])


def test_penalties_and_counts_match_jax():
    rng = np.random.default_rng(3)
    B, V = 5, 80
    logits = rng.normal(size=(B, V)).astype(np.float32)
    counts = rng.integers(0, 4, size=(B, V)).astype(np.int32)
    pres = rng.random(B).astype(np.float32)
    freq = rng.random(B).astype(np.float32)
    params = [SamplingParams(presence_penalty=float(p),
                             frequency_penalty=float(f))
              for p, f in zip(pres, freq)]
    st = tsamp.SamplingTensors.from_packed(
        tsamp.SamplingTensors.pack_batch(params), "cpu")
    jst = jsamp.SamplingTensors.unpack(*map(jnp.asarray,
                                            jsamp.SamplingTensors.pack_batch(
        [JaxSampling(presence_penalty=float(p), frequency_penalty=float(f))
         for p, f in zip(pres, freq)])))
    np.testing.assert_allclose(
        tsamp.apply_penalties(torch.from_numpy(logits),
                              torch.from_numpy(counts), st).numpy(),
        np.asarray(jsamp.apply_penalties(jnp.asarray(logits),
                                         jnp.asarray(counts), jst)),
        atol=1e-6, rtol=0)
    tokens = rng.integers(0, V, size=B)
    active = np.array([True, False, True, True, False])
    got = tsamp.update_counts(torch.from_numpy(counts.copy()),
                              torch.from_numpy(tokens),
                              torch.from_numpy(active)).numpy()
    want = np.asarray(jsamp.update_counts(jnp.asarray(counts),
                                          jnp.asarray(tokens, jnp.int32),
                                          jnp.asarray(active)))
    np.testing.assert_array_equal(got, want)
    assert (got[~active] == counts[~active]).all()


def test_bias_matches_jax():
    """``batch_bias`` equals the JAX engine's ``_batch_bias`` (width 8,
    the next power of two past it, ids past the vocabulary dropped) and
    its scatter-add the JAX sampler's."""
    V = 50
    params = [{}, {3: 2.0, 49: -100.0, 60: 5.0},
              {i: float(i) / 10 for i in range(12)}]
    tp = [SamplingParams(logit_bias=b or None) for b in params]
    jp = [JaxSampling(logit_bias=b or None) for b in params]
    ids, vals = tsamp.batch_bias(tp, 4, V)
    jids, jvals = JaxEngine._batch_bias(jp, 4, V)
    assert ids.shape == (4, 16)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(vals, np.asarray(jvals))
    assert tsamp.batch_bias(tp[:2], 2, V)[0].shape == (2, 8)
    logits = np.random.default_rng(0).normal(size=(4, V)).astype(np.float32)
    got = tsamp.apply_bias(torch.from_numpy(logits), torch.from_numpy(ids),
                           torch.from_numpy(vals)).numpy()
    want = jnp.asarray(logits).at[jnp.arange(4)[:, None], jids].add(jvals)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 5])
def test_top_logprobs_match_jax(k):
    rng = np.random.default_rng(k)
    logits = (rng.normal(size=(6, 200)) * 2).astype(np.float32)
    ids, lps = tsamp.compute_top_logprobs(torch.from_numpy(logits), k)
    jids, jlps = jsamp.compute_top_logprobs(jnp.asarray(logits), k)
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=1e-6,
                               rtol=0)
    ids, jids, jlps = ids.numpy(), np.asarray(jids), np.asarray(jlps)
    for r in range(6):
        for j in range(k):
            if ids[r, j] != jids[r, j]:
                # A tie: both ids carry (nearly) the same logprob.
                assert abs(jlps[r, j] - lps[r, j].item()) < 1e-6
    # Sorted, best first, the chosen greedy token at the head.
    assert (np.diff(lps.numpy(), axis=1) <= 0).all()
    assert (ids[:, 0] == logits.argmax(-1)).all()


def test_packed_pair_and_seed_range_match_jax():
    params = [dict(temperature=0.5, top_p=0.9, top_k=4, seed=3,
                   presence_penalty=0.1, frequency_penalty=0.2),
              dict(temperature=0.0), dict(seed=-5), dict(seed=2 ** 31 - 1)]
    f32, i32 = tsamp.SamplingTensors.pack_batch(
        [SamplingParams(**p) for p in params])
    jf32, ji32 = jsamp.SamplingTensors.pack_batch(
        [JaxSampling(**p) for p in params])
    np.testing.assert_array_equal(f32, jf32)
    np.testing.assert_array_equal(i32, ji32)
    assert f32.dtype == np.float32 and i32.dtype == np.int32
    # A negative seed is unseeded on both (JAX: ``seed >= 0``).
    assert tsamp.batch_mode([SamplingParams(temperature=1.0, seed=-5)]) == \
        (False, False)
    assert i32[2, 1] < 0
    for bad in (2 ** 31, -2 ** 31 - 1, 2 ** 40):
        with pytest.raises(OverflowError):
            tsamp.SamplingTensors.pack_batch([SamplingParams(seed=bad)])
        with pytest.raises(OverflowError):
            jsamp.SamplingTensors.pack_batch([JaxSampling(seed=bad)])


# ---------------------------------------------------------------------------
# Prompt logprobs
# ---------------------------------------------------------------------------

def _models(kind):
    if kind == "mla":
        jcfg, tcfg = JaxModelConfig(**MLA), ModelConfig(**MLA)
    else:
        kw = dict(dtype="float32")
        if kind == "softcap":
            kw["final_logit_softcapping"] = 5.0
        jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128), **kw)
        tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128), **kw)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("wta", [False, True], ids=["atw", "wta"])
@pytest.mark.parametrize("kind", ["dense", "softcap", "mla"])
def test_prompt_logprobs_match_jax(kind, wta):
    """Two rows of a 16-token window at starts 0 and 5: each window
    position's score of the next prompt token, within 1e-4 of the JAX
    forward's (chunked over T alike)."""
    jcfg, tcfg, jparams, tparams = _models(kind)
    rng = np.random.default_rng(4)
    B, T, ps, MP = 2, 16, 4, 8
    tokens = rng.integers(3, tcfg.vocab_size, size=(B, T)).astype(np.int32)
    start = np.array([0, 5], np.int32)
    lengths = np.array([16, 11], np.int32)
    targets = rng.integers(0, tcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = (1 + np.arange(B * MP).reshape(B, MP)).astype(np.int32)
    jkv = jtf.init_kv_cache(jcfg, 1 + B * MP, ps)
    tkv = ttf.init_kv_cache(tcfg, 1 + B * MP, ps, "cpu")
    jout = jtf.forward_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(lengths), jkv, jnp.asarray(table),
        prompt_lp_targets=jnp.asarray(targets), write_then_attend=wta)
    tout = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(start), torch.from_numpy(lengths), tkv,
        torch.from_numpy(table), write_then_attend=wta,
        prompt_lp_targets=torch.from_numpy(targets))
    assert len(tout) == 3
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-4, rtol=1e-4)
    plp = tout[2].numpy()
    for b in range(B):
        n = lengths[b]
        np.testing.assert_allclose(plp[b, :n], np.asarray(jout[3])[b, :n],
                                   atol=1e-4, rtol=0)
    assert (plp[:, :11] <= 0).all()


def test_prompt_logprobs_chunk_over_t():
    """A window longer than the chunk (T = 384 = 3 x 128) scores the
    same as one whole [B, T, V] block."""
    _, tcfg, _, tparams = _models("dense")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 384, tcfg.hidden_size), generator=g)
    head = ttf._head(tparams)
    targets = torch.randint(0, tcfg.vocab_size, (2, 384), generator=g)
    got = ttf._prompt_logprobs(x, head, targets)
    logp = torch.log_softmax((x @ head).float(), dim=-1)
    want = torch.gather(logp, 2, targets[..., None])[..., 0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The OpenAI parser and its cross-field rules
# ---------------------------------------------------------------------------

PARSED = [
    ({"n": 3, "best_of": 5, "echo": True, "logprobs": 4, "seed": 7,
      "logit_bias": {"12": -100, "7": 2.5}, "presence_penalty": 0.5,
      "frequency_penalty": 0.25, "top_p": 0.9, "top_k": 4,
      "temperature": 0.7, "stop": "END", "max_tokens": 9}, False),
    ({"n": 2, "best_of": 4, "echo": True, "logprobs": True,
      "top_logprobs": 3, "seed": 2 ** 40,
      "max_completion_tokens": 5}, True),
    ({"logprobs": 0, "logit_bias": {}}, False),
    ({}, True),
]


@pytest.mark.parametrize("i", range(len(PARSED)))
def test_openai_parser_equals_jax(i):
    """``parse_openai_sampling`` (every option of the sampling surface:
    chat and completion field quirks) gives the JAX package's params."""
    from xllm_service_tpu.utils import types as jtypes
    from xllm_service_tpu_torch.utils import types as ttypes
    body, is_chat = PARSED[i]
    got = ttypes.parse_openai_sampling(body, is_chat)
    want = jtypes.parse_openai_sampling(body, is_chat)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


VALIDATED = [(dict(n=0), False), (dict(n=2, best_of=1), False),
             (dict(n=1, best_of=3), True), (dict(n=1, best_of=3), False),
             (dict(n=2, best_of=2), True), (dict(n=3), True)]


@pytest.mark.parametrize("i", range(len(VALIDATED)))
def test_validate_sampling_equals_jax(i):
    from xllm_service_tpu.utils import types as jtypes
    from xllm_service_tpu_torch.utils import types as ttypes
    kw, stream = VALIDATED[i]
    errors = []
    for mod, cls in ((ttypes, SamplingParams), (jtypes, JaxSampling)):
        try:
            mod.validate_sampling(cls(**kw), stream)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("bias", [{"1": 101}, {"-1": 5}, {"x": 1},
                                  {str(i): 1 for i in range(301)}, [1]])
def test_bad_logit_bias_refused_as_jax(bias):
    from xllm_service_tpu.utils import types as jtypes
    from xllm_service_tpu_torch.utils import types as ttypes
    msgs = []
    for mod in (ttypes, jtypes):
        with pytest.raises(ValueError) as e:
            mod.parse_openai_sampling({"logit_bias": bias}, False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
