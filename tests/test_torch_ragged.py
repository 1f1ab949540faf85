"""The port's interleaver and one-launch ragged mixed step against the JAX
package's Engine, on the CPU with a tiny float32 model and the same
weights, at temperature 0.

Both engines get a page pool large enough that admission never waits
for pages (both take a window's pages at a time and grow the table as
the sequence grows; tests/test_torch_admission.py holds them under page
pressure), and the JAX engine single-step decode and no prefix cache,
as the port has. Time is counted in engine steps.
Pinned: the token streams are identical, and so is the per-step ledger
(kind, ragged, prefill windows, decode tokens, attention dispatches)."""

import dataclasses

import numpy as np
import jax
import pytest

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

VOCAB = 128
ENGINE_KW = dict(page_size=8, num_pages=160, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(8, 16, 32))

# Workloads: {step: [(prompt length, max_tokens), ...]} added before that
# step runs.
STAGGERED = {1: [(8, 12)], 3: [(11, 10)]}
# More prompts than slots, one longer than the largest bucket (chunked).
CROWDED = {1: [(9, 14), (5, 6)], 2: [(70, 8), (17, 9)], 4: [(32, 7), (12, 5)]}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    jparams = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW)).params
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _feed(workload, seed=0):
    rng = np.random.default_rng(seed)
    feed, i = {}, 0
    for step, reqs in sorted(workload.items()):
        for n, max_tokens in reqs:
            feed.setdefault(step, []).append(
                (f"r{i}", rng.integers(3, VOCAB, size=n).tolist(),
                 max_tokens))
            i += 1
    return feed


def _drive(engine, feed, request, sampling):
    """Run to idle; returns (streams by request id, per-step ledger)."""
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
        assert step < 400, "engine did not drain"
    return streams, ledger


def _port(weights, **kw):
    _, tcfg, _, tparams = weights
    engine = Engine(tcfg, EngineConfig(
        **{**ENGINE_KW, "enable_prefix_cache": False, **kw}),
        params=tparams, device="cpu")
    return engine


# The port's runs by (weights, workload, options): the tests that drive
# the same configuration share one run.
_PORT_RUNS = {}


def _run_port(weights, workload, **kw):
    key = (id(weights), repr(sorted(workload.items())), repr(sorted(
        kw.items())))
    if key not in _PORT_RUNS:
        _PORT_RUNS[key] = _drive(_port(weights, **kw), _feed(workload),
                                 EngineRequest, SamplingParams)
    return _PORT_RUNS[key]


def _run_jax(weights, workload, **kw):
    jcfg, _, jparams, _ = weights
    engine = JaxEngine(jcfg, JaxEngineConfig(
        **{**ENGINE_KW, **kw}, decode_steps=1, enable_prefix_cache=False),
        params=jparams)
    return _drive(engine, _feed(workload), JaxRequest, JaxSampling)


@pytest.mark.parametrize("workload", [STAGGERED, CROWDED],
                         ids=["staggered", "crowded"])
def test_ragged_streams_and_ledger_match_jax(weights, workload):
    jst, jled = _run_jax(weights, workload, ragged_attn=True)
    tst, tled = _run_port(weights, workload, ragged_attn=True)
    assert tst == jst
    assert tled == jled
    assert any(r for _, r, *_ in tled), "no ragged iteration ran"
    n = sum(len(v) for v in _feed(workload).values())
    assert len(tst) == n


@pytest.mark.parametrize("workload", [STAGGERED, CROWDED],
                         ids=["staggered", "crowded"])
def test_ragged_on_off_streams_identical(weights, workload):
    on, led_on = _run_port(weights, workload, ragged_attn=True)
    off, led_off = _run_port(weights, workload, ragged_attn=False)
    assert on == off
    for kind, ragged, _, _, dispatches in led_on:
        # A ragged iteration is one mixed forward; decode-only and
        # prefill-only iterations never go ragged.
        if ragged:
            assert kind == "mixed" and dispatches == 1
        if kind in ("decode", "prefill"):
            assert not ragged
    mixed_off = [d for kind, r, _, _, d in led_off if kind == "mixed"]
    assert mixed_off and min(mixed_off) >= 2
    assert not any(r for _, r, *_ in led_off)


def test_ragged_steps_counted(weights):
    engine = _port(weights, ragged_attn=True)
    _drive(engine, _feed(STAGGERED), EngineRequest, SamplingParams)
    assert engine.ragged and engine.ragged_steps >= 1
    assert not _port(weights).ragged            # off by default


def test_prefill_first_matches_jax(weights):
    jst, jled = _run_jax(weights, CROWDED, interleave=False)
    tst, tled = _run_port(weights, CROWDED, interleave=False)
    assert tst == jst
    assert tled == jled
    assert "mixed" not in {x[0] for x in tled}


@pytest.mark.parametrize("deadline_ms", [0.0, 1e9], ids=["floor", "starve"])
@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_budget_used_up_by_decode_matches_jax(weights, deadline_ms, ragged):
    """Four decoders use up half of an 8-token budget, so no 8-token
    window fits the residual. With the deadline at 0 the starvation floor
    (one smallest bucket) applies on every step and the waiting prompts
    prefill beside the decode rows in windows of at most 8 tokens; with
    it out of reach they wait until decoders finish."""
    workload = {1: [(6, 10), (7, 12), (5, 9), (8, 11)],
                3: [(20, 4), (9, 5)]}
    kw = dict(step_token_budget=8, prefill_deadline_ms=deadline_ms,
              ragged_attn=ragged)
    jst, jled = _run_jax(weights, workload, **kw)
    tst, tled = _run_port(weights, workload, **kw)
    assert tst == jst
    assert tled == jled
    mixed = [w for kind, _, w, _, _ in tled if kind == "mixed"]
    if deadline_ms == 0.0:
        # Prefill goes on beside decode, one floor quantum at a time.
        assert mixed and all(sum(w) <= 8 for w in mixed)
    else:
        assert not mixed


def test_skip_ahead_admits_small_prompt_behind_page_starved_one(weights):
    """A prompt whose pages do not fit does not hold back a smaller one
    behind it; it keeps its place and admits once pages free up."""
    _, tcfg, _, tparams = weights
    # The prompts share their leading tokens: with the prefix cache the
    # giant would hit the blocker's pages, so it is off here.
    engine = Engine(tcfg, EngineConfig(
        page_size=4, num_pages=16, max_model_len=64, max_batch_size=4,
        max_prefill_tokens=64, prefill_buckets=(8, 16, 32, 64),
        enable_prefix_cache=False),
        params=tparams, device="cpu")

    def req(rid, n, max_tokens):
        return EngineRequest(rid, list(range(3, 3 + n)), SamplingParams(
            max_tokens=max_tokens, temperature=0.0, ignore_eos=True))
    # The blocker holds 10 of the 15 pages after its prefill (36 tokens
    # and the one it sampled); the giant needs 11, the small prompt 3.
    engine.add_request(req("blocker", 36, 12))
    engine.step()
    engine.add_request(req("giant", 40, 2))
    engine.add_request(req("small", 8, 2))
    outs = engine.step()
    assert "small" in {o.request_id for o in outs if o.new_token_ids}
    assert [s.req.request_id for s in engine.waiting] == ["giant"]
    streams, _ = _drive(engine, {1: []}, EngineRequest, SamplingParams)
    assert len(streams["giant"]) == 2

def test_env_and_default_resolution(monkeypatch):
    for name in ("XLLM_RAGGED_ATTN", "XLLM_INTERLEAVE",
                 "XLLM_STEP_TOKEN_BUDGET", "XLLM_PREFILL_DEADLINE_MS"):
        monkeypatch.delenv(name, raising=False)
    cfg = EngineConfig(**ENGINE_KW)
    assert cfg.ragged_attn is None and cfg.interleave is None
    assert cfg.step_token_budget == 0 and cfg.prefill_deadline_ms == 500.0
    monkeypatch.setenv("XLLM_RAGGED_ATTN", "1")
    assert EngineConfig(**ENGINE_KW).ragged_attn is True
    monkeypatch.setenv("XLLM_RAGGED_ATTN", "0")
    assert EngineConfig(**ENGINE_KW, ragged_attn=True).ragged_attn is False
    monkeypatch.setenv("XLLM_INTERLEAVE", "0")
    assert EngineConfig(**ENGINE_KW).interleave is False
    monkeypatch.setenv("XLLM_STEP_TOKEN_BUDGET", "16")
    monkeypatch.setenv("XLLM_PREFILL_DEADLINE_MS", "125")
    cfg = EngineConfig(**ENGINE_KW)
    assert cfg.step_token_budget == 16 and cfg.prefill_deadline_ms == 125.0
    for name in ("XLLM_RAGGED_ATTN", "XLLM_INTERLEAVE",
                 "XLLM_STEP_TOKEN_BUDGET", "XLLM_PREFILL_DEADLINE_MS"):
        monkeypatch.delenv(name)
    engine = Engine(ModelConfig.tiny(vocab_size=VOCAB),
                    EngineConfig(**ENGINE_KW), device="cpu")
    assert engine.interleave is True          # None = on
    assert engine.ragged is False             # None = off
    assert engine.step_token_budget == 32     # 0 = max_prefill_tokens
    assert engine.prefill_deadline_ms == 500.0
