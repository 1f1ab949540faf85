"""The port's Engine against the JAX package's Engine, on the CPU with a
tiny float32 model and the same weights, at temperature 0: the token
streams must be identical (greedy sampling of logits that agree to
~1e-6 picks the same token)."""

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
from xllm_service_tpu_torch.utils.types import FinishReason, SamplingParams
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ENGINE_KW = dict(page_size=8, num_pages=96, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=48,
                 prefill_buckets=(16, 32))
# Prompt lengths: one longer than the largest bucket (chunked prefill),
# more requests than decode slots (admission waits for a free slot).
PROMPT_LENS = (5, 70, 17, 32, 9)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    jax_engine = JaxEngine(jcfg, JaxEngineConfig(
        **ENGINE_KW, enable_prefix_cache=False))
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_engine.params), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 128, size=n).tolist() for n in PROMPT_LENS]
    return jax_engine, tcfg, params, prompts


def _drain(engine, requests):
    for r in requests:
        engine.add_request(r)
    streams, finish = {}, {}
    for _ in range(500):
        if not engine.has_work():
            break
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.finished:
                finish[o.request_id] = o.finish_reason.value
    assert not engine.has_work()
    return streams, finish


def _run_both(setup, max_tokens, eos):
    jax_engine, tcfg, params, prompts = setup
    jreqs = [JaxRequest(f"r{i}", p, JaxSampling(max_tokens=max_tokens[i],
                                                temperature=0.0),
                        eos_token_ids=eos.get(i, ()))
             for i, p in enumerate(prompts)]
    treqs = [EngineRequest(f"r{i}", p, SamplingParams(
        max_tokens=max_tokens[i], temperature=0.0),
        eos_token_ids=eos.get(i, ())) for i, p in enumerate(prompts)]
    port = Engine(tcfg, EngineConfig(**ENGINE_KW, enable_prefix_cache=False),
                  params=params, device="cpu")
    return _drain(jax_engine, jreqs), _drain(port, treqs)


def test_greedy_streams_identical(setup):
    max_tokens = (12, 9, 14, 6, 11)
    (jst, jfin), (tst, tfin) = _run_both(setup, max_tokens, {})
    assert tst == jst
    assert tfin == jfin
    assert all(len(tst[f"r{i}"]) == n for i, n in enumerate(max_tokens))


def test_eos_and_max_tokens_stops(setup):
    # EOS = the 4th greedy token of r1 and the 2nd of r3 (found by a
    # free run), so those stop early on STOP; the rest stop on LENGTH.
    (jst, _), _ = _run_both(setup, (10,) * 5, {})
    eos = {1: (jst["r1"][3],), 3: (jst["r3"][1],)}
    (jst, jfin), (tst, tfin) = _run_both(setup, (10,) * 5, eos)
    assert tst == jst and tfin == jfin
    assert tfin["r1"] == tfin["r3"] == FinishReason.STOP.value
    assert tfin["r0"] == FinishReason.LENGTH.value
    assert tst["r1"][-1] == eos[1][0] and len(tst["r1"]) <= 4


def test_pages_and_slots_freed(setup):
    _, tcfg, params, prompts = setup
    port = Engine(tcfg, EngineConfig(**ENGINE_KW), params=params,
                  device="cpu")
    free0 = port.allocator.num_free
    reqs = [EngineRequest(f"r{i}", p, SamplingParams(max_tokens=4,
                                                     temperature=0.0))
            for i, p in enumerate(prompts)]
    _drain(port, reqs[:3])
    port.add_request(reqs[3])
    port.step()
    port.cancel("r3")
    outs = port.step()
    assert any(o.request_id == "r3" and
               o.finish_reason == FinishReason.CANCELLED for o in outs)
    # Every page is back: free, or (prefix cache on) reclaimable.
    assert port.allocator.num_free + port.prefix_cache.num_reclaimable \
        == free0
    assert all(s is None for s in port._slots)
    with pytest.raises(ValueError):
        port.add_request(EngineRequest("long", [3] * 128))
