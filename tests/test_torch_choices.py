"""The OpenAI sampling surface end to end on the CPU: the port's engine
and worker against the JAX package's, on the same tiny float32 weights.

Pinned here:

- engines: greedy requests with presence/frequency penalties, a
  ``logit_bias`` past the default width (a wider bias key), seeded
  sampled requests (top-p, top-k, penalties), top logprobs and a
  chunked prompt-scored request (echo with logprobs) served together,
  then a window beside unpenalized decoders (a penalized decoder keeps
  an iteration off the ragged step, as in the JAX engine):
  streams equal token for token, the chosen tokens' logprobs and the
  top entries within 1e-4 (ids equal but at ties), prompt logprobs
  within 1e-4 (the first None), and the step ledger equal, in the split
  step in both write orders, the ragged step, prefill-first routing and
  4-step bursts (pipelined); no capture after a warmup but the named
  late keys (the wider bias, the prompt-scored prefill);
- a tight pool that preempts penalized and seeded requests (the
  counts rebuilt from host truth after each readmission): streams and
  preemptions equal, single steps and bursts;
- workers: ``n``, ``best_of`` (non-streamed), ``echo`` with and without
  logprobs, ``top_logprobs``, ``logit_bias``, the penalties and seeds,
  chat and completion, streamed and not: OpenAI bodies equal (floats
  within 1e-4); the 400s that stay (streaming with ``best_of > n``, a
  ``logit_bias`` id past the vocabulary).
"""

import dataclasses
import json

import numpy as np
import jax
import pytest

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_decode_graph import TIGHT
from tests.test_torch_worker import _post, _sse

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

TOL = 1e-4
V = 128
ENGINE = dict(page_size=4, num_pages=96, max_model_len=128,
              max_batch_size=4, max_prefill_tokens=32,
              prefill_buckets=(8, 16, 32), num_top_logprobs=3)
MODES = {
    "split_wta": dict(write_then_attend=True),
    "split_atw": dict(write_then_attend=False),
    "ragged": dict(ragged_attn=True, write_then_attend=True),
    "prefill_first": dict(interleave=False),
    "burst4": dict(decode_steps=4),
}
BAN = 17
# (arrival step, id, prompt length, sampling, prompt-scored).
PLAN = [
    (1, "pen", 9, dict(temperature=0.0, presence_penalty=0.6,
                       frequency_penalty=0.8, max_tokens=14,
                       logprobs=True), False),
    (1, "seed", 13, dict(temperature=0.8, top_p=0.9, seed=11,
                         max_tokens=30, logprobs=True), False),
    (2, "bias", 6, dict(temperature=0.0, max_tokens=9,
                        logit_bias={**{BAN: -100.0},
                                    **{t: 0.5 for t in range(20, 32)}}),
     False),
    (3, "echo", 40, dict(temperature=0.0, max_tokens=6, logprobs=True),
     True),
    (4, "seedpen", 7, dict(temperature=1.2, top_k=5, seed=3,
                           presence_penalty=0.3, frequency_penalty=0.2,
                           max_tokens=10, logprobs=True), False),
    # After the penalized requests finished: a window beside unpenalized
    # decoders (the ragged step takes it).
    (24, "late", 10, dict(temperature=0.9, top_k=8, seed=77, max_tokens=6,
                          logprobs=True, logit_bias={BAN: -100.0}), False),
]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=V),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=V),
                               dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _drive(engine, plan, request, sampling):
    """Run ``plan`` to idle: per request its tokens, logprobs, top
    entries and prompt logprobs, and the per-step ledger."""
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(3, V, size=n).tolist()
               for _, rid, n, _, _ in plan}
    got = {rid: {"tokens": [], "lps": [], "tops": [], "plp": None}
           for _, rid, *_ in plan}
    ledger, step = [], 0
    while engine.has_work() or step < max(p[0] for p in plan):
        step += 1
        for at, rid, _, sp, scored in plan:
            if at == step:
                engine.add_request(request(
                    rid, prompts[rid], sampling(ignore_eos=True, **sp),
                    prompt_logprobs=scored))
        for o in engine.step():
            r = got[o.request_id]
            r["tokens"] += o.new_token_ids
            r["lps"] += o.logprobs
            r["tops"] += o.top_logprobs or []
            if o.prompt_logprobs is not None:
                r["plp"] = o.prompt_logprobs
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
        assert step < 300, "engine did not drain"
    return got, ledger


def _engines(weights, kw):
    jcfg, tcfg, jparams, tparams = weights
    kw = {**kw, "enable_prefix_cache": False}
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams)
    teng = Engine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    return jeng, teng


def _same_tops(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert abs(g["logprob"] - w["logprob"]) < TOL
            if g["token_id"] != w["token_id"]:        # a tie
                assert abs(g["logprob"] - w["logprob"]) < 1e-6


def _same(got, want):
    assert got.keys() == want.keys()
    for rid in want:
        g, w = got[rid], want[rid]
        assert g["tokens"] == w["tokens"], rid
        np.testing.assert_allclose(g["lps"], w["lps"], atol=TOL, rtol=0)
        _same_tops(g["tops"], w["tops"])
        if w["plp"] is None:
            assert g["plp"] is None
        else:
            assert g["plp"][0] is None and w["plp"][0] is None
            np.testing.assert_allclose(g["plp"][1:], w["plp"][1:],
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_sampling_surface_matches_jax(weights, mode):
    jeng, teng = _engines(weights, {**ENGINE, **MODES[mode]})
    teng.warmup()
    want, jled = _drive(jeng, PLAN, JaxRequest, JaxSampling)
    got, tled = _drive(teng, PLAN, EngineRequest, SamplingParams)
    _same(got, want)
    assert tled == jled
    assert BAN not in got["bias"]["tokens"]
    assert len(got["echo"]["plp"]) == 40
    assert all(len(t) == 3 for t in got["seed"]["tops"])
    # Only the named late keys were captured after warmup: the wider
    # bias and the prompt-scored prefill.
    rep = teng.capture_report()
    late = [n for p in ("prefill", "ragged", "decode", "decode_multi")
            for n in rep[p]["late"]]
    assert late and all("_bias16" in n or n.endswith("_echo")
                        for n in late), late
    assert any(n.endswith("_echo") for n in rep["prefill"]["late"])
    assert set(rep["eager_steps"]) == {"cpu"}
    assert (teng.ragged_steps > 0) == (mode == "ragged")


TIGHT_PLAN = [
    (1, "a", 9, dict(temperature=0.0, presence_penalty=0.5,
                     frequency_penalty=0.5, max_tokens=14), False),
    (1, "b", 14, dict(temperature=0.9, seed=5, frequency_penalty=1.0,
                      max_tokens=10), False),
    (2, "c", 6, dict(temperature=0.0, frequency_penalty=2.0,
                     max_tokens=16), False),
    (4, "d", 12, dict(temperature=1.0, top_p=0.8, seed=9,
                      presence_penalty=1.0, max_tokens=12), False),
]


@pytest.mark.parametrize("steps", [1, 4])
def test_tight_pool_rebuilds_the_counts_as_jax(weights, steps):
    """Preemption by recompute of penalized requests: each readmission
    prefills again and the next decode rebuilds the counts from the
    host's tokens, as the JAX engine does."""
    jeng, teng = _engines(weights, dict(TIGHT, decode_steps=steps))
    want, jled = _drive(jeng, TIGHT_PLAN, JaxRequest, JaxSampling)
    got, tled = _drive(teng, TIGHT_PLAN, EngineRequest, SamplingParams)
    _same(got, want)
    assert tled == jled
    assert teng.num_preemptions == jeng.num_preemptions > 0


def test_seed_outside_int32_fails_the_step_on_both(weights):
    """A seed that does not fit the packed int32 column raises
    OverflowError in the step that packs it, on both engines."""
    jeng, teng = _engines(weights, ENGINE)
    for eng, req, sp in ((jeng, JaxRequest, JaxSampling),
                         (teng, EngineRequest, SamplingParams)):
        eng.add_request(req("x", [5, 6, 7], sp(temperature=1.0,
                                                 seed=2 ** 31)))
        with pytest.raises(OverflowError):
            eng.step()


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------

WORKER_ENGINE = dict(page_size=16, num_pages=128, max_model_len=256,
                     max_batch_size=8, max_prefill_tokens=64,
                     prefill_buckets=(16, 32, 64), num_top_logprobs=4)


@pytest.fixture(scope="module")
def workers():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny", lambda: jcfg)
    jw = jax_worker.Worker(jax_worker.WorkerOptions(model="tiny"),
                           InMemoryStore(),
                           engine_cfg=JaxEngineConfig(**WORKER_ENGINE)
                           ).start()
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jtf.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, "cpu")
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        EngineConfig(**WORKER_ENGINE), model_cfg=tcfg, params=params).start()
    try:
        yield jw.name, tw.name
    finally:
        tw.stop()
        jw.stop()
        mp.undo()


def _close(got, want, path="body"):
    """Equal JSON, floats within TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) < TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _strip(obj):
    obj = dict(obj)
    obj.pop("id", None)
    obj.pop("created", None)
    return obj


CMPL, CHAT = "/v1/completions", "/v1/chat/completions"
BODIES = {
    "n3": (CMPL, {"prompt": "three choices", "n": 3, "max_tokens": 7,
                  "temperature": 0.9, "seed": 21}),
    "n3_greedy_penalized": (CMPL, {
        "prompt": "penalties", "n": 3, "max_tokens": 8,
        "temperature": 0.0, "presence_penalty": 0.7,
        "frequency_penalty": 0.4, "logprobs": 2}),
    "best_of4_n2": (CMPL, {"prompt": "best of four", "best_of": 4, "n": 2,
                           "max_tokens": 6, "temperature": 1.0,
                           "seed": 8}),
    "echo": (CMPL, {"prompt": "echo this", "echo": True, "max_tokens": 5,
                    "temperature": 0.0}),
    "echo_logprobs": (CMPL, {"prompt": "echo, scored", "echo": True,
                             "logprobs": 3, "max_tokens": 5,
                             "temperature": 0.0}),
    "echo_logprobs_n2": (CMPL, {"prompt": "two echoes", "echo": True,
                                "logprobs": 1, "n": 2, "max_tokens": 4,
                                "temperature": 0.8, "seed": 4}),
    "top_logprobs_chat": (CHAT, {
        "messages": [{"role": "user", "content": "top entries"}],
        "logprobs": True, "top_logprobs": 3, "max_tokens": 6,
        "temperature": 0.7, "top_p": 0.9, "seed": 13}),
    "logit_bias_chat": (CHAT, {
        "messages": [{"role": "user", "content": "biased"}],
        "logit_bias": {"101": 100, "5": -100}, "max_tokens": 5,
        "temperature": 0.0, "logprobs": True, "top_logprobs": 2}),
    "n2_stop": (CMPL, {"prompt": "stop strings", "n": 2, "max_tokens": 24,
                       "temperature": 1.0, "seed": 2, "stop": ["e", "a"]}),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_body_matches_jax_worker(workers, name):
    path, body = BODIES[name]
    jax_addr, torch_addr = workers
    js, jbody = _post(jax_addr, path, body)
    ts, tbody = _post(torch_addr, path, body)
    assert js == ts == 200, (jbody, tbody)
    want, got = _strip(json.loads(jbody)), _strip(json.loads(tbody))
    _close(got, want)
    n = body.get("n", 1)
    assert [c["index"] for c in got["choices"]] == list(range(n))
    if body.get("echo"):
        prompt = body["prompt"]
        assert all(c["text"].startswith(prompt) for c in got["choices"])


STREAMED = ["n3", "echo_logprobs_n2", "top_logprobs_chat", "n2_stop"]


@pytest.mark.parametrize("name", STREAMED)
def test_stream_matches_jax_worker(workers, name):
    path, body = BODIES[name]
    body = {**body, "stream": True,
            "stream_options": {"include_usage": True}}
    jax_addr, torch_addr = workers
    js, jbody = _post(jax_addr, path, body)
    ts, tbody = _post(torch_addr, path, body)
    assert js == ts == 200
    _close([_strip(f) for f in _sse(tbody)], [_strip(f) for f in _sse(jbody)])


REFUSED = {
    "stream_best_of": (CMPL, {"prompt": "x", "best_of": 3, "n": 1,
                              "stream": True}),
    "bias_past_vocab": (CMPL, {"prompt": "x", "logit_bias": {"600": 5}}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_jax_worker(workers, name):
    path, body = REFUSED[name]
    jax_addr, torch_addr = workers
    js, jbody = _post(jax_addr, path, body)
    ts, tbody = _post(torch_addr, path, body)
    assert js == ts == 400, (jbody, tbody)
    assert json.loads(tbody)["error"]["message"] == \
        json.loads(jbody)["error"]["message"]
