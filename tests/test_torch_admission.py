"""The port's page lifecycle against the JAX package's Engine, on the CPU
with a tiny float32 model and the same weights, at temperature 0.

Admission takes the pages of a sequence's first prefill window only,
later windows and every decode grow the page table, and a sequence that
finds the pool short preempts itself by recompute (the JAX engine under
online traffic; it runs here with single-step decode and no prefix
cache, as the port has). Pinned: a request whose prompt fits but whose
prompt + ``max_tokens`` would not is served, with the JAX engine's
tokens, also through the worker; on a pool too small for the running
set the token streams, the per-step ledger and the preemption count
equal the JAX engine's, in the split, ragged and prefill-first steps, and
so does the heartbeat's ``load_metrics()`` after every step; a prompt
that can never fit is refused with the JAX engine's message."""

import dataclasses
import json
from http.client import HTTPConnection

import numpy as np
import jax
import pytest

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import FinishReason, SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

VOCAB = 128
# 16 usable pages of 4 tokens: 64 token positions for up to 4 sequences
# that each grow to 22-24 tokens, so decode growth runs the pool dry.
TIGHT = dict(page_size=4, num_pages=17, max_model_len=128,
             max_batch_size=4, max_prefill_tokens=32,
             prefill_buckets=(8, 16, 32))
# {step: [(prompt length, max_tokens), ...]} added before that step.
PRESSURE = {1: [(9, 14), (14, 10)], 2: [(6, 16)], 4: [(12, 12)]}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB),
                               dtype="float32")
    jparams = JaxEngine(jcfg, JaxEngineConfig(**TIGHT)).params
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _jax(weights, **kw):
    jcfg, _, jparams, _ = weights
    return JaxEngine(jcfg, JaxEngineConfig(
        **{**TIGHT, **kw}, decode_steps=1, enable_prefix_cache=False),
        params=jparams)


def _port(weights, **kw):
    _, tcfg, _, tparams = weights
    return Engine(tcfg, EngineConfig(
        **{**TIGHT, "enable_prefix_cache": False, **kw}), params=tparams,
        device="cpu")


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


def _drive(engine, feed, request, sampling, eos=(), loads=None):
    """Run to idle; returns (streams, finish reasons, per-step ledger).
    ``loads``, a list, takes ``engine.load_metrics()`` after each step."""
    streams, finish, ledger, step = {}, {}, [], 0
    while engine.has_work() or step < max(feed):
        step += 1
        for rid, toks, max_tokens in feed.get(step, []):
            engine.add_request(request(
                rid, toks, sampling(max_tokens=max_tokens, temperature=0.0),
                eos_token_ids=tuple(eos)))
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.finished:
                finish[o.request_id] = o.finish_reason.value
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
        if loads is not None:
            loads.append(engine.load_metrics())
        assert step < 400, "engine did not drain"
    return streams, finish, ledger


def _first_new_token(stream, start):
    """Index and id of the first token at or after ``start`` that did not
    come before it, so that an EOS of that id stops the stream there."""
    for i in range(start, len(stream)):
        if stream[i] not in stream[:i]:
            return i, stream[i]
    raise AssertionError(f"no fresh token in {stream}")


MODES = {"split": dict(), "ragged": dict(ragged_attn=True),
         "prefill_first": dict(interleave=False)}


@pytest.fixture(scope="module")
def pressure_runs(weights):
    """One run of ``PRESSURE`` per mode on each engine, shared by the
    tests of its mode: {mode: ((JAX engine, streams, finish, ledger,
    loads), (port engine, ...))}, each mode run at its first use."""
    runs = {}

    def run(mode):
        if mode not in runs:
            pair = []
            for engine, request, sampling in (
                    (_jax(weights, **MODES[mode]), JaxRequest,
                     JaxSampling),
                    (_port(weights, **MODES[mode]), EngineRequest,
                     SamplingParams)):
                loads = []
                pair.append((engine, *_drive(engine, _feed(PRESSURE),
                                             request, sampling,
                                             loads=loads), loads))
            runs[mode] = tuple(pair)
        return runs[mode]
    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_preemption_under_a_tight_pool_matches_jax(pressure_runs, mode):
    (jax_engine, jst, jfin, jled, _), (port, tst, tfin, tled, _) = \
        pressure_runs(mode)
    assert tst == jst and tfin == jfin
    assert tled == jled
    assert port.num_preemptions == jax_engine.num_preemptions > 0
    assert all(len(tst[rid]) == n for rid, _, n in
               sum(_feed(PRESSURE).values(), []))
    if mode == "ragged":
        assert any(r for _, r, *_ in tled), "no ragged iteration ran"
    assert port.allocator.num_free == TIGHT["num_pages"] - 1
    assert all(s is None for s in port._slots)


@pytest.mark.parametrize("mode", list(MODES))
def test_load_metrics_match_jax_at_every_step(pressure_runs, mode):
    """The heartbeat's load (queue depths, the prefill backlog, KV usage,
    preemptions) equals the JAX engine's after every step under
    pressure; the JAX engine has no prefix cache here, so neither counts
    reclaimable pages."""
    (*_, jloads), (*_, tloads) = pressure_runs(mode)
    assert tloads == jloads
    assert max(x["kv_cache_usage"] for x in tloads) > 0.9
    assert max(x["waiting_prefill_tokens"] for x in tloads) > 0
    assert tloads[-1]["num_preemptions"] > 0


# F1 and F2: a uniform sliding window of 8 tokens (the engine releases
# the leading pages every later window masks) and a 4-expert MoE at
# capacity factor 0.5 (tokens dropped at expert capacity, counted).
VARIANTS = {"window": dict(sliding_window=8),
            "moe": dict(num_experts=4, moe_capacity_factor=0.5)}
# (variant, mode, decode steps, prefix cache)
VARIANT_RUNS = [(v, m, 1, False) for v in sorted(VARIANTS)
                for m in ("split", "ragged", "prefill_first")] + \
    [(v, "split", 4, True) for v in sorted(VARIANTS)]


@pytest.fixture(scope="module")
def variant_weights():
    out = {}
    for name, kw in VARIANTS.items():
        jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=VOCAB),
                                   dtype="float32", **kw)
        tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB),
                                   dtype="float32", **kw)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
        out[name] = (jcfg, tcfg, jparams, tparams)
    return out


@pytest.mark.parametrize(
    "variant,mode,steps,cache", VARIANT_RUNS,
    ids=[f"{v}-{m}-n{n}-{'cache' if c else 'nocache'}"
         for v, m, n, c in VARIANT_RUNS])
def test_load_metrics_match_jax_at_every_step_window_and_moe(
        variant_weights, variant, mode, steps, cache):
    """F1 and F2 pinned: with a sliding window the port trims pages as
    the JAX engine does (steps, preemptions and ``kv_cache_usage`` equal
    at every step), and an MoE model's ``moe_dropped_tokens`` equals the
    JAX engine's at every step, single steps and fused bursts alike."""
    jcfg, tcfg, jparams, tparams = variant_weights[variant]
    kw = {**TIGHT, **MODES[mode], "decode_steps": steps,
          "enable_prefix_cache": cache}
    runs = []
    for engine, request, sampling in (
            (JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams),
             JaxRequest, JaxSampling),
            (Engine(tcfg, EngineConfig(**kw), params=tparams, device="cpu"),
             EngineRequest, SamplingParams)):
        loads = []
        streams, finish, ledger = _drive(engine, _feed(PRESSURE), request,
                                         sampling, loads=loads)
        runs.append((streams, finish, ledger, loads,
                     engine.num_preemptions))
    assert runs[1] == runs[0]
    loads = runs[1][3]
    if variant == "moe":
        assert loads[-1]["moe_dropped_tokens"] > 0
    else:
        # Trimmed pages come back: the usage falls while streams run on.
        usage = [x["kv_cache_usage"] for x in loads]
        assert any(b < a for a, b in zip(usage, usage[1:])
                   if b > 0)


def test_decode_growth_takes_one_page_at_a_time(weights):
    port = _port(weights)
    prompt = list(range(3, 13))                     # 10 tokens
    port.add_request(EngineRequest("a", prompt, SamplingParams(
        max_tokens=40, temperature=0.0, ignore_eos=True)))
    port.step()                                     # the whole prompt
    seq = port.running[0]
    # The window and the token it sampled: 11 positions, 3 pages.
    assert len(seq.pages) == 3 and len(seq.tokens) == 11
    for _ in range(6):
        port.step()
        # Every position up to the next write, the last sampled token's.
        assert len(seq.pages) == -(-len(seq.tokens) // 4)
    assert port.num_preemptions == 0


# A pool of 8 usable pages (32 token positions) and a 10-token prompt
# asking for 60 new tokens: a whole reservation of 69 positions would
# not fit, but the stream stops on its EOS well inside the pool.
SMALL_POOL = dict(TIGHT, num_pages=9)


@pytest.fixture(scope="module")
def eos_case(weights):
    """The prompt, and an EOS id that first appears as the 9th-or-later
    greedy token of a free run on a large pool."""
    prompt = np.random.default_rng(7).integers(3, VOCAB, size=10).tolist()
    free = _port(weights, num_pages=64)
    free.add_request(EngineRequest("free", prompt, SamplingParams(
        max_tokens=20, temperature=0.0, ignore_eos=True)))
    stream = []
    while free.has_work():
        for o in free.step():
            stream.extend(o.new_token_ids)
    i, eos = _first_new_token(stream, 8)
    assert len(prompt) + i + 1 < 32                 # stops inside the pool
    return prompt, eos, stream[:i + 1]


def test_prompt_that_fits_with_max_tokens_that_would_not_is_served(
        weights, eos_case):
    prompt, eos, want = eos_case
    feed = {1: [("r0", prompt, 60)]}
    jst, jfin, jled = _drive(_jax(weights, **SMALL_POOL), feed, JaxRequest,
                             JaxSampling, eos=(eos,))
    port = _port(weights, **SMALL_POOL)
    tst, tfin, tled = _drive(port, feed, EngineRequest, SamplingParams,
                             eos=(eos,))
    assert tst == jst == {"r0": want}
    assert tfin == jfin == {"r0": FinishReason.STOP.value}
    assert tled == jled
    assert port.num_preemptions == 0


def _post(addr, path, obj):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode("utf-8", "replace"))
    finally:
        conn.close()


def test_worker_answers_200_where_it_answered_400(weights, eos_case):
    prompt, eos, want = eos_case
    _, tcfg, _, tparams = weights
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        model_cfg=tcfg, params=tparams,
        engine_cfg=EngineConfig(**SMALL_POOL)).start()
    try:
        status, body = _post(w.name, "/v1/completions", {
            "token_ids": prompt, "max_tokens": 60, "temperature": 0.0,
            "stop_token_ids": [eos]})
        refused, err = _post(w.name, "/v1/completions", {
            "token_ids": [5] * 40, "max_tokens": 4, "temperature": 0.0})
    finally:
        w.stop()
    assert status == 200, body
    assert body["choices"][0]["finish_reason"] == "stop"
    assert body["usage"]["completion_tokens"] == len(want)
    assert refused == 400 and "needs more KV pages" in err["error"]["message"]


@pytest.mark.parametrize("n", [32, 40])
def test_prompt_that_can_never_fit_is_refused_as_jax_refuses_it(weights, n):
    """8 usable pages of 4: a 32-token prompt needs 33 positions (its
    first sampled token's too), 9 pages; both engines refuse it with the
    same message."""
    msgs = []
    for engine, request in ((_jax(weights, **SMALL_POOL), JaxRequest),
                            (_port(weights, **SMALL_POOL), EngineRequest)):
        with pytest.raises(ValueError) as e:
            engine.add_request(request("big", [5] * n))
        msgs.append(str(e.value))
        assert not engine.has_work()
    assert msgs[0] == msgs[1]
    assert "needs more KV pages than the pool holds (8 × 4 tokens)" in \
        msgs[1]
    # One token less fits: 31 + 1 positions, 8 pages.
    _port(weights, **SMALL_POOL).add_request(EngineRequest("ok", [5] * 31))
