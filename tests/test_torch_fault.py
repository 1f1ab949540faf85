"""The step fault boundary of the port, against the JAX package's, on the
CPU with a tiny float32 model and the same weights.

Pinned here:

- classification: each exception type JAX's tests classify, and the
  port's own step errors, get the JAX worker's verdict;
- bisection: the JAX tests' scripted engine cases, with the JAX
  worker's blame, probe count, probe outputs and resets;
- engines: the port's and the JAX engine under the same fault driver
  (the worker's bisection and ``fault_reset`` applied to each alike)
  with two fault sources, a request seeded past int32 (an OverflowError
  when its seed is packed) and a ``fault_hook`` that raises once, in a
  section after a completed one or in a decode section, in the split
  step (both write orders), prefill-first routing, the ragged step and
  4-step bursts: streams, the fault events (blame, salvaged outputs,
  probe outputs), the step ledger, ``num_preemptions`` and
  ``load_metrics()`` equal after every step;
- F3: a worker serving three greedy streams and a fourth request seeded
  past int32 ends only the fourth, with the typed ``engine_fault``, and
  the three texts equal a JAX worker's under the same traffic;
- the JAX tests' three acts end to end with two port workers behind the
  reference JAX master: an injected step fault contained (the blamed
  stream resumed on the other worker, every stream byte-identical), a
  poison pill quarantined after two strikes with an unmarked survivor
  byte-identical, and the quarantined prompt refused.
"""

import dataclasses
import json
import threading
import time
import types

import jax
import numpy as np
import pytest

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import LoadBalancePolicyType, ServiceOptions
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.obs.failpoints import FAILPOINTS
from xllm_service_tpu.runtime import engine as jax_engine_mod
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.service.coordination_net import StoreServer
from xllm_service_tpu.service.httpd import (http_json, http_stream,
                                            iter_sse_events)
from xllm_service_tpu.service.master import Master
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig)
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import engine as torch_engine_mod
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

V = 128


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

class XlaRuntimeError(Exception):
    """Matched by the type's name, as both workers match it."""


CLASSIFY = [
    (TimeoutError("device sync"), "transient"),
    (ConnectionResetError("ice path reset"), "transient"),
    *[(XlaRuntimeError(f"{tag}: device temporarily gone"), "transient")
      for tag in ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                  "CANCELLED")],
    (XlaRuntimeError("INTERNAL: scan body mismatch"), "deterministic"),
    (ValueError("nan in logits"), "deterministic"),
    (jax_worker.StepFaultInjected("worker.fault_step"), "deterministic"),
    (torch_worker.StepFaultInjected("worker.fault_step"), "deterministic"),
    (OverflowError("Python int too large to convert to C int"),
     "deterministic"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "deterministic"),
    (MemoryError(), "deterministic"),
]


@pytest.mark.parametrize("exc,want", CLASSIFY,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _) in enumerate(CLASSIFY)])
def test_classification_matches_jax(exc, want):
    assert torch_worker._classify_step_fault(exc) == want
    assert jax_worker._classify_step_fault(exc) == want


# ---------------------------------------------------------------------------
# Bisection on a scripted engine (the JAX tests' cases)
# ---------------------------------------------------------------------------

class FakeFaultEngine:
    """``step()`` faults whenever a culprit id is in the active (isolated)
    set."""

    def __init__(self, rids, culprits=()):
        self.rids = list(rids)
        self.culprits = set(culprits)
        self.iso = None
        self.steps = 0
        self.resets = []

    def isolate(self, keep):
        assert self.iso is None, "nested isolation"
        self.iso = list(keep)

    def release_isolation(self):
        self.iso = None

    def fault_reset(self, blamed):
        self.resets.append(tuple(blamed))

    def step(self):
        self.steps += 1
        active = self.iso if self.iso is not None else self.rids
        if self.culprits.intersection(active):
            raise RuntimeError("probe reproduced the fault")
        return [types.SimpleNamespace(request_id=r) for r in active]


BISECT = {
    "culprit_within_budget": ("r0 r1 r2 r3", {"r2"}, 4),
    "last_singleton_by_elimination": ("r0 r1 r2 r3", {"r3"}, 4),
    "whole_rest_on_budget_exhaustion": ("r0 r1 r2 r3", {"r2"}, 1),
    "zero_budget_blames_all": ("r0 r1", {"r0"}, 0),
    "single_suspect_no_probe": ("r7", {"r7"}, 4),
    "faulting_probe_resets": ("r0 r1 r2 r3", {"r0"}, 4),
}
BISECT_WANT = {
    "culprit_within_budget": (["r2"], 2),
    "last_singleton_by_elimination": (["r3"], 2),
    "whole_rest_on_budget_exhaustion": (["r2", "r3"], 1),
    "zero_budget_blames_all": (["r0", "r1"], 0),
    "single_suspect_no_probe": (["r7"], 0),
    "faulting_probe_resets": (["r0"], 2),
}


def _bisect(cls, eng, suspects, budget):
    return cls._bisect_step_fault(
        types.SimpleNamespace(_fault_bisect_budget=budget), eng, suspects)


@pytest.mark.parametrize("case", sorted(BISECT))
def test_bisection_matches_jax(case):
    rids, culprits, budget = BISECT[case]
    got = []
    for cls in (torch_worker.Worker, jax_worker.Worker):
        eng = FakeFaultEngine(rids.split(), culprits)
        blamed, probe_outs = _bisect(cls, eng, rids.split(), budget)
        assert eng.iso is None, "isolation must be released"
        got.append((blamed, eng.steps, eng.resets,
                    [[o.request_id for o in outs] for outs, _ in probe_outs]))
    assert got[0] == got[1]
    assert (got[0][0], got[0][1]) == BISECT_WANT[case]
    if case == "faulting_probe_resets":
        assert got[0][2][0] == () and len(got[0][2]) >= 2


# ---------------------------------------------------------------------------
# Engines under one fault driver
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=8, num_pages=32, max_model_len=64,
              max_batch_size=4, max_prefill_tokens=16,
              prefill_buckets=(8, 16))
MODES = {
    "split_wta": dict(write_then_attend=True),
    "split_atw": dict(write_then_attend=False),
    "prefill_first": dict(interleave=False),
    "ragged": dict(ragged_attn=True, write_then_attend=True),
    "burst4": dict(decode_steps=4),
}
# (arrival step, id, prompt length, sampling)
PLAN = [
    (1, "a", 9, dict(temperature=0.0, max_tokens=18)),
    (1, "b", 13, dict(temperature=0.0, max_tokens=22)),
    (2, "c", 6, dict(temperature=0.7, top_k=8, seed=5, max_tokens=20)),
    (5, "x", 7, dict(temperature=0.0, max_tokens=12)),
    (9, "d", 11, dict(temperature=0.0, max_tokens=14)),
]
SEED_FAULT = (5, "x", 7, dict(temperature=1.0, seed=2 ** 31,
                              max_tokens=12))


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


class StepClock:
    """The ``time`` an engine module reads, advanced by ``STEP_MS`` per
    ``Engine.step()``: the starvation deadline (``prefill_deadline_ms``)
    then falls on the same step of two engines whatever the host's load.
    Every other attribute is the real ``time`` module's."""

    STEP_MS = 250.0

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    perf_counter = monotonic

    def tick(self) -> None:
        self.t += self.STEP_MS / 1000.0

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def step_clock(monkeypatch):
    """A ``StepClock`` in both engine modules, ticked before each step;
    each engine counts ``quantum_steps``, the steps whose prefill budget
    the starvation quantum raised (decode had left less than it)."""
    clocks = {}
    for mod in (jax_engine_mod, torch_engine_mod):
        clock = clocks[mod] = StepClock()
        monkeypatch.setattr(mod, "time", clock)
        cls = mod.Engine

        def step(self, _orig=cls.step, _clock=clock):
            _clock.tick()
            self._quantum_raised = False
            outs = _orig(self)
            if self._quantum_raised:
                self.quantum_steps = getattr(self, "quantum_steps", 0) + 1
            return outs

        def quantum(self, _orig=cls._starvation_quantum):
            q = _orig(self)
            if q > self.step_token_budget - self.last_step_decode_tokens:
                self._quantum_raised = True
            return q

        monkeypatch.setattr(cls, "step", step)
        monkeypatch.setattr(cls, "_starvation_quantum", quantum)
    return clocks


def _engines(weights, kw):
    jcfg, tcfg, jparams, tparams = weights
    kw = {**ENGINE, **kw, "enable_prefix_cache": True}
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw), params=jparams)
    teng = Engine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    return jeng, teng


class OneShotHook:
    """A ``fault_hook`` that raises once: at the first section of a step
    whose previous section in the same step completed (``after``), or at
    the first decode section of step ``at`` (a section whose members are
    all running)."""

    def __init__(self, engine, where: str, at: int = 0) -> None:
        self.engine, self.where, self.at = engine, where, at
        self.fired = False
        self.calls = []
        self._step = -1
        self._n = 0

    def __call__(self, members) -> None:
        eng = self.engine
        if eng.step_count != self._step:
            self._step, self._n = eng.step_count, 0
        self._n += 1
        self.calls.append((eng.step_count, tuple(members)))
        if self.fired:
            return
        running = {s.req.request_id for s in eng.running}
        if self.where == "after" and self._n == 2 or \
                self.where == "decode" and eng.step_count >= self.at \
                and members and set(members) <= running:
            self.fired = True
            raise RuntimeError(f"injected fault ({self.where})")


def _drive_faults(engine, plan, request, sampling, worker_cls, hook=None):
    """Run ``plan`` to idle through the worker's fault boundary: after a
    fault, the JAX worker's blame (``_bisect_step_fault`` of
    ``worker_cls``, budget 4) and ``fault_reset``. Returns the streams,
    the per-step records (ledger, preemptions, load) and the faults."""
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(3, V, size=n).tolist()
               for _, rid, n, _ in plan}
    streams = {rid: [] for _, rid, _, _ in plan}
    finish = {}
    records, faults, step = [], [], 0
    engine.fault_hook = hook

    def take(outs):
        for o in outs:
            streams[o.request_id] += o.new_token_ids
            if o.finished:
                finish[o.request_id] = o.finish_reason.value

    while engine.has_work() or step < max(p[0] for p in plan):
        step += 1
        for at, rid, _, sp in plan:
            if at == step:
                engine.add_request(request(rid, prompts[rid],
                                           sampling(ignore_eos=True, **sp)))
        try:
            take(engine.step())
        except Exception as exc:  # noqa: BLE001 — the boundary under test
            live = set(engine.live_request_ids())
            suspects = [r for r in engine.step_members if r in live] \
                or sorted(live)
            salvaged = list(engine.last_step_partial_outs)
            blamed, probe_outs = _bisect(worker_cls, engine, suspects, 4)
            evicted = engine.fault_reset(blamed)
            keep = [o for o in salvaged if o.request_id not in blamed]
            take(keep)
            for outs, _ in probe_outs:
                take([o for o in outs if o.request_id not in blamed])
            faults.append((step, type(exc).__name__, tuple(suspects),
                           tuple(blamed), tuple(evicted),
                           [(o.request_id, tuple(o.new_token_ids))
                            for o in keep],
                           [[(o.request_id, tuple(o.new_token_ids))
                             for o in outs] for outs, _ in probe_outs]))
        records.append((engine.last_step_kind, engine.last_step_ragged,
                        tuple(engine.last_step_prefill_windows),
                        engine.last_step_decode_tokens,
                        engine.num_preemptions, engine.load_metrics()))
        assert step < 400, "engine did not drain"
    return streams, finish, records, faults


# A prefill-first step runs one section: no section completes before
# another there.
FAULT_RUNS = [(m, src) for m in sorted(MODES)
              for src in ("seed", "after", "decode")
              if not (m == "prefill_first" and src == "after")]


@pytest.mark.parametrize("mode,source", FAULT_RUNS,
                         ids=[f"{m}-{s}" for m, s in FAULT_RUNS])
def test_engine_fault_recovery_matches_jax(weights, step_clock, mode,
                                          source):
    jeng, teng = _engines(weights, MODES[mode])
    plan = [SEED_FAULT if p[1] == "x" and source == "seed" else p
            for p in PLAN]
    hooks = [None, None]
    if source != "seed":
        hooks = [OneShotHook(jeng, source, at=7),
                 OneShotHook(teng, source, at=7)]
    want = _drive_faults(jeng, plan, JaxRequest, JaxSampling,
                         jax_worker.Worker, hooks[0])
    got = _drive_faults(teng, plan, EngineRequest, SamplingParams,
                        torch_worker.Worker, hooks[1])
    assert got[3] == want[3], "fault events differ"
    assert got[0] == want[0], "streams differ"
    assert got[1] == want[1]
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        assert g == w, f"step {i + 1}: {g} != {w}"
    assert len(got[2]) == len(want[2])
    assert len(got[3]) == 1, got[3]
    step, _, suspects, blamed, evicted, _, _ = got[3][0]
    assert list(blamed) == list(evicted) and len(blamed) == 1
    if source == "seed":
        assert blamed == ("x",) and "x" not in got[1]
        # Every other request ran to its max_tokens.
        assert all(len(got[0][rid]) == sp["max_tokens"]
                   for _, rid, _, sp in plan if rid != "x")
    if source == "after":
        assert got[3][0][5], "no salvaged outputs of the completed section"
    if hooks[1] is not None:
        assert hooks[1].calls == hooks[0].calls
    assert teng.allocator.num_free + teng.prefix_cache.num_reclaimable \
        == ENGINE["num_pages"] - 1
    assert all(s is None for s in teng._slots)
    assert teng.num_preemptions > 0
    assert getattr(teng, "quantum_steps", 0) \
        == getattr(jeng, "quantum_steps", 0)
    if (mode, source) == ("burst4", "decode"):
        # Fused bursts of 4 leave less of the 16-token budget than the
        # smallest bucket: a waiting prompt prefills on the quantum. (The
        # earlier faults of the other sources requeue the batch before
        # its decode grows that far.)
        assert teng.quantum_steps >= 1


def test_fault_reset_keeps_the_runners_buffers(weights):
    """``fault_reset`` marks the staged state stale and leaves every
    static buffer in place; the next decode stages the batch whole and
    serves the same tokens as an engine that never faulted."""
    _, teng = _engines(weights, dict(decode_steps=4))
    _, clean = _engines(weights, dict(decode_steps=4))
    plan = [p for p in PLAN if p[1] in ("a", "b")]
    for eng in (teng, clean):
        for _, rid, n, sp in plan:
            eng.add_request(EngineRequest(
                rid, list(range(3, 3 + n)),
                SamplingParams(ignore_eos=True, **sp)))
    for _ in range(3):
        teng.step()
        clean.step()
    bufs = (teng.graphs.tokens, teng.graphs.active, teng.graphs.samp_f32,
            dict(teng.graphs.tables), dict(teng.graphs.bias))
    teng.fault_reset(())
    assert teng.graphs._apt_mirror is None and teng.graphs._st_mirror is None
    assert teng._pending is None and teng._resident is None
    assert not teng._counts_valid
    assert bufs[0] is teng.graphs.tokens and bufs[1] is teng.graphs.active
    assert bufs[2] is teng.graphs.samp_f32
    assert all(teng.graphs.tables[w] is t for w, t in bufs[3].items())
    assert all(teng.graphs.bias[k] is b for k, b in bufs[4].items())
    got, want = {}, {}
    for eng, out in ((teng, got), (clean, want)):
        while eng.has_work():
            for o in eng.step():
                out.setdefault(o.request_id, []).extend(o.new_token_ids)
    # The faulted engine re-prefilled prompt + tokens and went on where
    # it stood: the tails are the clean engine's.
    for rid in want:
        assert want[rid][-len(got[rid]):] == got[rid]


def test_isolation_parks_arrivals(weights):
    _, teng = _engines(weights, {})
    teng.add_request(EngineRequest("a", [5, 6, 7], SamplingParams(
        temperature=0.0, max_tokens=4)))
    teng.isolate(["a"])
    teng.add_request(EngineRequest("late", [8, 9], SamplingParams(
        temperature=0.0, max_tokens=4)))
    assert [s.req.request_id for s in teng.waiting] == ["a"]
    assert set(teng.live_request_ids()) == {"a", "late"}
    teng.release_isolation()
    assert {s.req.request_id for s in teng.waiting} == {"a", "late"}


# ---------------------------------------------------------------------------
# F3: one bad request must not end the worker
# ---------------------------------------------------------------------------

WORKER_ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
                     max_batch_size=4, max_prefill_tokens=64,
                     prefill_buckets=(16, 32, 64))


@pytest.fixture(scope="module")
def f3_workers():
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
        yield jw, tw
    finally:
        tw.stop()
        jw.stop()
        mp.undo()


STREAM_PROMPTS = ["the first stream ", "a second stream of text ",
                  "and a third one "]


def _stream(addr, prompt, max_tokens, out, first):
    body = {"model": "tiny", "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0.0, "stream": True, "ignore_eos": True}
    res = {"text": "", "finish": None, "done": False, "error": None}
    try:
        for payload in iter_sse_events(http_stream(
                "POST", addr, "/v1/completions", body, timeout=120.0)):
            if payload == "[DONE]":
                res["done"] = True
                break
            obj = json.loads(payload)
            if "error" in obj:
                res["error"] = obj["error"]
                break
            for ch in obj.get("choices") or []:
                res["text"] += ch.get("text", "")
                if ch.get("finish_reason"):
                    res["finish"] = ch["finish_reason"]
            first.set()
    except Exception as e:  # noqa: BLE001 — recorded, asserted below
        res["error"] = f"{type(e).__name__}: {e}"
    finally:
        first.set()
    out.append(res)


def _f3_traffic(addr):
    """Three greedy streams; once each has its first frame, a request
    seeded past int32. Returns (the streams' results in prompt order,
    the seeded request's (status, body))."""
    results = [[] for _ in STREAM_PROMPTS]
    firsts = [threading.Event() for _ in STREAM_PROMPTS]
    threads = [threading.Thread(target=_stream, args=(
        addr, p, 160, results[i], firsts[i]))
        for i, p in enumerate(STREAM_PROMPTS)]
    for t in threads:
        t.start()
    for ev in firsts:
        assert ev.wait(60.0)
    bad = http_json("POST", addr, "/v1/completions",
                    {"model": "tiny", "prompt": "seeded past int32 ",
                     "max_tokens": 8, "temperature": 1.0,
                     "seed": 2 ** 31}, timeout=60.0)
    for t in threads:
        t.join(timeout=120.0)
    assert all(not t.is_alive() for t in threads), "a stream hung"
    return [r[0] for r in results], bad


def test_f3_one_bad_request_fails_alone_as_on_jax(f3_workers):
    jw, tw = f3_workers
    want, jbad = _f3_traffic(jw.name)
    got, tbad = _f3_traffic(tw.name)
    for status, body in (jbad, tbad):
        assert status == 500, body
        assert body["error"]["type"] == "engine_fault", body
        assert body["error"]["message"].startswith("engine_fault: culprit")
        assert "OverflowError" in body["error"]["message"]
    for g, w in zip(got, want):
        assert w["error"] is None and w["done"] and w["finish"] == "length"
        assert g == w
    # The worker keeps serving: its engine loop is alive, and a later
    # request is answered.
    assert tw._engine_loop_alive and tw.engine_error is None
    status, body = http_json("POST", tw.name, "/v1/completions",
                             {"model": "tiny", "prompt": "after ",
                              "max_tokens": 4, "temperature": 0.0},
                             timeout=60.0)
    assert status == 200, body
    text = tw.metrics_text()
    assert 'xllm_engine_faults_total{model="tiny",outcome="culprit"} 1' \
        in text, text
    assert 'xllm_worker_steps_total{model="tiny",phase="fault"} 1' in text
    assert 'xllm_worker_engine_alive{model="tiny"} 1' in text


def test_breaker_falls_back_to_engine_death(weights, monkeypatch):
    """Past ``XLLM_ENGINE_FAULT_LIMIT`` faults in the window the loop
    dies as before the boundary: the request gets the engine's 500, and
    so does every later one."""
    monkeypatch.setenv("XLLM_ENGINE_FAULT_LIMIT", "0")
    _, tcfg, _, tparams = weights
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        EngineConfig(**ENGINE), model_cfg=tcfg, params=tparams).start()
    try:
        w.failpoints.arm("worker.fault_step", mode="always")
        body = {"model": "tiny", "prompt": "x", "max_tokens": 2,
                "temperature": 0.0}
        status, resp = http_json("POST", w.name, "/v1/completions", body,
                                 timeout=60.0)
        assert status == 500 and resp["error"]["type"] == "engine_fault"
        assert "engine step failed" in resp["error"]["message"]
        assert not w._engine_loop_alive
        status, resp = http_json("POST", w.name, "/v1/completions", body,
                                 timeout=60.0)
        assert status == 500
        assert 'outcome="uncontained"} 1' in w.metrics_text()
        assert 'xllm_worker_engine_alive{model="tiny"} 0' in w.metrics_text()
    finally:
        w.stop()


# ---------------------------------------------------------------------------
# End to end behind the reference master (the JAX tests' three acts)
# ---------------------------------------------------------------------------

E2E_ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
                  max_batch_size=4, max_prefill_tokens=256,
                  prefill_buckets=(32, 64, 128))
PROMPT = "contain the fault "
POISON_MARK = "POISON"
POISON_PROMPT = "POISON pill prompt do not serve "


def wait_until(cond, timeout=20.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _stream_completion(http_addr, prompt=PROMPT, max_tokens=24):
    body = {"model": "tiny", "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0.0, "stream": True, "ignore_eos": True,
            "stream_options": {"include_usage": True}}
    out = {"text": "", "finish": None, "usage": None, "done": False,
           "error": None}
    try:
        for payload in iter_sse_events(http_stream(
                "POST", http_addr, "/v1/completions", body,
                timeout=120.0)):
            if payload == "[DONE]":
                out["done"] = True
                break
            obj = json.loads(payload)
            for ch in obj.get("choices") or []:
                out["text"] += ch.get("text", "")
                if ch.get("finish_reason"):
                    out["finish"] = ch["finish_reason"]
            if obj.get("usage"):
                out["usage"] = obj["usage"]
    except Exception as e:  # noqa: BLE001 — the failure mode under test
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def _same_as(stream, baseline):
    assert stream["error"] is None, stream
    assert stream["done"] and stream["finish"] == "length", stream
    assert stream["text"] == baseline["text"]
    assert stream["usage"] == baseline["usage"]


def _metric(text, name, **labels):
    total, seen = 0.0, False
    for ln in text.splitlines():
        if ln.startswith(name) and all(f'{k}="{v}"' in ln
                                       for k, v in labels.items()):
            total += float(ln.split()[-1])
            seen = True
    return total if seen else None


def _events(addr):
    status, resp = http_json("GET", addr, "/admin/events?limit=512",
                             timeout=30.0)
    assert status == 200
    return resp["events"]


def test_contained_fault_then_poison_pill_behind_the_jax_master():
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    server = StoreServer().start()
    master = Master(ServiceOptions(
        http_port=0, rpc_port=0, num_output_pools=4,
        load_balance_policy=LoadBalancePolicyType.ROUND_ROBIN,
        block_size=16, heartbeat_interval_s=0.2,
        master_upload_interval_s=0.2,
        detect_disconnected_instance_interval_s=1.0),
        store=server.store).start()
    workers = []
    try:
        for _ in range(2):
            workers.append(torch_worker.Worker(
                torch_worker.WorkerOptions(
                    model="tiny", device="cpu",
                    instance_type=InstanceType.DEFAULT,
                    store_addr=server.address,
                    service_addr=master.rpc_address,
                    heartbeat_interval_s=0.2, lease_ttl_s=1.5),
                engine_cfg=EngineConfig(**E2E_ENGINE), model_cfg=tcfg,
                params=params_from_jax(jp, tcfg, "cpu")).start())
        assert wait_until(
            lambda: len(master.scheduler.instance_mgr.prefill_instances())
            == 2), "workers never registered"
        baseline = _stream_completion(master.http_address)
        assert baseline["error"] is None and baseline["done"], baseline

        # Act 1: one injected step fault on worker A, contained.
        status, resp = http_json(
            "POST", workers[0].name, "/admin/failpoint",
            {"name": "worker.fault_step", "mode": "count", "n": 1},
            timeout=10.0)
        assert status == 200, resp
        results = [None, None]
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, _stream_completion(master.http_address)))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads)
        for s in results:
            _same_as(s, baseline)
        assert workers[0].failpoints.trips("worker.fault_step") == 1
        assert workers[0]._engine_loop_alive
        wa = workers[0].metrics_text()
        assert _metric(wa, "xllm_engine_faults_total", model="tiny",
                       outcome="culprit") >= 1, wa
        assert _metric(wa, "xllm_worker_engine_alive", model="tiny") == 1
        assert _metric(wa, "xllm_worker_steps_total", model="tiny",
                       phase="fault") >= 1
        ef = [e for e in _events(master.http_address)
              if e["type"] == "engine_fault"]
        assert ef and ef[0]["attrs"]["instance"] == workers[0].name
        assert "culprit" in ef[0]["attrs"]["verdict"]

        # Act 2: the poison pill, marked fleet-wide through the master.
        status, resp = http_json(
            "POST", master.http_address, "/admin/failpoint",
            {"instance": "*", "name": "worker.fault_step_req",
             "mode": "always", "value": POISON_MARK}, timeout=10.0)
        assert status == 200, resp
        assert all(v == 200 for v in resp["results"].values()), resp
        survivor = [None]
        st = threading.Thread(target=lambda: survivor.__setitem__(
            0, _stream_completion(master.http_address)))
        st.start()
        time.sleep(0.3)
        status, resp = http_json(
            "POST", master.http_address, "/v1/completions",
            {"model": "tiny", "prompt": POISON_PROMPT, "max_tokens": 8,
             "temperature": 0.0, "ignore_eos": True}, timeout=60.0)
        st.join(timeout=120)
        assert not st.is_alive(), "survivor stream hung"
        assert status == 500, (status, resp)
        assert resp["error"]["type"] == "engine_fault", resp
        assert resp["error"]["message"].startswith("engine_fault"), resp
        assert "culprit" in resp["error"]["message"], resp
        _same_as(survivor[0], baseline)
        events = _events(master.http_address)
        quar = [e for e in events if e["type"] == "request_quarantined"]
        assert quar and quar[0]["attrs"]["strikes"] == 2
        srid = quar[0]["attrs"]["service_request_id"]
        hops = [e for e in events if e["type"] == "engine_fault"
                and e["attrs"]["service_request_id"] == srid]
        assert {h["attrs"]["instance"] for h in hops} \
            == {w.name for w in workers}, hops

        # Act 3: the quarantined prompt is refused at admission.
        status, resp = http_json(
            "POST", master.http_address, "/v1/completions",
            {"model": "tiny", "prompt": POISON_PROMPT, "max_tokens": 8,
             "temperature": 0.0, "ignore_eos": True}, timeout=30.0)
        assert status == 500 and resp["error"]["type"] == "engine_fault"
        assert "quarantined" in resp["error"]["message"], resp
        for w in workers:
            assert w._engine_loop_alive
        _same_as(_stream_completion(master.http_address), baseline)
    finally:
        for w in workers:
            w.stop()
        master.stop()
        server.stop()


def test_failpoint_routes_and_generate_sites(weights):
    """``/admin/failpoint(s)`` arm and report the closed catalog (an
    unknown name is a 400); the generate routes fire
    ``worker.refuse_generate`` (503) and ``worker.slow_response_ms``;
    ``XLLM_FAILPOINTS``' grammar arms at construction."""
    _, tcfg, _, tparams = weights
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu"),
        EngineConfig(**ENGINE), model_cfg=tcfg, params=tparams).start()
    try:
        status, resp = http_json("POST", w.name, "/admin/failpoint",
                                 {"name": "worker.nope"}, timeout=10.0)
        assert status == 400
        status, resp = http_json(
            "POST", w.name, "/admin/failpoint",
            {"spec": "worker.refuse_generate=count:1,"
                     "worker.slow_response_ms=always:50"}, timeout=10.0)
        assert status == 200 and resp["ok"]
        assert set(resp["state"]["armed"]) == {
            "worker.refuse_generate", "worker.slow_response_ms"}
        body = {"model": "tiny", "prompt": "x", "max_tokens": 2,
                "temperature": 0.0}
        status, resp = http_json("POST", w.name, "/v1/completions", body,
                                 timeout=30.0)
        assert status == 503 and resp["error"]["type"] == "unavailable"
        t0 = time.monotonic()
        status, _ = http_json("POST", w.name, "/v1/completions", body,
                              timeout=30.0)
        assert status == 200 and time.monotonic() - t0 >= 0.05
        status, state = http_json("GET", w.name, "/admin/failpoints",
                                  timeout=10.0)
        assert state["trips"]["worker.refuse_generate"] == 1
        assert state["trips"]["worker.slow_response_ms"] == 2
        assert 'xllm_failpoints_tripped_total{name="worker.refuse_generate"}' \
            ' 1' in w.metrics_text()
        assert state["catalog"] == list(FAILPOINTS)
    finally:
        w.stop()
