"""The port's prefill and ragged step runner (``runtime/prefill_graph.py``),
its warmup ladder and its capture census, on the CPU.

Pinned here:

- the warmup ladder equals the JAX engine's: after ``warmup()`` on both
  sides the port's (B, T, MP) sets of ``prefill`` and ``ragged`` graphs
  equal the shapes the JAX engine's own ``warmup()`` compiles (its
  ``compile_report()`` counts, and an explicit set), with a budget
  below the largest bucket, with page-aligned buckets (two widths each)
  and with the ragged step on, ``extended`` on and off;
- the runner's eager body (what a graph replays) through its packed
  static buffer equals ``forward_prefill`` + ``sample_tokens`` called on
  fresh tensors, bit for bit, pools included: dense and MLA, the split
  step in both write orders and the ragged step, at start 0 and at a
  cached start;
- a reused key's padding rows write nothing: a 3-row batch after a
  4-row one under the same key leaves every pool byte outside the live
  rows' window slots as it was;
- the capture census: no capture after a warmup that covered the run,
  an uncovered shape counted under its program, eager steps by reason;
  the worker's warmup (the ladder and ``late_window_shapes``) covers
  chunked and cache-hit windows;
- with the runner in the path and a warmed-up engine, streams, step
  ledgers, ``load_metrics()`` and preemptions equal the JAX engine's
  with the prefix cache on, in every step mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.runtime import engine as jax_engine
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.ops import sampling as tsamp
from xllm_service_tpu_torch.runtime import prefill_graph
from xllm_service_tpu_torch.runtime.engine import (_VARIANTS as VARIANTS,
                                                   Engine, EngineRequest)
from xllm_service_tpu_torch.utils.types import SamplingParams
from tests.test_torch_prefix import (MODES, PLAN, TIGHT, _drive, _feed,
                                     _model)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TINY = dataclasses.replace(ModelConfig.tiny(vocab_size=128), dtype="float32")


@pytest.fixture(scope="module")
def models():
    return {kind: _model(kind) for kind in ("dense", "mla")}


# ---------------------------------------------------------------------------
# The warmup ladder against the JAX engine's
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for one of the JAX engine's jitted steps during its
    warmup: records each (B, T, MP) it is called at (or the call's
    shapes), compiles nothing, and hands the pools back."""

    def __init__(self, kv_at: int, outputs: int, step: bool) -> None:
        self.kv_at, self.outputs, self.step = kv_at, outputs, step
        self.shapes = set()

    def __call__(self, *args):
        if self.step:                 # (params, packed, ..., T)
            B, width = args[1].shape
            T = args[-1]
            self.shapes.add((B, T, width - jax_engine._PREFILL_HDR - T))
        else:                         # the packed batch / carries + table
            self.shapes.add((np.shape(args[1]), np.shape(args[3])))
        out = [None] * self.outputs
        out[self.kv_at] = args[2 if self.outputs != 8 else 4]
        if self.outputs == 8:         # decode_multi: the carries last
            out[6], out[7] = args[1], args[2]
        return tuple(out)

    def _cache_size(self) -> int:
        return len(self.shapes)


def _jax_ladder(kw, warm_kw, compile_for_real: bool):
    """The JAX engine's warmup shapes: {program: set of (B, T, MP)} for
    prefill and ragged, and its compile_report."""
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw))
    seen = {}

    def note(program, key, *args):
        if program in ("prefill", "ragged"):        # "B{B}xT{T}xmp{MP}"
            B, T, mp = (int(x) for x in key[1:].replace("xT", " ").replace(
                "xmp", " ").split())
            seen.setdefault(program, set()).add((B, T, mp))
    jeng._roofline_capture = note
    if not compile_for_real:
        jeng._jit_prefill = _Recorder(3, 5, True)
        if jeng._jit_ragged is not None:
            jeng._jit_ragged = _Recorder(3, 5, True)
        jeng._jit_decode = _Recorder(1, 4, False)
        jeng._jit_decode_multi = _Recorder(3, 8, False)
    jeng.warmup(**warm_kw)
    return ({p: seen.get(p, set()) for p in ("prefill", "ragged")},
            jeng.compile_report())


def _port_ladder(kw, warm_kw):
    teng = Engine(TINY, EngineConfig(**kw), device="cpu")
    teng.warmup(**warm_kw)
    keys = list(teng.prefill_graphs.graphs)
    sets = {p: {k[1:4] for k in keys if k[0] == p}
            for p in ("prefill", "ragged")}
    for p in sets:                     # each shape in every variant
        assert sorted(k[:6] for k in keys if k[0] == p) == sorted(
            (p, *s, g, sd) for s in sets[p] for g, sd in VARIANTS)
    return sets, teng.compile_report(), teng


P1 = [(1, 6, 1), (2, 6, 1), (4, 6, 1), (1, 12, 2), (1, 24, 4)]
P2 = [(1, 8, 1), (1, 8, 2), (2, 8, 1), (2, 8, 2),
      (1, 16, 2), (1, 16, 4), (2, 16, 2), (2, 16, 4)]
P3 = [(1, 8, 1), (1, 8, 2), (2, 8, 1), (2, 8, 2), (4, 8, 1), (4, 8, 2),
      (1, 16, 2), (1, 16, 4)]
LADDERS = {
    # A budget below the largest bucket; buckets off the page grid, so
    # one width each. The JAX steps compile for real here.
    "budget": (dict(page_size=8, num_pages=32, max_model_len=32,
                    max_batch_size=4, max_prefill_tokens=12,
                    prefill_buckets=(6, 12, 24)), {}, True, P1, []),
    # Page-aligned buckets: two widths each.
    "aligned": (dict(page_size=8, num_pages=32, max_model_len=64,
                     max_batch_size=2, max_prefill_tokens=32,
                     prefill_buckets=(8, 16)), {}, False, P2, []),
    # The ragged step on: the cross product of batches, buckets and the
    # prefill and decode widths.
    "ragged": (dict(page_size=8, num_pages=32, max_model_len=64,
                    max_batch_size=4, max_prefill_tokens=16,
                    prefill_buckets=(8, 16), ragged_attn=True), {}, False,
               P3, [(B, T, mp) for B in (1, 2, 4) for T in (8, 16)
                    for mp in (1, 2, 4, 8)]),
    "ragged_not_extended": (dict(page_size=8, num_pages=32,
                                 max_model_len=64, max_batch_size=4,
                                 max_prefill_tokens=16,
                                 prefill_buckets=(8, 16), ragged_attn=True),
                            {"extended": False}, False,
                            [(1, 8, 1), (1, 8, 2)], []),
}


@pytest.mark.parametrize("case", sorted(LADDERS))
def test_warmup_ladder_equals_jax(case):
    kw, warm_kw, real, want_prefill, want_ragged = LADDERS[case]
    jsets, jrep = _jax_ladder(kw, warm_kw, real)
    tsets, trep, teng = _port_ladder(kw, warm_kw)
    assert tsets["prefill"] == jsets["prefill"] == set(want_prefill)
    assert tsets["ragged"] == jsets["ragged"] == set(want_ragged)
    # The JAX counts are its compiled variants; the port's are graphs,
    # one per sampling variant of a shape (decode: each with and
    # without the penalty counts).
    assert jrep["prefill"] == len(want_prefill)
    assert trep["prefill"] == len(VARIANTS) * len(want_prefill)
    if kw.get("ragged_attn"):
        assert jrep["ragged"] == len(want_ragged)
        assert trep["ragged"] == len(VARIANTS) * len(want_ragged)
    else:
        assert "ragged" not in trep and "ragged" not in jrep
    assert trep["decode"] == 2 * len(VARIANTS) * jrep["decode"]
    report = teng.capture_report()
    assert report["captures_after_warmup"] == 0
    assert set(report) >= {"prefill", "ragged", "decode", "decode_multi"}


def test_explicit_prefill_shapes_restrict_the_ladder():
    kw = LADDERS["ragged"][0]
    shapes = [(2, 8, 2), (1, 16, 4)]
    jsets, _ = _jax_ladder(kw, {"prefill_shapes": shapes}, False)
    tsets, _, _ = _port_ladder(kw, {"prefill_shapes": shapes})
    assert tsets["prefill"] == jsets["prefill"] == set(shapes)
    assert tsets["ragged"] == jsets["ragged"] == {
        (B, T, mp) for B in (1, 2, 4) for T in (8, 16)
        for mp in (1, 2, 4, 8)}


# ---------------------------------------------------------------------------
# The runner's body against the plain path
# ---------------------------------------------------------------------------

def _pools(cfg, pages, ps, seed=1):
    kv = ttf.init_kv_cache(cfg, pages, ps, "cpu")
    g = torch.Generator().manual_seed(seed)
    for pool in kv:
        pool.normal_(generator=g)
    return kv


# (start, length) per live row; a cached start reads the pool's prefix.
SPANS = {
    "start0": [(0, 7), (0, 12), (0, 3)],
    "cached": [(8, 5), (12, 10), (4, 9)],
    # Ragged: decode rows first (length 1 at context - 1), then windows.
    "ragged": [(9, 1), (14, 1), (0, 11), (8, 6)],
}
SAMPLING = [SamplingParams(temperature=0.0),
            SamplingParams(temperature=0.8, top_k=5),
            SamplingParams(temperature=1.0, top_p=0.7, seed=7),
            SamplingParams(temperature=0.0)]


def _run_both(cfg, params, spans, kind, wta, sampling, ps=4, MP=8):
    """The runner's eager body and the plain path on equal pools; returns
    (runner tokens, logprobs, pools), (plain ...)."""
    rng = np.random.default_rng(5)
    B = 1 << (len(spans) - 1).bit_length()
    T = 16
    seqs = [rng.integers(3, cfg.vocab_size, size=st + n).tolist()
            for st, n in spans]
    table = rng.permutation(np.arange(1, 1 + B * MP)).reshape(B, MP)
    table = table.astype(np.int32)
    pages = [table[i, :-(-(st + n + 1) // ps)].tolist()
             for i, (st, n) in enumerate(spans)]
    kv_a = _pools(cfg, 1 + B * MP, ps)
    kv_b = tuple(p.clone() for p in kv_a)
    gen_a, gen_b = (torch.Generator().manual_seed(11) for _ in range(2))
    runner = prefill_graph.PrefillGraphs(
        params, cfg, kv_a, B, wta, gen_a, torch.device("cpu"), False, None)
    sp = sampling[:len(spans)]
    runner.stage((B, T, MP), prefill_graph.pack(
        (B, T, MP), [(s[st:st + n], st, p)
                     for s, (st, n), p in zip(seqs, spans, pages)],
        tsamp.SamplingTensors.pack_batch(
            sp + [SamplingParams(temperature=0.0)] * (B - len(sp)))))
    got = runner.launch((kind, B, T, MP, *tsamp.batch_mode(sp)))
    tokens = np.zeros((B, T), np.int64)
    start = np.zeros((B,), np.int32)
    lengths = np.zeros((B,), np.int32)
    plain_table = np.zeros((B, MP), np.int32)
    for i, (s, (st, n), p) in enumerate(zip(seqs, spans, pages)):
        tokens[i, :n] = s[st:st + n]
        start[i], lengths[i] = st, n
        plain_table[i, :len(p)] = p
    logits, _ = ttf.forward_prefill(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(start),
        torch.from_numpy(lengths), kv_b, torch.from_numpy(plain_table),
        ragged=kind == "ragged", write_then_attend=kind == "ragged" or wta)
    want = tsamp.sample_tokens(logits, sp, gen_b,
                               (start + lengths - 1).tolist())
    lps = tsamp.compute_logprobs(logits, want)
    return (got, kv_a, runner), ((want.tolist(), lps.tolist()), kv_b)


BODY_CASES = [("dense", "start0", "prefill", True),
              ("dense", "cached", "prefill", True),
              ("dense", "start0", "prefill", False),
              ("dense", "cached", "prefill", False),
              ("dense", "ragged", "ragged", True),
              ("mla", "start0", "prefill", True),
              ("mla", "cached", "prefill", False)]


@pytest.mark.parametrize(
    "model,spans,kind,wta", BODY_CASES,
    ids=[f"{m}-{s}-{k}-{'wta' if w else 'atw'}" for m, s, k, w in BODY_CASES])
def test_runner_body_equals_the_plain_path(models, model, spans, kind, wta):
    _, cfg, _, params = models[model]
    (got, kv_a, runner), (want, kv_b) = _run_both(
        cfg, params, SPANS[spans], kind, wta, SAMPLING)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == 0
    for a, b in zip(kv_a, kv_b):
        assert torch.equal(a, b)
    report = runner.programs()
    assert report[kind]["eager_steps"] == {"cpu": 1}
    assert report[kind]["captured"] == 1


def test_greedy_key_draws_nothing(models):
    """A greedy batch runs under a greedy key and leaves the generator
    where it was, as the eager sampler does."""
    _, cfg, _, params = models["dense"]
    greedy = [SamplingParams(temperature=0.0)] * 4
    (got, _, runner), (want, _) = _run_both(
        cfg, params, SPANS["cached"], "prefill", True, greedy)
    assert got[:2] == want
    assert [k[4] for k in runner.graphs] == [True]
    assert torch.equal(runner.generator.get_state(),
                       torch.Generator().manual_seed(11).get_state())


@pytest.mark.parametrize("model", ["dense", "mla"])
def test_padding_rows_of_a_reused_key_write_nothing(models, model):
    """A 3-row batch after a 4-row batch under the same (B, T, MP): the
    fourth row is padding now (length 0, NULL table), so the pages the
    earlier fourth row owned keep their bytes, and so does every slot
    outside the three live rows' windows."""
    _, cfg, _, params = models[model]
    B, T, MP, ps = 4, 8, 4, 4
    kv = _pools(cfg, 1 + B * MP, ps)
    runner = prefill_graph.PrefillGraphs(
        params, cfg, kv, B, True, torch.Generator().manual_seed(0),
        torch.device("cpu"), False, None)
    rng = np.random.default_rng(2)
    table = np.arange(1, 1 + B * MP, dtype=np.int32).reshape(B, MP)
    greedy = tsamp.SamplingTensors.pack_batch(
        [SamplingParams(temperature=0.0)] * B)
    spans = [(0, 8), (4, 6), (2, 5), (3, 8)]

    def rows(n):
        return [(rng.integers(3, cfg.vocab_size, size=ln).tolist(), st,
                 table[i].tolist()) for i, (st, ln) in enumerate(spans[:n])]
    key = ("prefill", B, T, MP, True)
    runner.stage((B, T, MP), prefill_graph.pack((B, T, MP), rows(4), greedy))
    runner.launch(key)
    before = [p.clone() for p in kv]
    runner.stage((B, T, MP), prefill_graph.pack((B, T, MP), rows(3), greedy))
    runner.launch(key)
    touched = torch.zeros(before[0].shape[1:3], dtype=torch.bool)
    for i, (st, ln) in enumerate(spans[:3]):
        for pos in range(st, st + ln):
            touched[table[i, pos // ps], pos % ps] = True
    for old, new in zip(before, kv):
        diff = (old != new).flatten(3).any(-1).any(0)      # [pages, ps]
        assert not bool(diff[~touched].any())
        assert bool(diff[touched].all())
    assert runner.programs()["prefill"]["captured"] == 1


# ---------------------------------------------------------------------------
# The capture census
# ---------------------------------------------------------------------------

def _engine(**kw):
    d = dict(page_size=8, num_pages=64, max_model_len=64, max_batch_size=2,
             max_prefill_tokens=32, prefill_buckets=(8, 16))
    d.update(kw)
    return Engine(TINY, EngineConfig(**d), device="cpu", seed=0)


def _serve(eng, prompts, temperature=0.0, seed=None):
    for i, p in enumerate(prompts):
        eng.add_request(EngineRequest(f"r{i}", list(p), SamplingParams(
            max_tokens=6, temperature=temperature, seed=seed,
            ignore_eos=True)))
    out, n = {}, 0
    while eng.has_work():
        n += 1
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        assert n < 200
    return out


def test_no_capture_after_a_warmup_that_covered_the_run():
    eng = _engine(ragged_attn=True)
    eng.warmup()
    out = _serve(eng, [range(3, 10), range(4, 16)])
    assert sorted(out) == ["r0", "r1"]
    report = eng.capture_report()
    for program in ("prefill", "ragged", "decode", "decode_multi"):
        assert report[program]["captures_after_warmup"] == 0, program
    assert report["prefill"]["eager_steps"]["cpu"] >= 1
    assert eng.compile_report() == {
        p: report[p]["captured"]
        for p in ("prefill", "ragged", "decode", "decode_multi")}


def test_uncovered_shape_counted_under_its_program():
    eng = _engine()
    eng.warmup(prefill_shapes=[(2, 16, 2)])
    _serve(eng, [range(3, 10)])          # one 7-token window: (1, 8, 1)
    report = eng.capture_report()
    assert report["prefill"]["captures_after_warmup"] == 1
    assert "b1_t8_mp1_greedy" in report["prefill"]["graphs"]
    assert report["decode"]["captures_after_warmup"] == 0
    assert report["captures_after_warmup"] == 1
    # A sampled request takes the sampled graph of the same shape.
    _serve(eng, [range(3, 10)], temperature=0.9)
    assert eng.capture_report()["prefill"]["captures_after_warmup"] == 2


def test_seeded_rows_run_eager_and_are_counted():
    """A seeded row's step takes the warmed seeded variant of its shape
    (a replay on the card; on the CPU its eager step counts under
    ``cpu``, never a reason of its own), and no capture follows."""
    eng = _engine()
    eng.warmup()
    _serve(eng, [range(3, 10)], temperature=0.9, seed=3)
    report = eng.capture_report()
    assert report["prefill"]["eager_steps"] == {"cpu": 1}
    assert "seeded" not in report["eager_steps"]
    assert "b1_t8_mp2_sampled_seeded" in report["prefill"]["graphs"]
    assert report["captures_after_warmup"] == 0


def test_late_windows_are_what_the_jax_ladder_leaves_out():
    """A prompt longer than the budget prefills in chunks; a later chunk
    and a prefix-cache hit take tables wider than their bucket's own.
    The ladder alone leaves them to captures after warmup (as the JAX
    engine compiles them lazily); with ``late_window_shapes`` (the
    worker's warmup) none is left."""
    prompts = [list(range(3, 40)), list(range(3, 40)) + [50, 51]]
    counts = []
    for late in (False, True):
        eng = _engine(max_prefill_tokens=16, max_model_len=128)
        eng.warmup()
        if late:
            eng.warmup(prefill_shapes=eng.late_window_shapes())
        _serve(eng, prompts[:1])
        _serve(eng, prompts[1:])
        assert eng.prefix_hit_tokens > 0
        counts.append(eng.capture_report()["prefill"][
            "captures_after_warmup"])
    assert counts[0] > 0 and counts[1] == 0


# ---------------------------------------------------------------------------
# Parity with the JAX engine, warmed up, the prefix cache on
# ---------------------------------------------------------------------------

WARMED = [("split", 4), ("ragged", 1), ("prefill_first", 1)]


@pytest.mark.parametrize("mode,steps", WARMED,
                         ids=[f"{m}-{'burst' if n > 1 else 'single'}"
                              for m, n in WARMED])
def test_warmed_engine_matches_jax(models, mode, steps):
    """The runner in every step mode, on an engine warmed up as the
    worker warms it: streams, per-step ledger, load and cache stats
    equal the JAX engine's, and no step needed a capture."""
    jcfg, tcfg, jparams, tparams = models["dense"]
    cfg = {**TIGHT, "enable_prefix_cache": True, "decode_steps": steps,
           **MODES[mode]}
    jeng = JaxEngine(jcfg, JaxEngineConfig(**cfg), params=jparams)
    teng = Engine(tcfg, EngineConfig(**cfg), params=tparams, device="cpu")
    teng.warmup()
    teng.warmup(prefill_shapes=teng.late_window_shapes())
    jst, jsteps = _drive(jeng, _feed(PLAN), JaxRequest, JaxSampling)
    tst, tsteps = _drive(teng, _feed(PLAN), EngineRequest, SamplingParams)
    assert tst == jst
    assert tsteps == jsteps
    assert teng.num_preemptions == jeng.num_preemptions > 0
    report = teng.capture_report()
    assert report["captures_after_warmup"] == 0, report
    forwards = sum(led[4] for led, *_ in tsteps)
    assert forwards == report["replays"] + sum(
        report["eager_steps"].values())
    kind = "ragged" if mode == "ragged" else "prefill"
    assert report[kind]["eager_steps"]["cpu"] >= 1


# ---------------------------------------------------------------------------
# The worker's warmup and its recompile counters on /metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extended", ["1", "0"])
def test_worker_exports_recompile_counters(monkeypatch, extended):
    """The worker warms up as the JAX worker does (XLLM_WARMUP_EXTENDED),
    and /metrics carries ``xllm_worker_jit_compiles_total`` (graphs per
    program, warmup included) and ``xllm_worker_recompiles_total``
    (captures after warmup) for every program, in valid exposition."""
    from xllm_service_tpu.obs import validate_exposition
    from xllm_service_tpu_torch.runtime import worker as torch_worker
    monkeypatch.setenv("XLLM_WARMUP_EXTENDED", extended)
    cfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                              dtype="float32")
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu", warmup=True),
        EngineConfig(page_size=16, num_pages=64, max_model_len=128,
                     max_batch_size=4, max_prefill_tokens=64,
                     prefill_buckets=(16, 32, 64)), model_cfg=cfg).start()
    try:
        compiled = w.engine.compile_report()
        ladder = prefill_graph.ladder([1, 2, 4], (16, 32, 64), 64, 16,
                                      extended == "1")
        late = w.engine.late_window_shapes() if extended == "1" else []
        assert compiled["prefill"] == len(VARIANTS) * (len(ladder)
                                                       + len(late))
        status, body = _http(w.name, "POST", "/v1/completions", {
            "prompt": "a prompt of some forty bytes or so, here",
            "max_tokens": 4, "temperature": 0.0})
        assert status == 200, body
        status, text = _http(w.name, "GET", "/metrics")
        assert status == 200
        assert validate_exposition(text) == []
        after = w.engine.capture_report()
        for program in ("prefill", "decode", "decode_multi"):
            assert (f'xllm_worker_jit_compiles_total{{model="tiny",'
                    f'program="{program}"}} '
                    f'{w.engine.compile_report()[program]}') in text
            assert (f'xllm_worker_recompiles_total{{model="tiny",'
                    f'program="{program}"}} '
                    f'{after[program]["captures_after_warmup"]}') in text
        # The full ladder covers a 40-byte prompt; the first shapes alone
        # do not.
        assert (after["captures_after_warmup"] == 0) == (extended == "1")
    finally:
        w.stop()


def _http(addr, method, path, obj=None):
    import json
    from http.client import HTTPConnection
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path,
                     body=json.dumps(obj) if obj is not None else None,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()
