"""The port's decode runner, fused multi-step decode and the speculative
pipeline, on the CPU.

Decode steps go through ``runtime/decode_graph.py``: static input
buffers filled only where they changed, and a body that runs N forwards
feeding each sampled token forward (a CUDA graph replay on the card; on
the CPU the same body, called eagerly). Pinned here:

- with ``decode_steps`` in {1, 4} and the pipeline on and off, the
  temperature-0 streams, the per-step ledger and the preemption count
  equal the JAX engine's on a pool that preempts, for
  ``ModelConfig.tiny`` and the tiny DeepSeek-V2-Lite shapes;
- the JAX engine's multi-step cases (``tests/test_engine.py``): a
  ``max_tokens`` that is no multiple of N, an EOS inside a burst, the
  single-step fallback near ``max_model_len`` leaving no KV hole, the
  lookahead clamped to ``max_tokens``, no speculation across a
  ``max_tokens`` boundary;
- rollbacks (an EOS mid-burst; an admission under a tight pool)
  and a steady stretch of hits, streams equal to the pipeline off,
  sampled streams too (the generator's state is restored on rollback);
- the runner's static-buffer step equals ``forward_decode`` + the
  sampler called directly, bit for bit;
- ``capture_report()``: no capture after a warmup that covered the run's
  shapes, and every eager step counted under its reason.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.ops import sampling as tsamp
from xllm_service_tpu_torch.runtime import decode_graph
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import FinishReason, SamplingParams

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

# 10 usable pages of 4 tokens for 4 sequences that grow to 22-24 tokens:
# single steps and bursts of 4 both preempt.
TIGHT = dict(page_size=4, num_pages=11, max_model_len=128,
             max_batch_size=4, max_prefill_tokens=32,
             prefill_buckets=(8, 16, 32))
PRESSURE = {1: [(9, 14), (14, 10)], 2: [(6, 16)], 4: [(12, 12)]}
MLA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           moe_intermediate_size=48, num_layers=3, num_heads=4,
           num_kv_heads=4, head_dim=8, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, num_experts=4,
           num_experts_per_tok=2, n_shared_experts=1,
           first_k_dense_replace=1, routed_scaling_factor=1.5,
           norm_topk_prob=False, max_position_embeddings=512,
           rope_theta=10000.0, dtype="float32", name="tiny-v2-lite",
           rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True, 0.707),
           mla_yarn_mscale=True)


@pytest.fixture(scope="module")
def models():
    out = {}
    for model in ("dense", "mla"):
        if model == "dense":
            jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128),
                                       dtype="float32")
            tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                                       dtype="float32")
        else:
            jcfg, tcfg = JaxModelConfig(**MLA), ModelConfig(**MLA)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
        out[model] = (jcfg, tcfg, jparams, tparams)
    return out


def _feed(vocab, seed=0):
    rng = np.random.default_rng(seed)
    feed, i = {}, 0
    for step, reqs in sorted(PRESSURE.items()):
        for n, max_tokens in reqs:
            feed.setdefault(step, []).append(
                (f"r{i}", rng.integers(3, vocab, size=n).tolist(),
                 max_tokens))
            i += 1
    return feed


def _drive(engine, feed, request, sampling, temperature=0.0, eos=()):
    """Run to idle; returns (streams, finish reasons, per-step ledger)."""
    streams, finish, ledger, step = {}, {}, [], 0
    while engine.has_work() or step < max(feed):
        step += 1
        for rid, toks, max_tokens in feed.get(step, []):
            engine.add_request(request(
                rid, toks, sampling(max_tokens=max_tokens,
                                    temperature=temperature,
                                    ignore_eos=not eos),
                eos_token_ids=tuple(eos)))
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.finished:
                finish[o.request_id] = o.finish_reason.value
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       tuple(engine.last_step_prefill_windows),
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
        assert step < 400, "engine did not drain"
    return streams, finish, ledger


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipe"])
@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("model", ["dense", "mla"])
def test_streams_ledger_and_preemptions_match_jax(models, model, steps,
                                                  pipeline):
    jcfg, tcfg, jparams, tparams = models[model]
    kw = dict(TIGHT, decode_steps=steps, decode_pipeline=pipeline)
    feed = _feed(tcfg.vocab_size)
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw, enable_prefix_cache=False),
                     params=jparams)
    teng = Engine(tcfg, EngineConfig(**kw, enable_prefix_cache=False),
                  params=tparams, device="cpu")
    assert teng.decode_pipeline is jeng.decode_pipeline
    jst, jfin, jled = _drive(jeng, feed, JaxRequest, JaxSampling)
    tst, tfin, tled = _drive(teng, feed, EngineRequest, SamplingParams)
    assert tst == jst and tfin == jfin
    assert tled == jled
    assert teng.num_preemptions == jeng.num_preemptions > 0
    assert (teng.phase_counts["decode_multi.dispatch"] > 0) == (steps > 1)
    om, jom = teng.overlap_metrics(), jeng.overlap_metrics()
    for k in ("spec_dispatches", "spec_hits", "spec_rollbacks"):
        assert om[k] == jom[k], (k, om, jom)
    assert teng.allocator.num_free == TIGHT["num_pages"] - 1


# ---------------------------------------------------------------------------
# The JAX engine's multi-step cases, on the port
# ---------------------------------------------------------------------------

MCFG = dataclasses.replace(ModelConfig.tiny(vocab_size=64), dtype="float32")


def _engine(steps, pipeline=None, **kw):
    d = dict(page_size=8, num_pages=32, max_model_len=64, max_batch_size=2,
             max_prefill_tokens=64, prefill_buckets=(16,),
             decode_steps=steps, decode_pipeline=pipeline)
    d.update(kw)
    return Engine(MCFG, EngineConfig(**d), device="cpu", seed=0)


def _run(eng, reqs, feed=None):
    """Drive to idle; {rid: (tokens, logprobs, reason)}. ``feed``: {step:
    request} admitted before that step."""
    for r in reqs:
        eng.add_request(r)
    toks, lps, reasons, step = {}, {}, {}, 0
    feed = dict(feed or {})
    while eng.has_work() or feed:
        step += 1
        if step in feed:
            eng.add_request(feed.pop(step))
        for out in eng.step():
            toks.setdefault(out.request_id, []).extend(out.new_token_ids)
            lps.setdefault(out.request_id, []).extend(out.logprobs)
            if out.finished:
                reasons[out.request_id] = out.finish_reason
        assert step < 300, "engine did not drain"
    return {r: (toks[r], lps[r], reasons.get(r)) for r in toks}


def _req(rid, prompt, max_tokens, eos=(), **sampling):
    sampling.setdefault("temperature", 0.0)
    return EngineRequest(rid, list(prompt), SamplingParams(
        max_tokens=max_tokens, ignore_eos=not eos, **sampling),
        eos_token_ids=tuple(eos))


@pytest.mark.parametrize("max_tokens", [5, 12])
def test_max_tokens_not_multiple_of_steps(max_tokens):
    single = _run(_engine(1), [_req("r", range(1, 9), max_tokens)])["r"]
    multi = _run(_engine(4), [_req("r", range(1, 9), max_tokens)])["r"]
    assert multi[0] == single[0] and len(multi[0]) == max_tokens
    np.testing.assert_allclose(multi[1], single[1], rtol=1e-5, atol=1e-6)


def test_eos_mid_scan_stops():
    probe = _run(_engine(4), [_req("p", range(1, 9), 6)])["p"][0]
    eng = _engine(4)
    got = _run(eng, [_req("r", range(1, 9), 6, eos=(probe[1],))])["r"]
    assert got[0] == probe[:2]               # truncated at the eos token
    assert got[2] == FinishReason.STOP
    # The discarded lookahead's pages were released (free, or
    # reclaimable under the prefix cache), as the JAX test counts them.
    assert eng.allocator.num_free + eng.prefix_cache.num_reclaimable \
        == eng.ecfg.num_pages - 1


def test_multi_to_single_fallback_no_kv_hole():
    """A burst pre-grows pages for its own lookahead only; the
    single-step fallback near max_model_len grows its page before it
    writes, so every position up to the last holds a written key."""
    eng = _engine(6, page_size=4, max_model_len=16, max_prefill_tokens=16,
                  prefill_buckets=(8,))
    seen = {}
    finish = eng._finish_seq

    def keep(seq, reason):
        seen["pages"], seen["tokens"] = list(seq.pages), list(seq.tokens)
        finish(seq, reason)
    eng._finish_seq = keep
    out = _run(eng, [_req("r", range(1, 7), 12)])["r"]
    assert len(seen["tokens"]) == 16 and len(out[0]) == 10
    k = eng.kv[0]
    for pos in range(len(seen["tokens"]) - 1):
        row = k[:, seen["pages"][pos // 4], pos % 4]       # [L, Hkv, D]
        assert row.abs().max() > 0, f"KV hole at position {pos}"


def test_multi_step_lookahead_clamped_to_max_tokens():
    """3 usable pages: a sequence 2 tokens from max_tokens must not
    reserve 7 tokens of lookahead (it would preempt itself)."""
    eng = _engine(8, page_size=4, num_pages=4, max_model_len=32,
                  max_batch_size=1, max_prefill_tokens=16,
                  prefill_buckets=(8,))
    out = _run(eng, [_req("clamp", range(1, 9), 2)])["clamp"]
    assert len(out[0]) == 2 and eng.num_preemptions == 0


def _pipe(pipeline, **kw):
    # Prefill-first routing, as the JAX engine's pipeline matrix runs.
    d = dict(page_size=32, num_pages=16, max_model_len=64,
             max_prefill_tokens=64, prefill_buckets=(8, 16, 32),
             interleave=False)
    d.update(kw)
    return _engine(4, pipeline, **d)


def test_no_speculation_across_max_tokens_boundary():
    """max_tokens expiring on a burst boundary is predictable: that burst
    is not speculated, and later bursts of the other sequence are."""
    def run(pipeline):
        e = _pipe(pipeline)
        # 1 (prefill) + 4 + 4 = 9: expires at the end of burst 2.
        out = _run(e, [_req("a", range(1, 9), 9), _req("b", range(3, 11), 21)])
        return out, e.overlap_metrics()
    on, om = run(True)
    off, om_off = run(False)
    assert on == off
    assert on["a"][2] == FinishReason.LENGTH and len(on["a"][0]) == 9
    assert len(on["b"][0]) == 21
    assert om["spec_rollbacks"] == 0, om
    assert om["spec_hits"] >= 1 and om["spec_dispatches"] == om["spec_hits"]
    assert om_off["spec_dispatches"] == 0


# ---------------------------------------------------------------------------
# Rollbacks and hits
# ---------------------------------------------------------------------------

def test_rollback_on_eos_mid_burst():
    probe = _run(_pipe(False), [_req("p", range(1, 9), 12)])["p"][0]

    def run(pipeline):
        e = _pipe(pipeline)
        out = _run(e, [_req("a", range(1, 9), 12, eos=(probe[1],)),
                       _req("b", range(3, 11), 12)])
        return out, e.overlap_metrics()
    on, om = run(True)
    off, om_off = run(False)
    assert on == off
    assert on["a"][2] == FinishReason.STOP and len(on["a"][0]) == 2
    assert on["b"][2] == FinishReason.LENGTH
    assert om["spec_rollbacks"] >= 1, om
    assert om_off["spec_dispatches"] == 0


def test_rollback_on_admission_under_a_tight_pool():
    """Pages of 8 tokens, 5 usable: an admission rolls back the burst in
    flight, and the two sequences then preempt each other for pages;
    streams and preemptions equal the pipeline off."""
    def run(pipeline):
        e = _engine(4, pipeline, page_size=8, num_pages=6, max_model_len=64,
                    max_prefill_tokens=16, prefill_buckets=(8, 16),
                    interleave=False)
        out = _run(e, [_req("a", range(1, 9), 30)],
                   feed={3: _req("b", range(3, 17), 12)})
        return out, e.num_preemptions, e.overlap_metrics()
    on, pre_on, om = run(True)
    off, pre_off, _ = run(False)
    assert on == off and pre_on == pre_off >= 1
    assert len(on["a"][0]) == 30 and len(on["b"][0]) == 12
    assert om["spec_rollbacks"] >= 1 and om["spec_hits"] >= 1, om


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_steady_stretch_hits_and_rollback_keep_streams(temperature):
    """A long all-decode stretch is served by speculation hits; an
    admission rolls the in-flight burst back. Sampled streams equal the
    pipeline off too: the rolled-back burst's draws are undone."""
    def run(pipeline):
        e = _pipe(pipeline, max_batch_size=2)
        out = _run(e, [_req("a", range(1, 9), 30, temperature=temperature,
                            top_p=0.9)],
                   feed={5: _req("b", range(3, 11), 16,
                                 temperature=temperature)})
        return out, e.overlap_metrics()
    on, om = run(True)
    off, _ = run(False)
    assert on == off
    assert len(on["a"][0]) == 30 and len(on["b"][0]) == 16
    assert om["spec_hits"] >= 1 and om["spec_rollbacks"] >= 1, om


def test_seeded_streams_keep_their_draws_across_burst_shapes():
    """A seeded row draws from (seed, position) whatever the burst: its
    stream is the same in single steps, in bursts, and pipelined, and
    such steps are counted as eager."""
    outs = []
    for steps, pipeline in ((1, None), (4, False), (4, True)):
        e = _engine(steps, pipeline)
        outs.append(_run(e, [_req("s", range(1, 9), 13, temperature=1.2,
                                  seed=99),
                             _req("u", range(2, 12), 9)])["s"][0])
        assert e.capture_report()["eager_steps"]["cpu"] >= 1
    assert outs[0] == outs[1] == outs[2]


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["dense", "mla"])
def test_runner_step_equals_the_plain_eager_step(models, model):
    """Staged buffers + the body (what a graph replays) against
    forward_decode and the sampler called on fresh tensors: the same
    tokens, logprobs and pools, bit for bit; the carries advance."""
    _, cfg, _, params = models[model]
    B, MP, ps = 4, 4, 4
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, cfg.vocab_size, size=B)
    positions = np.array([5, 0, 9, 13], np.int32)
    active = np.array([True, False, True, True])
    table = rng.permutation(np.arange(1, 1 + B * MP)).reshape(B, MP)
    table = table.astype(np.int32)
    packed = tsamp.SamplingTensors.pack_batch(
        [SamplingParams(temperature=0.0), SamplingParams(temperature=0.0),
         SamplingParams(temperature=0.8, top_k=5),
         SamplingParams(temperature=1.0, top_p=0.7)])
    kv_a = ttf.init_kv_cache(cfg, 1 + B * MP, ps, "cpu")
    for pool in kv_a:
        pool.normal_(generator=torch.Generator().manual_seed(1))
    kv_b = tuple(p.clone() for p in kv_a)
    gen_a = torch.Generator().manual_seed(5)
    gen_b = torch.Generator().manual_seed(5)
    runner = decode_graph.DecodeGraphs(params, cfg, kv_a, B, 1, False,
                                       gen_a, torch.device("cpu"), False)
    runner.stage_active_table(active, table)
    runner.stage_sampling(packed)
    runner.stage_carries(tokens, positions)
    launch = runner.launch((MP, 1, False))
    toks, lps, tops = launch.read()
    assert tops is None
    logits, _ = ttf.forward_decode(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(active), kv_b, torch.from_numpy(table),
        write_then_attend=False)
    st = tsamp.SamplingTensors.from_packed(packed, "cpu")
    want = tsamp.sample_packed(logits, st, gen_b)
    assert toks[0] == want.tolist()
    assert lps[0] == tsamp.compute_logprobs(logits, want).tolist()
    for a, b in zip(kv_a, kv_b):
        assert torch.equal(a, b)
    assert runner.tokens.tolist() == want.tolist()
    assert runner.positions.tolist() == (positions + 1).tolist()
    assert runner.report()["eager_steps"] == {"cpu": 1}


def test_greedy_rows_ignore_the_draw():
    """where(temperature == 0, argmax, draw): a greedy row's token is the
    argmax whatever the generator holds, also in a sampled batch."""
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 50)).astype(np.float32))
    st = tsamp.SamplingTensors.from_packed(tsamp.SamplingTensors.pack_batch(
        [SamplingParams(temperature=0.0), SamplingParams(temperature=2.0),
         SamplingParams(temperature=0.0)]), "cpu")
    greedy = torch.argmax(logits, -1)
    for seed in range(5):
        got = tsamp.sample_packed(logits, st,
                                  torch.Generator().manual_seed(seed))
        assert got[0] == greedy[0] and got[2] == greedy[2]


@pytest.mark.parametrize("steps", [1, 4])
def test_no_capture_after_a_warmup_that_covered_the_run(steps):
    eng = _engine(steps)
    eng.warmup()
    report = eng.capture_report()
    widths = decode_graph.decode_widths(eng.ecfg.max_pages_per_seq)
    # Greedy, sampled and seeded, each with and without the counts.
    assert report["decode"]["captured"] + report["decode_multi"]["captured"] \
        == len(widths) * len({1, steps}) * 6
    assert (report["decode_multi"]["captured"] > 0) == (steps > 1)
    out = _run(eng, [_req("a", range(1, 9), 20, temperature=0.7),
                     _req("b", range(2, 14), 11)])
    assert len(out["a"][0]) == 20 and len(out["b"][0]) == 11
    report = eng.capture_report()
    assert report["captures_after_warmup"] == 0
    assert report["cuda_graphs"] is False and report["replays"] == 0
    assert report["eager_steps"]["cpu"] >= 1
    assert set(report["eager_steps"]) == {"cpu"}
