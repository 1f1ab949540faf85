"""The step flight recorder and the roofline count of the port, against
the JAX package's, on the CPU.

Pinned here:

- ``obs/steptrace.py``: the closed schema equals the JAX tuple;
  ``estimate_step``, ``attribute_step``, ``roofline_table`` and
  ``flush_metrics`` equal the JAX functions on the same hand-built
  tables; the ring and its tails; the peak table (an H100 row at the
  data sheet's 989 TFLOP/s and 3.35 TB/s, the CPU placeholder as JAX's)
  and the environment overrides;
- ``models/cost.py``: after the same warmup the engine's roofline keys
  and their token counts equal the JAX engine's ``_roofline_capture``
  calls (its jitted steps recorded, not compiled); the GEMM FLOPs equal
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain CPU
  forward exactly (dense and MLA; prefill, ragged, decode); the
  attention FLOPs equal the counter's over the plain path times the
  causal fraction of its dense rectangle ([T, C] keys, [T, C + T] in
  attend-then-write; under MLA with the value side at the rank instead
  of the latent width), exactly;
  llama3-1b's decode key is 2 x B x (non-embedding parameters + LM head)
  plus its attention;
- the worker: a served request's records carry only ``STEP_FIELDS``,
  ``/admin/steptrace`` and the ``/metrics`` gauges (through the JAX
  exposition validator), the heartbeat's step tail committed only on an
  acknowledged beat, and through the reference JAX master
  ``/admin/timeline`` holds the port worker's steps and passes the JAX
  timeline validator.
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tools.trace_view import summarize, validate_trace
from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import LoadBalancePolicyType, ServiceOptions
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.obs import Registry as JaxRegistry
from xllm_service_tpu.obs import steptrace as jst
from xllm_service_tpu.obs import validate_exposition
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.service.coordination_net import StoreServer
from xllm_service_tpu.service.httpd import (http_json, http_stream,
                                            iter_sse_events)
from xllm_service_tpu.service.master import Master
from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig)
from xllm_service_tpu_torch.models import cost
from xllm_service_tpu_torch.models import transformer as tf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.obs import steptrace as tst
from xllm_service_tpu_torch.obs.metrics import Registry
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine
from tests.test_torch_prefill_graph import _Recorder
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401


# ---------------------------------------------------------------------------
# The recorder module against the JAX one
# ---------------------------------------------------------------------------

def test_step_fields_equal_jax():
    assert tst.STEP_FIELDS == jst.STEP_FIELDS


ROOFS = {
    "jax_fixture": {
        "prefill": {"B1xT64xmp2": {"flops": 1e9, "bytes": 2e9,
                                   "tokens": 64.0}},
        "decode": {"mp2": {"flops": 1e8, "bytes": 4e8, "tokens": 4.0}},
    },
    "ladder": {
        "prefill": {"B1xT32xmp1": {"flops": 3e9, "bytes": 1e9,
                                   "tokens": 32.0},
                    "B2xT32xmp1": {"flops": 6e9, "bytes": 1.2e9,
                                   "tokens": 64.0},
                    "B1xT128xmp2": {"flops": 1.2e10, "bytes": 2e9,
                                    "tokens": 128.0}},
        "ragged": {"B4xT32xmp4": {"flops": 1.3e10, "bytes": 2.5e9,
                                  "tokens": 128.0}},
        "decode": {"mp1": {"flops": 2e10, "bytes": 2.5e9, "tokens": 8.0},
                   "mp2": {"flops": 2.1e10, "bytes": 2.6e9,
                           "tokens": 8.0},
                   "mp4": {"flops": 2.2e10, "bytes": 2.7e9,
                           "tokens": 8.0}},
        "decode_multi": {"mp2": {"flops": 8e10, "bytes": 1e10,
                                 "tokens": 32.0}},
    },
    "empty": {},
    "zero_flops": {"decode": {"mp1": {"flops": 0.0, "bytes": 0.0,
                                      "tokens": 8.0}}},
}
STEPS = [
    dict(kind="prefill", prefill_tokens=128, decode_tokens=0),
    dict(kind="prefill", prefill_tokens=40, decode_tokens=0),
    dict(kind="decode", prefill_tokens=0, decode_tokens=4),
    dict(kind="decode", prefill_tokens=0, decode_tokens=5),
    dict(kind="decode", prefill_tokens=0, decode_tokens=31),
    dict(kind="mixed", prefill_tokens=96, decode_tokens=3),
    dict(kind="mixed", prefill_tokens=96, decode_tokens=3, ragged=True),
]
SHAPES = [(4, 1), (8, 4)]   # (batch_size, decode_steps)


@pytest.mark.parametrize("roof", sorted(ROOFS))
@pytest.mark.parametrize("step", range(len(STEPS)))
@pytest.mark.parametrize("shape", SHAPES, ids=["b4n1", "b8n4"])
def test_estimate_and_attribute_equal_jax(roof, step, shape):
    kw = dict(STEPS[step])
    kw.setdefault("ragged", False)
    kw["batch_size"], kw["decode_steps"] = shape
    assert tst.estimate_step(ROOFS[roof], **kw) == \
        jst.estimate_step(ROOFS[roof], **kw)
    for step_ms in (0.5, 3.0, 40.0):
        for peaks in ((1e12, 1e12), (989e12, 3.35e12), (1e11, 5e10)):
            assert tst.attribute_step(
                ROOFS[roof], step_ms=step_ms, peak_flops=peaks[0],
                peak_bytes_s=peaks[1], **kw) == jst.attribute_step(
                ROOFS[roof], step_ms=step_ms, peak_flops=peaks[0],
                peak_bytes_s=peaks[1], **kw)


@pytest.mark.parametrize("roof", sorted(ROOFS))
def test_roofline_table_and_flush_equal_jax(roof):
    for peaks in ((1e12, 1e12), (989e12, 3.35e12)):
        assert tst.roofline_table(ROOFS[roof], *peaks) == \
            jst.roofline_table(ROOFS[roof], *peaks)
    ours, theirs = Registry(), JaxRegistry()
    tst.flush_metrics(ours, "tiny", ROOFS[roof], 0.25, 1.5, "cpu")
    jst.flush_metrics(theirs, "tiny", ROOFS[roof], 0.25, 1.5, "cpu")

    def samples(text):
        return sorted(ln for ln in text.splitlines()
                      if ln and not ln.startswith("#"))
    assert samples(ours.render()) == samples(theirs.render())
    assert validate_exposition(ours.render()) == []


def test_peaks_table(monkeypatch):
    assert tst.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert tst.peaks_for("NVIDIA H100 PCIe")[0] == 989e12
    for kind in ("cpu", "", "weird-asic"):
        assert tst.peaks_for(kind) == jst.peaks_for(kind) == (1e11, 5e10)
    monkeypatch.setattr(tst, "PEAK_FLOPS_OVERRIDE", 2e12)
    monkeypatch.setattr(tst, "PEAK_BW_GBPS_OVERRIDE", 100.0)
    assert tst.peaks_for("NVIDIA H100 80GB HBM3") == (2e12, 100.0 * 1e9)
    monkeypatch.setattr(tst, "PEAK_BW_GBPS_OVERRIDE", 0.0)
    assert tst.peaks_for("NVIDIA H100 80GB HBM3") == (2e12, 3.35e12)


def test_ring_schema_and_tails():
    ring = tst.StepTrace(enabled=True, ring=16)
    assert ring.capacity == 16 and tst.StepTrace(ring=1).capacity == 16
    for i in range(40):
        assert ring.record(kind="decode", step_ms=float(i)) == i + 1
    assert len(ring) == 16 and ring.last_seq() == 40
    assert [r["seq"] for r in ring.tail(n=3)] == [38, 39, 40]
    assert [r["seq"] for r in ring.tail(since_seq=37)] == [38, 39, 40]
    ring.tail()[0]["kind"] = "changed"
    assert ring.tail()[0]["kind"] == "decode"
    with pytest.raises(ValueError, match="closed schema"):
        ring.record(kind="decode", not_a_field=1)
    assert ring.tail(window_s=1e-9)[-1]["seq"] == 40


# ---------------------------------------------------------------------------
# The count against the JAX engine's keys and the plain forward's FLOPs
# ---------------------------------------------------------------------------

LADDERS = {
    "aligned": dict(page_size=8, num_pages=32, max_model_len=64,
                    max_batch_size=2, max_prefill_tokens=32,
                    prefill_buckets=(8, 16)),
    "ragged_burst": dict(page_size=4, num_pages=64, max_model_len=64,
                         max_batch_size=4, max_prefill_tokens=32,
                         prefill_buckets=(8, 16, 32), ragged_attn=True,
                         decode_steps=4),
    "deep": dict(page_size=4, num_pages=128, max_model_len=128,
                 max_batch_size=8, max_prefill_tokens=64,
                 prefill_buckets=(8, 16, 32, 64), decode_steps=2),
}


def _jax_roofline(kw, extended):
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**kw))
    seen = {}

    def note(program, key, tokens, jitted, *args):
        table = seen.setdefault(program, {})
        if key in table or len(table) >= jeng._roofline_cap:
            return
        table[key] = float(max(tokens, 1))
    jeng._roofline_capture = note
    jeng._jit_prefill = _Recorder(3, 5, True)
    if jeng._jit_ragged is not None:
        jeng._jit_ragged = _Recorder(3, 5, True)
    jeng._jit_decode = _Recorder(1, 4, False)
    jeng._jit_decode_multi = _Recorder(3, 8, False)
    jeng.warmup(extended=extended)
    return seen


@pytest.mark.parametrize("extended", [True, False], ids=["ext", "first"])
@pytest.mark.parametrize("name", sorted(LADDERS))
def test_roofline_keys_and_tokens_equal_jax(name, extended):
    kw = LADDERS[name]
    want = _jax_roofline(kw, extended)
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    teng = Engine(tcfg, EngineConfig(**kw), device="cpu")
    teng.warmup(extended=extended)
    got = {p: {k: v["tokens"] for k, v in t.items()}
           for p, t in teng.roofline.items()}
    assert got == want
    assert all(v["flops"] > 0 and v["bytes"] > 0
               for t in teng.roofline.values() for v in t.values())


def test_roofline_switches(monkeypatch):
    kw = LADDERS["aligned"]
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    monkeypatch.setenv("XLLM_ROOFLINE_VARIANTS", "2")
    teng = Engine(tcfg, EngineConfig(**kw), device="cpu")
    teng.warmup()
    assert all(len(t) <= 2 for t in teng.roofline.values())
    monkeypatch.setenv("XLLM_ROOFLINE", "0")
    teng = Engine(tcfg, EngineConfig(**kw), device="cpu")
    teng.warmup()
    assert teng.roofline == {}


_ATTN = ("paged_decode_attention", "paged_prefill_attention",
         "ragged_paged_attention", "paged_decode_attention_current",
         "paged_prefill_attention_fresh", "paged_decode_attention_mla",
         "paged_decode_attention_mla_current", "mha_prefill_auto")
MLA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_layers=3, num_heads=4, num_kv_heads=4, head_dim=8,
           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, max_position_embeddings=512, rope_theta=10000.0,
           dtype="float32")
COUNT_MODELS = {
    "llama": lambda: dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                                         dtype="float32"),
    "gemma": lambda: dataclasses.replace(
        ModelConfig.tiny(vocab_size=128), dtype="float32", gemma=True),
    "mla": lambda: ModelConfig(**MLA),
    "mla_qlora": lambda: ModelConfig(**MLA, q_lora_rank=24),
}
COUNT_SHAPES = [("decode", 4, 1, 4), ("decode", 8, 1, 8),
                ("prefill", 2, 8, 2), ("prefill", 4, 16, 8),
                ("ragged", 2, 8, 4)]
PS = 4


def _counted(cfg, program, B, T, mp, wta):
    """(GEMM FLOPs, attention FLOPs) the flop counter sees in the plain
    CPU forward of one program shape, the attention entries' share
    measured around each call."""
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kv = tf.init_kv_cache(cfg, 1 + B * mp, PS, "cpu")
    table = torch.arange(1, 1 + B * mp, dtype=torch.int32).reshape(B, mp)
    attn = [0]
    mp_ = pytest.MonkeyPatch()
    for name in _ATTN:
        fn = getattr(tf, name)

        def wrapped(*a, _fn=fn, **k):
            before = mode.get_total_flops()
            out = _fn(*a, **k)
            attn[0] += mode.get_total_flops() - before
            return out
        mp_.setattr(tf, name, wrapped)
    try:
        with FlopCounterMode(display=False) as mode:
            if program == "decode":
                tf.forward_decode(
                    params, cfg, torch.zeros(B, dtype=torch.long),
                    torch.full((B,), mp * PS - 1, dtype=torch.int32),
                    torch.ones(B, dtype=torch.bool), kv, table,
                    write_then_attend=wta)
            else:
                C = max(mp * PS, T)
                tf.forward_prefill(
                    params, cfg, torch.zeros(B, T, dtype=torch.long),
                    torch.full((B,), C - T, dtype=torch.int32),
                    torch.full((B,), T, dtype=torch.int32), kv, table,
                    ragged=program == "ragged", write_then_attend=wta)
    finally:
        mp_.undo()
    return mode.get_total_flops() - attn[0], attn[0]


COUNT_RUNS = [(m, s, wta) for m in sorted(COUNT_MODELS)
              for s in range(len(COUNT_SHAPES)) for wta in (True, False)
              if not (COUNT_SHAPES[s][0] == "ragged"
                      and (m.startswith("mla") or not wta))]


@pytest.mark.parametrize("model,shape,wta", COUNT_RUNS,
                         ids=[f"{m}-{'-'.join(map(str, COUNT_SHAPES[s]))}-"
                              f"{'wta' if w else 'atw'}"
                              for m, s, w in COUNT_RUNS])
def test_count_equals_the_flop_counter(model, shape, wta):
    cfg = COUNT_MODELS[model]()
    program, B, T, mp = COUNT_SHAPES[shape]
    gemm, attn = _counted(cfg, program, B, T, mp, wta)
    parts = cost.forward_cost_parts(cfg, program, B, T, mp, PS)
    assert parts["gemm_flops"] == gemm
    # The plain path scores every key of the table for every query (a
    # dense [T, C] rectangle, masked; attend-then-write adds the T fresh
    # keys as columns: [T, C + T]); the count takes the causal part.
    C = max(mp * PS, T)
    want = attn * (C - (T - 1) / 2) / (C + (0 if wta else T))
    if cfg.mla:
        # ... and multiplies the values at the latent width (rank +
        # rope) where the count takes the rank.
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        want *= (2 * r + rope) / (2 * (r + rope))
    assert parts["attn_flops"] == pytest.approx(want, rel=1e-12)
    full = cost.forward_cost(cfg, program, B, T, mp, PS)
    assert full["flops"] == parts["gemm_flops"] + parts["attn_flops"]
    assert full["tokens"] == B * T


def test_llama3_1b_decode_key_is_two_flops_a_parameter():
    cfg = ModelConfig.llama3_1b()
    B, mp, ps = 8, 4, 128
    c = cost.forward_cost_parts(cfg, "decode", B, 1, mp, ps)
    D, V = cfg.hidden_size, cfg.vocab_size
    Dh, Hq, Hkv, F = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, \
        cfg.intermediate_size
    layer = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D + 3 * D * F
    assert c["gemm_flops"] == 2 * B * (cfg.num_layers * layer + D * V)
    assert c["attn_flops"] == 2 * B * cfg.num_layers * mp * ps * 2 * Hq * Dh
    # 19.8 GFLOP and 2.47 GB of bf16 weights a step at B = 8.
    assert 19.7e9 < c["gemm_flops"] < 19.9e9
    assert 2.46e9 < c["weight_bytes"] < 2.48e9
    burst = cost.forward_cost(cfg, "decode_multi", B, 1, mp, ps, 4)
    single = cost.forward_cost(cfg, "decode", B, 1, mp, ps)
    assert burst["flops"] == 4 * single["flops"]
    assert burst["tokens"] == 4 * B


def test_sliding_window_clips_the_keys():
    full = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                               dtype="float32")
    win = dataclasses.replace(full, sliding_window=6)
    per_key = 2 * full.num_heads * full.head_dim
    L = full.num_layers
    d = cost.forward_cost_parts(win, "decode", 2, 1, 8, PS)
    assert d["attn_flops"] == 2 * L * 2 * 6 * per_key
    p = cost.forward_cost_parts(win, "prefill", 1, 8, 4, PS)
    # A window of 8 at the end of 16 keys: query t sees min(9 + t, 6).
    assert p["attn_flops"] == 2 * L * 8 * 6 * per_key
    assert cost.forward_cost_parts(full, "prefill", 1, 8, 4, PS)[
        "attn_flops"] == 2 * L * sum(9 + t for t in range(8)) * per_key
    # The K/V read: the 6 + 7 keys the window's queries reach, not 16.
    assert p["kv_bytes"] < cost.forward_cost_parts(
        full, "prefill", 1, 8, 4, PS)["kv_bytes"]


def test_moe_counts_routed_experts_only():
    dense = dataclasses.replace(ModelConfig.tiny(vocab_size=128),
                                dtype="float32")
    moe = dataclasses.replace(dense, num_experts=8, num_experts_per_tok=2)
    d = cost.forward_cost_parts(dense, "decode", 1, 1, 1, PS)
    m = cost.forward_cost_parts(moe, "decode", 1, 1, 1, PS)
    D, F = dense.hidden_size, dense.intermediate_size
    L = dense.num_layers
    # One token: two experts' MLPs and the router, two experts read.
    assert m["gemm_flops"] - d["gemm_flops"] == 2 * L * (3 * D * F + D * 8)
    assert m["weight_bytes"] - d["weight_bytes"] == \
        4 * L * (3 * D * F + D * 8)
    big = cost.forward_cost_parts(moe, "prefill", 4, 32, 8, PS)
    # 128 tokens x 2 experts cover all 8: every expert is read once.
    assert big["weight_bytes"] > m["weight_bytes"] + 4 * L * 5 * 3 * D * F


# ---------------------------------------------------------------------------
# The worker's recorder
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
              max_batch_size=4, max_prefill_tokens=256,
              prefill_buckets=(32, 64, 128))


@pytest.fixture(scope="module")
def jparams():
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return tcfg, jp


def _port_worker(jparams, **opts):
    tcfg, jp = jparams
    return torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu", warmup=True,
                                   **opts),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jp, tcfg, "cpu")).start()


def _stream(addr, rid=None, max_tokens=12):
    body = {"model": "tiny", "prompt": "observe this request ",
            "max_tokens": max_tokens, "temperature": 0.0, "stream": True,
            "ignore_eos": True}
    if rid:
        body["service_request_id"] = rid
    text, done = "", False
    for payload in iter_sse_events(http_stream(
            "POST", addr, "/v1/completions", body, timeout=120.0)):
        if payload == "[DONE]":
            done = True
            break
        for ch in json.loads(payload).get("choices") or []:
            text += ch.get("text", "")
    return text, done


def test_served_request_records_and_admin_steptrace(jparams, monkeypatch):
    monkeypatch.setenv("XLLM_WARMUP_EXTENDED", "0")
    w = _port_worker(jparams)
    try:
        _, done = _stream(w.name, rid="rid-recorded")
        assert done
        status, st = http_json("GET", w.name, "/admin/steptrace",
                               timeout=10.0)
        assert status == 200 and st["enabled"] is True
        assert st["device_kind"] == "cpu"
        assert (st["peak_flops"], st["peak_bytes_s"]) == (1e11, 5e10)
        # The hot-path profiler's timed sections: the stream's SSE frames
        # and its spans were timed on this process's threads.
        assert st["sections"], "no hot-path section recorded"
        assert all(set(e) == {"name", "t_wall", "dur_ms", "thread"}
                   for e in st["sections"])
        assert {"sse.assemble", "span.write"} <= {
            e["name"] for e in st["sections"]}
        assert st["steps"], "no step recorded"
        kinds = {r["kind"] for r in st["steps"]}
        assert kinds <= {"prefill", "decode", "mixed"} and \
            {"prefill", "decode"} <= kinds
        for rec in st["steps"]:
            assert set(rec) == set(tst.STEP_FIELDS)
            assert rec["model"] == "tiny"
            assert rec["bound"] in ("compute", "memory")
            assert rec["flops"] > 0 and rec["mfu"] > 0
        assert any("rid-recorded" in r["members"] for r in st["steps"])
        assert sum(r["decode_tokens"] for r in st["steps"]) == 11
        progs = {r["program"] for r in st["roofline"]}
        assert {"prefill", "decode"} <= progs
        assert all(r["model"] == "tiny" for r in st["roofline"])
        status, st2 = http_json("GET", w.name, "/admin/steptrace?n=2",
                                timeout=10.0)
        assert [r["seq"] for r in st2["steps"]] == \
            [r["seq"] for r in st["steps"][-2:]]
        text = w.metrics_text()
        assert validate_exposition(text) == []
        for series in ("xllm_worker_step_mfu{", "xllm_worker_step_debt_ms{",
                       "xllm_worker_program_flops{",
                       "xllm_worker_program_bytes{",
                       "xllm_worker_peak_flops 100000000000"):
            assert series in text, series
    finally:
        w.stop()


def test_recorder_off_builds_nothing(jparams, monkeypatch):
    monkeypatch.setattr(tst, "ENABLED", False)
    w = _port_worker(jparams)
    try:
        assert not w.steptrace.enabled
        _, done = _stream(w.name)
        assert done and len(w.steptrace) == 0
        hb, (_, seq) = w._build_heartbeat()
        assert hb.steps == [] and seq == 0
    finally:
        w.stop()


def wait_until(cond, timeout=20.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def test_timeline_through_the_jax_master(jparams, monkeypatch):
    """Two port workers behind the reference master: the heartbeats ship
    the step tails (the master's books), and ``/admin/timeline`` pulls
    ``/admin/steptrace`` into a trace the JAX validator accepts, with the
    named request's steps on its worker's track."""
    monkeypatch.setenv("XLLM_WARMUP_EXTENDED", "0")
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
            workers.append(_port_worker(
                jparams, instance_type=InstanceType.DEFAULT,
                store_addr=server.address, service_addr=master.rpc_address,
                heartbeat_interval_s=0.2, lease_ttl_s=1.5))
        assert wait_until(
            lambda: len(master.scheduler.instance_mgr.prefill_instances())
            == 2), "workers never registered"
        rid = "rid-timeline"
        text, done = "", False
        for payload in iter_sse_events(http_stream(
                "POST", master.http_address, "/v1/completions",
                {"model": "tiny", "prompt": "observe this request ",
                 "max_tokens": 12, "temperature": 0.0, "stream": True,
                 "ignore_eos": True}, timeout=120.0,
                headers={"x-request-id": rid})):
            if payload == "[DONE]":
                done = True
                break
        assert done
        served = [w for w in workers if len(w.steptrace) > 0]
        assert len(served) == 1
        assert wait_until(lambda: served[0].name in
                          master.http_service.step_books.instances())
        assert wait_until(lambda: served[0]._hb_steps_seq
                          == served[0].steptrace.last_seq())
        status, raw = http_json("GET", master.http_address,
                                "/admin/timeline?seconds=120", timeout=30.0)
        assert status == 200
        trace = raw if isinstance(raw, dict) else json.loads(raw)
        assert validate_trace(trace) == [], validate_trace(trace)[:5]
        assert set(summarize(trace)["instances"]) == \
            {w.name for w in workers}
        steps = [e for e in trace["traceEvents"] if e.get("cat") == "step"]
        assert steps and all(e["name"].startswith("step:") for e in steps)
        flows = [e for e in trace["traceEvents"]
                 if e["ph"] in ("s", "t", "f")
                 and e["args"].get("request_id") == rid]
        assert flows, "the named request's steps are not on the timeline"
    finally:
        for w in workers:
            w.stop()
        master.stop()
        server.stop()
