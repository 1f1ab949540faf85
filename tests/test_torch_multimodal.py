"""The port's EPD multimodal path against the JAX package on the CPU.

- ``ops/rope.py``'s multimodal rope (``apply_mrope``, ``rope_for`` with
  3-D streams, the sectioned cos/sin tables) and ``ops/norm.layer_norm``;
- every function of ``runtime/multimodal.py``;
- the synthetic ViT with the JAX weights carried across;
- prefill (with a splice and 3-D rope streams) and decode (with a rope
  delta) logits, on a tiny Qwen2-VL text stack (mrope sections [2, 2,
  2]) and a tiny llama;
- engines with images: token streams and the per-step ledger identical
  to the JAX engine's (the ragged step on: an mrope model never takes
  it), every image token spliced, multimodal sequences outside the
  prefix cache;
- workers behind the reference master: F7 (image chats on a port worker
  give the JAX worker's texts), the three-stage EPD flow with an
  encode-only port worker, its embedding cache and the local fallback
  under ``worker.fail_encode``, ``/v1/embeddings``, and PD migrations of
  an image chat (port to port, JAX to port).

Every worker encodes with the synthetic ViT in float32 (the JAX
worker's by a monkeypatch of its tiny config, the port's carried from
the JAX weights), so that greedy texts compare exactly. Tolerances:
float32 forwards 1e-4 absolute on logits, towers and rope 1e-5.
"""

import base64
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.models import vision as jvision
from xllm_service_tpu.ops import norm as jnorm
from xllm_service_tpu.ops import rope as jrope
from xllm_service_tpu.runtime import multimodal as jmm
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig)
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models import vision as tvision
from xllm_service_tpu_torch.models.weights import (params_from_jax,
                                                   vision_params_from_jax)
from xllm_service_tpu_torch.ops import norm as tnorm
from xllm_service_tpu_torch.ops import rope as trope
from xllm_service_tpu_torch.runtime import multimodal as tmm
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_cluster import (  # noqa: F401 — a fixture
    ENGINE, HB_S, MODEL, Cluster, generate, models, wait_until)
from tests.test_torch_pd import PdCluster
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

TOL = 1e-5              # rope, norms, towers (float32)
LOGIT_TOL = 1e-4        # float32 forwards
# The tiny Qwen2-VL text stack of tests/test_qwen2vl_vision.py:255.
QWEN2VL_TINY = dict(model_type="qwen2_vl", vocab_size=256, hidden_size=48,
                    intermediate_size=96, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=512, rope_theta=10000.0,
                    rope_scaling={"type": "mrope",
                                  "mrope_section": [2, 2, 2]})


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# Rope and norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,sections,equal", [
    (12, (2, 2, 2), False), (128, (16, 24, 24), False),
    (128, (16, 24, 24), True)])
def test_mrope_matches_jax(D, sections, equal):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5))
    p3 = (np.broadcast_to(pos[:, None], (2, 3, 5)) if equal
          else rng.integers(0, 300, size=(2, 3, 5))).astype(np.int32)
    ref = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(p3),
                                       1e4, sections))
    xt, p3t = torch.from_numpy(x), torch.from_numpy(p3.copy())
    np.testing.assert_allclose(trope.apply_mrope(xt, p3t, 1e4, sections),
                               ref, rtol=TOL, atol=TOL)
    # The sectioned tables, as the fused writers take them.
    cos, sin = trope.mrope_cos_sin(p3t, D, 1e4, sections)
    assert cos.shape == (2, 5, D // 2) and cos.dtype == torch.float32
    np.testing.assert_allclose(trope.rotate(xt, cos, sin), ref, rtol=TOL,
                               atol=TOL)
    scaling = ("mrope", sections)
    np.testing.assert_allclose(
        trope.rope_for(scaling, xt, torch.from_numpy(pos), 1e4, p3t),
        np.asarray(jrope.rope_for(scaling, jnp.asarray(x), jnp.asarray(pos),
                                  1e4, positions3=jnp.asarray(p3))),
        rtol=TOL, atol=TOL)
    # No streams: standard rope, through rope_cos_sin too.
    std = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    np.testing.assert_allclose(
        trope.rope_for(scaling, xt, torch.from_numpy(pos), 1e4), std,
        rtol=TOL, atol=TOL)
    c2, s2 = trope.rope_cos_sin(torch.from_numpy(pos), D, 1e4, scaling)
    np.testing.assert_allclose(trope.rotate(xt, c2, s2), std, rtol=TOL,
                               atol=TOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    got = tnorm.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# runtime/multimodal.py
# ---------------------------------------------------------------------------

def _b64(arr):
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


_RAW = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
_MM_CASES = {
    "load_random": lambda m: m.load_image("random:3", 16),
    "load_wrapped": lambda m: m.load_image(
        {"type": "image", "data": "random:9"}, 8),
    "load_pixels": lambda m: m.load_image(
        {"pixels_b64": _b64(_RAW), "shape": [8, 6, 3]}, 16),
    "resize": lambda m: m._resize_nearest(_RAW, 5),
    "token_id": lambda m: m.image_token_id(512),
    "expand": lambda m: m.expand_image_placeholders(
        [1, 2, 9, 8, 3, 9, 8, 4], [9, 8], 2, 3, 99),
    "expand_fewer": lambda m: m.expand_image_placeholders(
        [9, 1, 9, 2], [9], 1, 2, 99),
    "mrope_text": lambda m: m.mrope_positions([1, 2, 3], 99, [], 2),
    "mrope_one": lambda m: m.mrope_positions(
        [7, 5] + [99] * 4 + [5, 11, 2], 99, [(1, 4, 4)], 2),
    "mrope_two": lambda m: m.mrope_positions(
        [3] + [99] * 16 + [4, 4] + [99] * 6 + [1], 99,
        [(1, 8, 8), (2, 2, 6)], 2),
    "digest_str": lambda m: m.image_digest("random:3", 7),
    "digest_dict": lambda m: m.image_digest(
        {"pixels_b64": _b64(_RAW), "shape": [8, 6, 3]}),
    "digest_wrapped": lambda m: m.image_digest(
        {"type": "image", "data": "random:3"}),
    "digest_other": lambda m: m.image_digest([1, 2]),
    "raw_meta": lambda m: m.embeds_raw_meta(_RAW),
    "raw_round_trip": lambda m: m.embeds_from_raw(
        m.embeds_raw_meta(_RAW), _RAW.tobytes()),
    "wire": lambda m: m.embeds_to_wire(_RAW),
    "wire_round_trip": lambda m: m.embeds_from_wire(m.embeds_to_wire(_RAW)),
}
_MM_ERRORS = {
    "bad_spec": lambda m: m.load_image(12345, 16),
    "count_mismatch": lambda m: m.expand_image_placeholders([1, 2], [9], 1,
                                                            2, 99),
    "empty_placeholder": lambda m: m.expand_image_placeholders([1], [], 0,
                                                               2, 99),
    "short_run": lambda m: m.mrope_positions([99, 99, 1], 99, [(1, 4, 4)],
                                             2),
    "no_grid": lambda m: m.mrope_positions([99], 99, [], 2),
}


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", sorted(_MM_CASES))
def test_multimodal_function_matches_jax(case):
    _same(_MM_CASES[case](tmm), _MM_CASES[case](jmm))


@pytest.mark.parametrize("case", sorted(_MM_ERRORS))
def test_multimodal_refusal_matches_jax(case):
    with pytest.raises(ValueError) as ref:
        _MM_ERRORS[case](jmm)
    with pytest.raises(ValueError) as mine:
        _MM_ERRORS[case](tmm)
    assert str(mine.value) == str(ref.value)


def test_placeholder_is_the_chat_templates():
    from xllm_service_tpu.nlp.chat_template import IMAGE_PLACEHOLDER
    assert tmm.IMAGE_PLACEHOLDER == IMAGE_PLACEHOLDER


# ---------------------------------------------------------------------------
# The synthetic ViT
# ---------------------------------------------------------------------------

def _vit_f32(hidden):
    return jvision.VisionConfig(image_size=16, patch_size=4, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=2, output_size=hidden,
                                dtype="float32")


@pytest.fixture(scope="module")
def vit():
    """The JAX worker's tiny synthetic ViT in float32 (its tiny config
    monkeypatched for the module), and the port's copy of it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jvision.VisionConfig, "tiny",
               classmethod(lambda cls, output_size=64: _vit_f32(output_size)))
    jcfg = jvision.VisionConfig.tiny(64)
    jp = jax.tree_util.tree_map(np.asarray, jvision.init_vision_params(
        jcfg, jax.random.PRNGKey(0)))
    tcfg = tvision.VisionConfig(**vars(jcfg))
    yield jcfg, jp, (tcfg, vision_params_from_jax(jp, "cpu"))
    mp.undo()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_vit_matches_jax(dtype):
    jcfg = jvision.VisionConfig.tiny(48)
    jcfg.dtype = dtype
    jp = jvision.init_vision_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tvision.VisionConfig(**vars(jcfg))
    tp = vision_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu", getattr(torch, dtype))
    px = np.stack([jmm.load_image(f"random:{s}", 16) for s in (1, 2)])
    ref = np.asarray(jvision.encode_image(jp, jcfg, jnp.asarray(px)),
                     np.float32)
    got = tvision.encode_image(tp, tcfg, torch.from_numpy(px)).float()
    assert got.shape == (2, tcfg.tokens_per_image, 48)
    # bf16: one bf16 ulp of the output's scale (matmul rounding orders).
    tol = TOL if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        tvision.patchify(torch.from_numpy(px), 4).numpy(),
        np.asarray(jvision.patchify(jnp.asarray(px), 4)))


# ---------------------------------------------------------------------------
# Forwards with a splice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks():
    """(JAX config, port config, JAX params, port params) of a tiny
    Qwen2-VL text stack and a tiny llama, float32."""
    out = {}
    for name, jcfg, tcfg in (
            ("qwen2vl", JaxModelConfig.from_hf_config(QWEN2VL_TINY, "q"),
             ModelConfig.from_hf_config(QWEN2VL_TINY, "q")),
            ("llama", JaxModelConfig.tiny(vocab_size=256),
             ModelConfig.tiny(vocab_size=256))):
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
        jp = jax.tree_util.tree_map(np.asarray, jtf.init_params(
            jcfg, jax.random.PRNGKey(3)))
        out[name] = (jcfg, tcfg, jp, params_from_jax(jp, tcfg, "cpu"))
    return out


def _image_prompt(n_text=(3, 4), tpi=16, img=255):
    """A prompt of text, ``tpi`` image tokens, text; the image span's
    positions and [3, T] rope streams (a (1, 8, 8) grid, merge 2)."""
    ids = list(range(5, 5 + n_text[0])) + [img] * tpi \
        + list(range(20, 20 + n_text[1]))
    rp, delta = jmm.mrope_positions(ids, img, [(1, 8, 8)], 2)
    pos = [i for i, t in enumerate(ids) if t == img]
    return ids, pos, rp, delta


@pytest.mark.parametrize("name", ["qwen2vl", "llama"])
def test_spliced_prefill_and_decode_match_jax(stacks, name):
    jcfg, tcfg, jp, tp = stacks[name]
    mrope = name == "qwen2vl"
    ids, pos, rp, delta = _image_prompt()
    T = len(ids)
    D = jcfg.hidden_size
    emb = np.random.default_rng(4).standard_normal(
        (len(pos), D)).astype(np.float32)
    ps, pages = 8, -(-(T + 1) // 8)
    table = np.arange(1, pages + 1, dtype=np.int32)[None]
    jkv = jtf.init_kv_cache(jcfg, pages + 1, ps, jnp.float32)
    rope_j = jnp.asarray(rp[None]) if mrope else None
    jl, _, jkv = jtf.forward_prefill(
        jp, jcfg, jnp.asarray([ids], jnp.int32), jnp.zeros(1, jnp.int32),
        jnp.asarray([T], jnp.int32), jkv, jnp.asarray(table),
        mm_embeds=jnp.asarray(emb[None]),
        mm_positions=jnp.asarray([pos], jnp.int32), rope_pos=rope_j)
    tkv = ttf.init_kv_cache(tcfg, pages + 1, ps, "cpu")
    index = np.full((1, T), -1, np.int64)
    index[0, pos] = np.arange(len(pos))
    tl, tkv = ttf.forward_prefill(
        tp, tcfg, torch.tensor([ids]), torch.zeros(1, dtype=torch.int32),
        torch.tensor([T], dtype=torch.int32), tkv, torch.from_numpy(table),
        write_then_attend=False, mm_embeds=torch.from_numpy(emb),
        mm_index=torch.from_numpy(index),
        rope_pos=torch.from_numpy(rp[None]) if mrope else None)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    # The splice changed the forward.
    plain, _ = ttf.forward_prefill(
        tp, tcfg, torch.tensor([ids]), torch.zeros(1, dtype=torch.int32),
        torch.tensor([T], dtype=torch.int32),
        ttf.init_kv_cache(tcfg, pages + 1, ps, "cpu"),
        torch.from_numpy(table), write_then_attend=False)
    assert not torch.allclose(plain, tl)
    # One decode step after it, at position + delta under mrope.
    tok = int(np.argmax(np.asarray(jl)[0]))
    jd, _ = jtf.forward_decode(
        jp, jcfg, jnp.asarray([tok], jnp.int32), jnp.asarray([T], jnp.int32),
        jnp.asarray([True]), jkv, jnp.asarray(table),
        rope_delta=jnp.asarray([delta], jnp.int32) if mrope else None)
    td, _ = ttf.forward_decode(
        tp, tcfg, torch.tensor([tok]), torch.tensor([T], dtype=torch.int32),
        torch.tensor([True]), tkv, torch.from_numpy(table),
        write_then_attend=False,
        rope_delta=torch.tensor([delta], dtype=torch.int32) if mrope
        else None)
    np.testing.assert_allclose(td, np.asarray(jd), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["qwen2vl", "llama"])
def test_forward_embedding_matches_jax(stacks, name):
    jcfg, tcfg, jp, tp = stacks[name]
    rng = np.random.default_rng(6)
    toks = rng.integers(3, 250, size=(4, 8))
    lens = np.asarray([8, 3, 5, 1], np.int32)
    ref = np.asarray(jtf.forward_embedding(jp, jcfg, jnp.asarray(toks),
                                           jnp.asarray(lens)))
    got = ttf.forward_embedding(tp, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(lens),
                                ttf.init_kv_cache(tcfg, 2, 8, "cpu"))
    np.testing.assert_allclose(got, ref, rtol=TOL * 10, atol=TOL * 10)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_size=8, num_pages=96, max_model_len=128,
                 max_batch_size=4, max_prefill_tokens=32,
                 prefill_buckets=(16, 32), ragged_attn=True,
                 enable_prefix_cache=True)


def _requests(pkg, jcfg, mrope):
    """Two image requests (one with an image span crossing two prefill
    windows), then a text request that shares the first's text prefix,
    then the first image's prompt again (it must not hit its cache)."""
    mk_req, mk_s = ((JaxRequest, JaxSampling) if pkg == "jax"
                    else (EngineRequest, SamplingParams))
    img = jmm.image_token_id(jcfg.vocab_size)
    rng = np.random.default_rng(7)
    out = []
    for i, (pre, post) in enumerate(((20, 5), (3, 4), (20, 5))):
        ids, pos, rp, delta = _image_prompt((pre, post), img=img)
        emb = rng.standard_normal((len(pos), jcfg.hidden_size)) \
            .astype(np.float32)
        if i == 2:
            emb = out[0][1]
        out.append((ids, emb, pos, rp, delta))
    reqs = []
    for i, (ids, emb, pos, rp, delta) in enumerate(out):
        mm = dict(mm_embeds=emb, mm_positions=list(pos))
        if mrope:
            mm.update(mm_rope_pos=rp, rope_delta=delta)
        reqs.append(mk_req(f"img{i}", list(ids),
                           mk_s(temperature=0.0, max_tokens=9,
                                ignore_eos=True), **mm))
    reqs.insert(2, mk_req("text", out[0][0][:20] + [7, 7, 7],
                          mk_s(temperature=0.0, max_tokens=9,
                               ignore_eos=True)))
    return reqs


def _drive(engine, reqs):
    """Streams and the per-step ledger; each request arrives one step
    after the last, so that decodes and prefills interleave."""
    streams, ledger = {}, []
    pending = list(reqs)
    for _ in range(400):
        if pending:
            engine.add_request(pending.pop(0))
        if not engine.has_work() and not pending:
            break
        for o in engine.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
        ledger.append((engine.last_step_kind, engine.last_step_ragged,
                       engine.last_step_prefill_tokens,
                       engine.last_step_decode_tokens,
                       engine.last_step_attn_dispatches))
    return streams, ledger


@pytest.mark.parametrize("name", ["qwen2vl", "llama"])
def test_engine_streams_with_images_match_jax(stacks, name):
    jcfg, tcfg, jp, tp = stacks[name]
    mrope = name == "qwen2vl"
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ENGINE_KW),
                     params=jax.tree_util.tree_map(jnp.asarray, jp))
    teng = Engine(tcfg, EngineConfig(**ENGINE_KW), params=tp, device="cpu")
    want, want_ledger = _drive(jeng, _requests("jax", jcfg, mrope))
    got, got_ledger = _drive(teng, _requests("port", jcfg, mrope))
    assert got == want
    assert got_ledger == want_ledger
    # An mrope model never takes the ragged step; a llama does.
    assert any(r[1] for r in got_ledger) != mrope
    assert teng.mm_spliced_tokens == 3 * 16
    assert (teng.prefix_lookups, teng.prefix_hit_tokens) == \
        (jeng.prefix_lookups, jeng.prefix_hit_tokens)
    assert teng.prefix_lookups == 1


# ---------------------------------------------------------------------------
# Workers behind the reference master
# ---------------------------------------------------------------------------

def _port_worker(cluster, models, vit, itype=InstanceType.DEFAULT,
                 **opts):
    _, tcfg, jparams = models
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(
            model=MODEL, device="cpu", instance_type=itype,
            store_addr=cluster.server.address,
            service_addr=cluster.master.rpc_address,
            heartbeat_interval_s=HB_S, **opts),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu"),
        vision_tower=vit[2]).start()
    cluster.workers.append(w)
    mgr = cluster.master.scheduler.instance_mgr
    assert wait_until(lambda: w.name in mgr.encode_instances()
                      or w.name in cluster.listed())
    return w


@pytest.fixture(scope="module")
def epd(models, vit):
    """A port worker and a JAX worker, each behind its own master."""
    port, ref = Cluster(), Cluster()
    _port_worker(port, models, vit)
    ref.add_jax_worker()
    yield port, ref
    port.close()
    ref.close()


def _chat(*images, text="Describe: ", max_tokens=6):
    content = [{"type": "text", "text": text}]
    content += [{"type": "image_url", "image_url": {"url": u}}
                for u in images]
    return {"model": MODEL, "max_tokens": max_tokens, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": content}]}


CHATS = {"one": ("random:11",), "two": ("random:3", "random:11")}


@pytest.fixture(scope="module")
def ref_texts(epd):
    _, ref = epd
    return {k: generate(ref, "/v1/chat/completions", _chat(*imgs),
                        False)[0] for k, imgs in CHATS.items()}


@pytest.mark.parametrize("stream", [False, True])
def test_f7_image_chat_through_master_matches_jax(epd, ref_texts, stream):
    """F7: the reference master forwards ``mm_inputs`` and one
    ``<|image_pad|>`` per image; the port worker encodes, expands and
    splices them, as the JAX worker does: the same temperature-0 texts,
    and every image token spliced (16 per tiny image)."""
    port, _ = epd
    w = port.workers[0]
    spliced = w.engine.mm_spliced_tokens
    for k, imgs in CHATS.items():
        text = generate(port, "/v1/chat/completions", _chat(*imgs),
                        stream)[0]
        assert text == ref_texts[k], k
    assert w.engine.mm_spliced_tokens - spliced == 16 * 3
    # Without the image the text differs: the splice is what matched.
    assert generate(port, "/v1/chat/completions", _chat(),
                    stream)[0] != ref_texts["one"]


def test_embeddings_match_jax_worker(epd):
    port, ref = epd
    body = {"model": MODEL, "input": ["hello there", "a", "xyz " * 10]}
    st, mine = http_json("POST", port.workers[0].name, "/v1/embeddings",
                         body)
    st_ref, want = http_json("POST", ref.workers[0].name, "/v1/embeddings",
                             body)
    assert st == st_ref == 200
    assert mine["usage"] == want["usage"]
    assert [d["index"] for d in mine["data"]] == [0, 1, 2]
    np.testing.assert_allclose(
        [d["embedding"] for d in mine["data"]],
        [d["embedding"] for d in want["data"]], rtol=1e-4, atol=1e-4)
    long = {"model": MODEL, "input": "x" * 300}
    for w in (port.workers[0], ref.workers[0]):
        st, err = http_json("POST", w.name, "/v1/embeddings", long)
        assert st == 400 and "256 tokens" in err["error"]["message"]


def test_three_stage_epd_cache_and_fallback(models, vit, ref_texts):
    """An encode-only port worker (``--role encode``) serves the routed
    encode stage of a port worker: the JAX worker's text; the same image
    again is an embedding-cache hit; with ``worker.fail_encode`` armed on
    the encode worker the requester encodes locally (the same text), the
    hop counted and an ``encode_fallback`` event."""
    c = Cluster()
    try:
        enc = _port_worker(c, models, vit, InstanceType.ENCODE,
                           encode_only=True)
        assert enc.engine is None and enc.instance_type == \
            InstanceType.ENCODE
        gen = _port_worker(c, models, vit)
        mgr = c.master.scheduler.instance_mgr
        assert wait_until(lambda: mgr.encode_instances() == [enc.name])
        for _ in range(2):
            assert generate(c, "/v1/chat/completions", _chat(*CHATS["one"]),
                            False)[0] == ref_texts["one"]
        assert (enc.encode_cache_misses, enc.encode_cache_hits) == (1, 1)
        assert gen.encode_calls == 0
        enc.failpoints.arm("worker.fail_encode", mode="count", n=8)
        assert generate(c, "/v1/chat/completions", _chat(*CHATS["one"]),
                        False)[0] == ref_texts["one"]
        fb = [e for e in gen.events.since(0) if e["type"] == "encode_fallback"]
        assert fb and fb[0]["attrs"]["target"] == "local"
        assert gen.encode_calls == 1
        assert "xllm_encode_fallback_total" in gen.metrics_text()
        # The encode worker's registration and beat.
        st, reg = http_json("GET", enc.name, "/v1/models")
        assert st == 200 and reg["data"][0]["state"] == "asleep"
    finally:
        c.close()


def test_encode_route_matches_jax(epd):
    """``/encode`` bodies (raw and base64) and a bad spec's 400, against
    the JAX worker's route."""
    port, ref = epd
    pw, jw = port.workers[0], ref.workers[0]
    for body in ({"images": ["random:5", "random:6"]},
                 {"mm_inputs": ["random:5"]}):
        st, mine = http_json("POST", pw.name, "/encode", body)
        st_ref, want = http_json("POST", jw.name, "/encode", body)
        assert st == st_ref == 200
        assert mine["shape"] == want["shape"]
        np.testing.assert_allclose(
            jmm.embeds_from_wire(mine), jmm.embeds_from_wire(want),
            rtol=TOL, atol=TOL)
    emb, hits = pw._fetch_remote_embeds(jw.name, ["random:5"], 30.0)
    assert hits == 1 and emb.shape == (1, 16, 64)
    for body in ({"images": [12345]}, {}):
        assert http_json("POST", pw.name, "/encode", body)[0] == \
            http_json("POST", jw.name, "/encode", body)[0] == 400
    assert http_json("POST", pw.name, "/encode_done", {"uuid": 3})[1] == \
        {"ok": True, "known": False}


# ---------------------------------------------------------------------------
# PD migration of an image chat
# ---------------------------------------------------------------------------

class _VitPd(PdCluster):
    """PdCluster whose port workers encode with the carried tower."""

    def __init__(self, wmodels, vit, prefill, decode):
        self._vit = vit
        super().__init__(wmodels, prefill, decode)

    def _worker(self, wmodels, pkg, role):
        if pkg == "jax":
            return super()._worker(wmodels, pkg, role)
        from tests.test_torch_pd import WORKER_ENGINE
        jcfg, tcfg, jparams = wmodels
        return torch_worker.Worker(
            torch_worker.WorkerOptions(
                model=MODEL, device="cpu", instance_type=InstanceType(role),
                store_addr=self.server.address,
                service_addr=self.master.rpc_address,
                heartbeat_interval_s=0.2, pd_direct_kv=False),
            engine_cfg=EngineConfig(**WORKER_ENGINE), model_cfg=tcfg,
            params=params_from_jax(jparams, tcfg, "cpu"),
            vision_tower=self._vit[2]).start()


@pytest.mark.parametrize("pair", [("port", "port"), ("jax", "port")])
def test_pd_migration_with_an_image(models, vit, ref_texts, pair):
    """The prefill worker encodes and prefills, the KV and the
    multimodal state (embeddings, positions) move to the decode worker,
    which finishes the stream: the text of one JAX worker serving it
    whole, and the adopted sequence kept out of the decode side's prefix
    cache."""
    c = _VitPd(models, vit, *pair)
    try:
        body = _chat(*CHATS["one"])
        text = generate(c, "/v1/chat/completions", body, False)[0]
        assert text == ref_texts["one"]
        dec = c.decode.engine
        assert wait_until(lambda: not dec.has_work())
        assert dec.prefix_cache.num_cached_pages == 0
        if pair[0] == "port":
            assert c.prefill.engine.mm_spliced_tokens == 16
            assert c.prefill.kv_migration_bytes > 0
    finally:
        c.close()
