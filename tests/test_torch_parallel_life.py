"""The port's sharded worker's lifecycle and encode plane against the JAX
package's, on the CPU.

The port's tp = 2 workers run on two processes of a module-wide pool
(``tests/torch_rank_pool.py``: rank 0 the worker, rank 1 the model book
of ``ranks.follow_launch``), or start their rank 1 themselves (the
encode role); the JAX side is one in-process JAX worker at tp = 2 on
the 8 virtual CPU devices of ``tests/conftest.py``, whose texts, forked
model and embeddings every case shares. Every model is float32. A model
staged without a directory is random from a seed on both sides; the
port's engines here draw the JAX engine's weights for it
(``PRNGKey(0)``), so that texts compare exactly. Cases:

- F13: ``/fork_master`` then ``/wakeup`` on a tp = 2 port worker builds
  the forked model's engine on every rank with the worker's mesh (half
  the heads each), and its text equals the JAX worker's forked model's;
- sleep and a warm wake at tp = 2: each rank parks its own shard, per
  leaf sha256-equal to the engine's weights, and holds no engine; the
  texts after the wake equal the JAX worker's; a request in flight at
  the sleep gets the port's typed 503;
- ``--role encode`` at ``--tp 2`` (rank 1 a child the worker starts):
  nothing awake on any rank, ``/encode`` bit-equal to an unsharded
  ENCODE worker's, and a cold ``/wakeup`` from a JAX-written checkpoint
  serving the JAX worker's texts;
- ``/v1/embeddings`` at tp = 2 against the JAX worker's, rel L2 <= 1e-5
  (float32 forwards in another reduction order);
- an image chat through a tp = 2 worker on a tiny mrope model with the
  synthetic ViT: the JAX worker's text, every image token spliced, the
  rows sent once in a tensor broadcast, and the same rope deltas staged
  on both ranks;
- the decode pipeline at tp = 2 (``decode_steps = 4``): streams equal to
  the pipeline off and, for the greedy and seeded rows, to the JAX
  engine's at tp = 2; a stop token inside a burst forces rollbacks,
  after which both ranks' generators and carries are identical.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.models import vision as jvision
from xllm_service_tpu.parallel import MeshSpec as JaxMeshSpec
from xllm_service_tpu.parallel import make_mesh as jax_make_mesh
from xllm_service_tpu.runtime import worker as jw
from xllm_service_tpu.runtime.checkpoint import save_checkpoint
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models.weights import (params_from_jax,
                                                   vision_params_from_jax)
from xllm_service_tpu_torch.runtime import worker as tw
from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
from xllm_service_tpu_torch.utils.types import SamplingParams

from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401
from tests.torch_rank_pool import RankPool

PROMPTS = ["the quick brown fox jumps", "a page table of sixty-four"]
EMBED_INPUTS = ["hello there", "a", "xyz " * 10]
ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
              max_batch_size=4, max_prefill_tokens=128,
              prefill_buckets=(32, 64))
# Float32 forwards of one model in two reduction orders (the sharded
# all-reduces against XLA's): the embeddings' relative L2.
EMBED_REL_L2 = 1e-5


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


@pytest.fixture(scope="module")
def models():
    """The primary ``tiny`` (vocab 512) and ``tiny-b`` (3 layers), JAX
    and port configs, and the weights the JAX engine draws for each."""
    out = {}
    for name, kw in (("tiny", {}), ("tiny-b", dict(num_layers=3))):
        jcfg = _f32(JaxModelConfig.tiny(vocab_size=512), **kw)
        tcfg = _f32(ModelConfig.tiny(vocab_size=512), **kw)
        jp = jax.tree_util.tree_map(np.asarray,
                                    jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        out[name] = (jcfg, tcfg, jp, _numpy(params_from_jax(jp, tcfg, "cpu")))
    return out


def _complete(addr, model, prompt, **extra):
    status, body = http_json("POST", addr, "/v1/completions", dict(
        {"model": model, "prompt": prompt, "max_tokens": 12,
         "temperature": 0.0, "ignore_eos": True}, **extra), timeout=120.0)
    assert status == 200, body
    return body["choices"][0]["text"]


@pytest.fixture(scope="module")
def jax_ref(models):
    """The JAX worker at tp = 2: its texts, its forked ``tiny-b``'s
    texts, and its embeddings."""
    mp = pytest.MonkeyPatch()
    for name in models:
        mp.setitem(jw._MODEL_REGISTRY, name,
                   lambda name=name: models[name][0])
    w = jw.Worker(jw.WorkerOptions(port=0, model="tiny", warmup=False),
                  InMemoryStore(sweep_interval_s=0.05),
                  engine_cfg=JaxEngineConfig(**ENGINE, tp=2),
                  mesh=jax_make_mesh(JaxMeshSpec(tp=2))).start()
    try:
        out = {"texts": [_complete(w.name, "tiny", p) for p in PROMPTS]}
        st, out["embed"] = http_json("POST", w.name, "/v1/embeddings", {
            "model": "tiny", "input": EMBED_INPUTS}, timeout=120.0)
        assert st == 200
        for path, body in (("/fork_master", {"models": ["tiny-b"]}),
                           ("/wakeup", {"model": "tiny-b"})):
            assert http_json("POST", w.name, path, body,
                             timeout=120.0)[0] == 200
        out["forked"] = [_complete(w.name, "tiny-b", p) for p in PROMPTS]
        yield out
    finally:
        w.stop()
        mp.undo()


@pytest.fixture(scope="module")
def life(pool, models):
    """One tp = 2 port worker's lifecycle run (``life_worker``)."""
    _, tcfg, _, params = models["tiny"]
    _, bcfg, _, bparams = models["tiny-b"]
    return pool.run({"tp": 2}, "life_worker", tcfg,
                    EngineConfig(**ENGINE, tp=2), params,
                    ("tiny-b", bcfg, bparams), PROMPTS, EMBED_INPUTS)[0]


def test_f13_forked_model_is_sharded_as_jax(life, jax_ref):
    """F13: the forked model's runtime and engine take the worker's
    mesh; its wake builds an engine on every rank holding half the
    heads (``tiny`` has 4 query and 2 KV heads), and its text equals
    the JAX worker's forked model's at tp = 2."""
    assert life["fork"] == (200, {"ok": True, "created": ["tiny-b"]})
    # Staged asleep on every rank, nothing on the device for it.
    for rank in life["book_forked"]:
        assert rank["asleep"]["tiny-b"]["parked_bytes"] == 0
        assert "tiny-b" not in rank["awake"]
    assert life["fork_wake"][0] == 200
    assert life["fork_mesh"] == (True, True, [2, 1])
    for rank in life["book_both"]:
        got = rank["awake"]["tiny-b"]
        assert got["mesh"] and got["heads"] == [2, 1]
        assert rank["timings"]["tiny-b"]["source"] == "random"
    assert life["forked"] == jax_ref["forked"]
    assert life["forked"] != life["after"]


def test_tp2_sleep_parks_each_shard_and_warm_wake_serves_as_jax(life,
                                                                 jax_ref):
    """A sleep at tp = 2 parks each rank's own shard, per leaf equal to
    the weights its engine held, and drops every rank's engine; the
    warm wake rebuilds each rank's engine from its parked shard and
    serves the JAX worker's texts, as before the sleep."""
    assert life["before"] == jax_ref["texts"]
    assert life["sleep"] == (200, {"ok": True, "model": "tiny",
                                   "state": "asleep"})
    awake, asleep = life["book_awake"], life["book_asleep"]
    assert [r["rank"] for r in asleep] == [0, 1]
    for a, s in zip(awake, asleep):
        assert s["awake"] == {}
        parked = s["asleep"]["tiny"]
        assert parked["digests"] == a["awake"]["tiny"]["digests"]
        assert parked["parked_bytes"] == a["awake"]["tiny"]["bytes"]
    # The two ranks hold different halves.
    assert awake[0]["awake"]["tiny"]["digests"] != \
        awake[1]["awake"]["tiny"]["digests"]
    # A generate on the sleeping model: the JAX worker's 400
    # (``tests/test_torch_lifecycle.py``'s route steps).
    assert life["asleep_reply"] == 400
    assert life["wake"] == (200, {"ok": True, "model": "tiny",
                                  "state": "awake"})
    assert life["after"] == jax_ref["texts"]
    for rank in life["book_both"]:
        assert rank["timings"]["tiny"]["source"] == "parked"


def test_tp2_sleep_ends_a_request_in_flight_with_503(life):
    status, body = life["inflight"]
    assert status == 503, body
    assert body["error"]["type"] == "unavailable"
    assert "put to sleep" in body["error"]["message"]


def test_tp2_embeddings_match_jax(life, jax_ref):
    status, mine = life["embed"]
    want = jax_ref["embed"]
    assert status == 200
    assert mine["usage"] == want["usage"]
    got = np.array([d["embedding"] for d in mine["data"]])
    ref = np.array([d["embedding"] for d in want["data"]])
    assert got.shape == ref.shape == (3, 64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= EMBED_REL_L2, rel


# ---------------------------------------------------------------------------
# The encode role at tp = 2
# ---------------------------------------------------------------------------

def test_tp2_encode_role_cold_wake_matches_jax(tmp_path, models, jax_ref):
    """A worker at ``--role encode`` and tp = 2 (its rank 1 a child it
    starts, asleep): nothing awake on either rank; ``/encode`` equal,
    bit for bit, to an unsharded ENCODE worker's; a cold ``/wakeup``
    loads the JAX-written checkpoint on every rank and serves the JAX
    worker's texts."""
    jcfg, tcfg, jp, _ = models["tiny"]
    d = str(tmp_path / "model")
    save_checkpoint(jp, jcfg, d)
    opts = dict(model="tiny", model_dir=d, device="cpu", warmup=False,
                encode_only=True, dist_backend="gloo")
    enc = tw.Worker(tw.WorkerOptions(**opts),
                    engine_cfg=EngineConfig(**ENGINE, tp=2),
                    model_cfg=tcfg).start()
    ref = tw.Worker(tw.WorkerOptions(**opts),
                    engine_cfg=EngineConfig(**ENGINE),
                    model_cfg=tcfg).start()
    try:
        book = enc.mesh_book()
        assert [r["rank"] for r in book] == [0, 1]
        for rank in book:
            assert rank["awake"] == {}
            assert rank["asleep"] == {"tiny": {"parked_bytes": 0}}
        body = {"images": ["random:5", "random:6"]}
        st, mine = http_json("POST", enc.name, "/encode", body)
        st_ref, want = http_json("POST", ref.name, "/encode", body)
        assert st == st_ref == 200
        assert mine == want
        assert http_json("POST", enc.name, "/wakeup", {"model": "tiny"},
                         timeout=120.0)[0] == 200
        assert [_complete(enc.name, "tiny", p) for p in PROMPTS] == \
            jax_ref["texts"]
        for rank in enc.mesh_book():
            assert rank["awake"]["tiny"]["heads"] == [2, 1]
            assert rank["timings"]["tiny"]["source"] == "checkpoint"
    finally:
        enc.stop()
        ref.stop()


# ---------------------------------------------------------------------------
# An image chat at tp = 2
# ---------------------------------------------------------------------------

QWEN2VL_TINY = dict(model_type="qwen2_vl", vocab_size=256, hidden_size=48,
                    intermediate_size=96, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=512, rope_theta=10000.0,
                    rope_scaling={"type": "mrope",
                                  "mrope_section": [2, 2, 2]})


def _vit(hidden):
    return jvision.VisionConfig(image_size=16, patch_size=4, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=2, output_size=hidden,
                                dtype="float32")


def test_tp2_image_chat_matches_jax(pool):
    """An image completion on a tiny mrope model (the synthetic ViT in
    float32, the JAX worker's by a monkeypatch of its tiny config, the
    port's carried across) at tp = 2: the JAX worker's text at tp = 2,
    every image token spliced (16 an image), the rows sent to rank 1 in
    one tensor broadcast a prefill, and the same rope deltas staged on
    both ranks (the image prompt's nonzero one among them)."""
    from xllm_service_tpu_torch.runtime.multimodal import IMAGE_PLACEHOLDER
    jcfg = _f32(JaxModelConfig.from_hf_config(QWEN2VL_TINY, "q"),
                name="tiny-vl")
    tcfg = _f32(ModelConfig.from_hf_config(QWEN2VL_TINY, "q"),
                name="tiny-vl")
    jp = jax.tree_util.tree_map(np.asarray,
                                jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    vcfg = _vit(jcfg.hidden_size)
    vp = jax.tree_util.tree_map(np.asarray, jvision.init_vision_params(
        vcfg, jax.random.PRNGKey(0)))
    bodies = [{"model": "tiny-vl",
               "prompt": f"Describe: {IMAGE_PLACEHOLDER} now",
               "mm_inputs": [img], "max_tokens": 8, "temperature": 0.0,
               "ignore_eos": True} for img in ("random:11", "random:3")]
    mp = pytest.MonkeyPatch()
    mp.setitem(jw._MODEL_REGISTRY, "tiny-vl", lambda: jcfg)
    mp.setattr(jvision.VisionConfig, "tiny",
               classmethod(lambda cls, output_size=64: _vit(output_size)))
    ecfg = dict(ENGINE, page_size=8, num_pages=96, max_model_len=128)
    w = jw.Worker(jw.WorkerOptions(port=0, model="tiny-vl", warmup=False),
                  InMemoryStore(sweep_interval_s=0.05),
                  engine_cfg=JaxEngineConfig(**ecfg, tp=2),
                  mesh=jax_make_mesh(JaxMeshSpec(tp=2))).start()
    try:
        want = []
        for b in bodies:
            st, resp = http_json("POST", w.name, "/v1/completions", b,
                                 timeout=120.0)
            assert st == 200, resp
            want.append(resp["choices"][0]["text"])
    finally:
        w.stop()
        mp.undo()
    tower = ({k: getattr(vcfg, k) for k in vars(vcfg)},
             _numpy(vision_params_from_jax(vp, "cpu")))
    texts, spliced, collectives, deltas = pool.run(
        {"tp": 2}, "image_worker", tcfg, EngineConfig(**ecfg, tp=2),
        _numpy(params_from_jax(jp, tcfg, "cpu")), tower, bodies)[0]
    assert texts == want
    assert spliced == 2 * 16
    assert [c["broadcast_tensor"] for c in collectives] == [2, 2]
    assert deltas[0] == deltas[1] and any(deltas[0])


# ---------------------------------------------------------------------------
# The decode pipeline at tp = 2
# ---------------------------------------------------------------------------

PIPE_ENGINE = dict(page_size=32, num_pages=32, max_model_len=128,
                   max_batch_size=4, max_prefill_tokens=32,
                   prefill_buckets=(8, 16), decode_steps=4)
PIPE_PROMPTS = {"greedy": [3, 8, 1, 9], "stops": [(i * 5 + 1) % 90
                                                  for i in range(11)],
                "seeded": [7, 7, 2], "sampled": [11, 4, 6, 2, 9]}


def _pipe_requests(stop: int):
    """(rid, prompt, sampling kwargs): a greedy row, a greedy row that
    stops at ``stop`` (inside a burst), a seeded row and an unseeded
    sampled row."""
    return [("greedy", PIPE_PROMPTS["greedy"],
             dict(max_tokens=24, temperature=0.0, ignore_eos=True)),
            ("stops", PIPE_PROMPTS["stops"],
             dict(max_tokens=24, temperature=0.0, stop_token_ids=[stop])),
            ("seeded", PIPE_PROMPTS["seeded"],
             dict(max_tokens=24, temperature=0.8, seed=7, ignore_eos=True)),
            ("sampled", PIPE_PROMPTS["sampled"],
             dict(max_tokens=24, temperature=0.9, ignore_eos=True))]


def test_tp2_decode_pipeline_matches_jax_with_rollbacks(pool, models):
    jcfg, tcfg, jp, params = models["tiny"]
    # The stop: the 7th greedy token of "stops" (new in its stream), so
    # that its request finishes inside the second burst.
    ref = Engine(tcfg, EngineConfig(**PIPE_ENGINE, decode_pipeline=False),
                 params=params_from_jax(jp, tcfg, "cpu"), device="cpu")
    ref.add_request(EngineRequest("s", PIPE_PROMPTS["stops"], SamplingParams(
        max_tokens=24, temperature=0.0, ignore_eos=True)))
    stream = []
    while ref.has_work():
        for o in ref.step():
            stream.extend(o.new_token_ids)
    at = next(i for i in range(6, 24) if stream[i] not in stream[:i])
    reqs = _pipe_requests(stream[at])
    got = {}
    for on in (True, False):
        got[on] = pool.run({"tp": 2}, "pipeline_engine", tcfg,
                           EngineConfig(**PIPE_ENGINE, tp=2,
                                        decode_pipeline=on),
                           params, reqs)[0]
    (on_toks, on_m, on_state), (off_toks, off_m, _) = got[True], got[False]
    assert on_toks == off_toks
    assert on_toks["stops"] == stream[:at + 1]
    assert on_m["spec_dispatches"] > 0 and on_m["spec_rollbacks"] > 0
    assert off_m["spec_dispatches"] == 0
    # After the rollbacks both ranks' samplers and carries are one.
    assert on_state[0] == on_state[1]
    # The JAX engine at tp = 2 (its pipeline on): the greedy and seeded
    # rows' streams.
    jeng = JaxEngine(jcfg, JaxEngineConfig(**PIPE_ENGINE, tp=2),
                     params=jax.tree_util.tree_map(jnp.asarray, jp),
                     mesh=jax_make_mesh(JaxMeshSpec(tp=2)))
    for rid, prompt, kw in reqs:
        jeng.add_request(JaxRequest(rid, list(prompt),
                                    sampling=JaxSampling(**kw)))
    want = {rid: [] for rid, _, _ in reqs}
    while jeng.has_work():
        for o in jeng.step():
            want[o.request_id].extend(o.new_token_ids)
    for rid in ("greedy", "stops", "seeded"):
        assert on_toks[rid] == want[rid], rid
