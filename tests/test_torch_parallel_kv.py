"""The sharded worker's KV plane and step fault boundary against the JAX
package's, on the CPU.

The port's ranks are processes of one module-wide pool
(``tests/torch_rank_pool.py``, gloo over a ``FileStore``); rank 0 runs a
script of engine calls (``run_kv_script``) that the test also runs on an
unsharded port engine and on a JAX engine with the same float32 weights.
A sharded forward sums its float32 partial products in another order
than the unsharded one, so its KV differs from an unsharded engine's in
the last bits (within ``NEAR``); what must hold bit for bit is the mover:
every full-head block rank 0 hands out is the ranks' own pool shares
joined in head order, and every block it takes in lands in each rank's
pools as its slice of the block. Cases:

- (a) the PD export (``export_held``) at tp = 2 (KV heads split), tp = 4
  (``tiny``'s two KV heads replicated) and a tiny DeepSeek at ep = 2
  (the MLA latent), within 2e-4 of the JAX engine's (under a tp = 2 JAX
  mesh for tp = 2, unsharded otherwise);
- (b) the PD round trip both ways between a tp = 2 engine and a JAX
  engine, streams equal to the JAX engine's whole stream;
- (c) the block fetch both ways (``export_blocks`` / ``adopt_blocks``),
  also a run that the holder's host tier holds;
- (d) the host spill tier at tp = 2 under spilling pressure: the stream
  equals the JAX engine's, the tier's blocks are the gathered pool bits;
- (e) a share-shaped import payload refused, as the JAX engine refuses a
  layout mismatch;
- (f) a tp = 2 port PREFILL worker handing off to a JAX DECODE worker
  behind the port's master: the texts of a JAX PD pair;
- (g) containment at tp = 2: ``worker.fault_step_req`` fails only its
  request, with the JAX worker's body; a raise in rank 0's sharded MLP
  and one on rank 1 alone re-form the world (epoch 1), the follower
  lives, the next request is served.
"""

import dataclasses
import json
import os
import threading
import time
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import InstanceType as JaxInstanceType
from xllm_service_tpu.config import ModelConfig as JaxModelConfig
from xllm_service_tpu.models import transformer as jtf
from xllm_service_tpu.parallel import mesh as jmesh
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.runtime.engine import Engine as JaxEngine
from xllm_service_tpu.runtime.engine import EngineRequest as JaxRequest
from xllm_service_tpu.service.coordination import InMemoryStore
from xllm_service_tpu.utils.types import SamplingParams as JaxSampling
from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig, ServiceOptions)
from xllm_service_tpu_torch.models import transformer as ttf
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.runtime.engine import Engine
from xllm_service_tpu_torch.service import coordination_net
from xllm_service_tpu_torch.service.master import Master

from tests.test_torch_cluster import jax_compile_cache  # noqa: F401
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401
from tests.test_torch_parallel import MODELS
from tests.torch_rank_pool import RankPool, run_kv_script

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

TOL = dict(rtol=2e-4, atol=2e-4)
# A sharded forward's KV against the unsharded forward's.
NEAR = dict(rtol=1e-5, atol=1e-5)
ENGINE = dict(page_size=4, num_pages=32, max_model_len=64,
              max_batch_size=4, max_prefill_tokens=16,
              prefill_buckets=(8, 16), decode_steps=1,
              enable_prefix_cache=True)
# A 16-page pool of 16-token pages with a host tier: FILLER reclaims
# (and spills) P1's pages, P1 again restores them.
SPILL = dict(page_size=16, num_pages=16, max_model_len=256,
             max_batch_size=2, max_prefill_tokens=256,
             prefill_buckets=(32, 64, 128), decode_steps=1,
             enable_prefix_cache=True, kv_spill_mb=64.0)
P1 = [7] * 5 + list(range(40))
FILLER = list(range(30, 128)) + list(range(3, 128))[:132]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def weights():
    """Per model: the JAX and port configs and weights (JAX's
    ``init_params`` at key 0), the port's also as numpy for the pool."""
    out = {}
    for name, model in (("tiny", "tiny"), ("mla", "v2_lite")):
        jcfg = JaxModelConfig(**MODELS[model])
        tcfg = ModelConfig(**MODELS[model])
        jparams = jax.tree_util.tree_map(
            np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        tparams = params_from_jax(jparams, tcfg, "cpu")
        out[name] = (jcfg, tcfg, jparams, tparams, _numpy(tparams))
    return out


def _jax_engine(weights, model, spec=None, **kw):
    jcfg, _, jparams, _, _ = weights[model]
    ecfg = {**ENGINE, **kw}
    if not spec:
        return JaxEngine(jcfg, JaxEngineConfig(**ecfg), params=jparams)
    return JaxEngine(jcfg, JaxEngineConfig(**ecfg, **spec), params=jparams,
                     mesh=jmesh.make_mesh(jmesh.MeshSpec(**spec)))


def _jax(eng, script):
    return run_kv_script(eng, script, JaxRequest, JaxSampling)


def _port(weights, model, script, **kw):
    _, tcfg, _, tparams, _ = weights[model]
    eng = Engine(tcfg, EngineConfig(**{**ENGINE, **kw}), params=tparams,
                 device="cpu")
    return run_kv_script(eng, script)


def _sharded(pool, weights, model, spec, script, **kw):
    """Rank 0's results, and every rank's pools (numpy, rank order)."""
    _, tcfg, _, _, nparams = weights[model]
    res = pool.run(spec, "kv_engine", tcfg, EngineConfig(**{**ENGINE, **kw}),
                   nparams, script)
    out, pools0, _ = res[0]
    return out, [pools0] + res[1:]


# Per case, each rank's copy of its KV heads: the rank whose pools the
# export reads them from (written out here, not read from the port's
# sharding rules). tp = 4 replicates tiny's two KV heads over pairs of
# ranks; the MLA latent is on every rank.
HEAD_OWNER = {"tp2": [0, 1], "tp4": [0, 0, 2, 2], "mla_ep2": [0, 0]}


def _owners(case):
    """The ranks the export joins, in head order."""
    return sorted(set(HEAD_OWNER[case]))


def _joined(pools, owners, pages):
    """The full-head (k, v) of ``pages`` from the ranks' pool shares."""
    return tuple(np.concatenate([pools[r][i][:, pages] for r in owners],
                                axis=3) for i in range(2))


def _prompts(n, seed=3, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=k).tolist()
            for k in (13, 9, 11, 6)[:n]]


# ---------------------------------------------------------------------------
# (a) the PD export
# ---------------------------------------------------------------------------

EXPORT_CASES = {"tp2": ("tiny", dict(tp=2)), "tp4": ("tiny", dict(tp=4)),
                "mla_ep2": ("mla", dict(ep=2))}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_pd_export_matches_jax(pool, weights, case):
    """Rank 0's ``export_held`` is every KV head of the held pages: the
    ranks' pool shares joined, bit for bit (replicas equal their head's
    owner), near the unsharded port engine's export and within 2e-4 of
    the JAX engine's; the tokens are the same on all three."""
    model, spec = EXPORT_CASES[case]
    prompts = _prompts(2)
    script = [("hold", f"h{i}", p) for i, p in enumerate(prompts)] + \
        [("export_held", f"h{i}") for i in range(len(prompts))]
    got, pools = _sharded(pool, weights, model, spec, script)
    unsharded = _port(weights, model, script)
    want = _jax(_jax_engine(weights, model,
                            spec if case == "tp2" else None), script)
    owners = _owners(case)
    cfg = weights[model][1]
    for i in range(len(prompts)):
        pages = got[i]
        tokens, k, v = got[len(prompts) + i]
        assert k.shape == (cfg.num_layers, len(pages), ENGINE["page_size"],
                           cfg.kv_cache_heads, cfg.kv_cache_dim)
        jk, jv = _joined(pools, owners, pages)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(v, jv)
        for r, owner in enumerate(HEAD_OWNER[case]):
            # A replica holds its heads' owner's bits.
            for a, b in zip(pools[r], pools[owner]):
                np.testing.assert_array_equal(a[:, pages], b[:, pages])
        assert tokens == unsharded[len(prompts) + i][0]
        assert tokens == want[len(prompts) + i][0]
        np.testing.assert_allclose(k, unsharded[len(prompts) + i][1], **NEAR)
        np.testing.assert_allclose(v, unsharded[len(prompts) + i][2], **NEAR)
        np.testing.assert_allclose(k, want[len(prompts) + i][1], **TOL)
        np.testing.assert_allclose(v, want[len(prompts) + i][2], **TOL)


# ---------------------------------------------------------------------------
# (b) the PD round trip, (e) the import's layout check
# ---------------------------------------------------------------------------

MAX_TOKENS = 8


def _whole(weights, prompts):
    """The JAX engine serving each prompt whole."""
    return _jax(_jax_engine(weights, "tiny"),
                [("serve", f"r{i}", p, MAX_TOKENS)
                 for i, p in enumerate(prompts)])


def test_pd_round_trip_port_to_jax(pool, weights):
    """A tp = 2 prefill's exports imported into a JAX engine decode the
    JAX engine's whole streams."""
    prompts = _prompts(3)
    script = [("hold", f"r{i}", p) for i, p in enumerate(prompts)] + \
        [("export_held", f"r{i}") for i in range(len(prompts))]
    got, _ = _sharded(pool, weights, "tiny", dict(tp=2), script)
    exports = got[len(prompts):]
    imports = [("import", f"r{i}", p, *exports[i], MAX_TOKENS)
               for i, p in enumerate(prompts)]
    out = _jax(_jax_engine(weights, "tiny"), imports + [("drain",)])
    assert out[:-1] == [True] * len(prompts)
    assert [out[-1][f"r{i}"] for i in range(len(prompts))] == \
        _whole(weights, prompts)


def test_pd_round_trip_jax_to_port(pool, weights):
    """A JAX prefill's exports imported into a tp = 2 engine: each rank's
    pools hold its slice of the blocks, bit for bit, and the streams are
    the JAX engine's whole streams."""
    prompts = _prompts(3)
    script = [("hold", f"r{i}", p) for i, p in enumerate(prompts)] + \
        [("export_held", f"r{i}") for i in range(len(prompts))]
    exports = _jax(_jax_engine(weights, "tiny"), script)[len(prompts):]
    imports = [op for i, p in enumerate(prompts) for op in (
        ("import", f"r{i}", p, *exports[i], MAX_TOKENS), ("pages", f"r{i}"))]
    # The pools are read at the end: the imported positions stay as
    # written (decode writes the positions after them).
    got, pools = _sharded(pool, weights, "tiny", dict(tp=2),
                          imports + [("drain",)])
    assert got[0::2][:len(prompts)] == [True] * len(prompts)
    assert [got[-1][f"r{i}"] for i in range(len(prompts))] == \
        _whole(weights, prompts)
    for i in range(len(prompts)):
        tokens, k, v = exports[i]
        pages, n = got[2 * i + 1], len(tokens) - 1
        for kv, block in zip(_joined(pools, _owners("tp2"), pages), (k, v)):
            L, _, ps, H, D = block.shape
            np.testing.assert_array_equal(
                kv.reshape(L, -1, H, D)[:, :n],
                block.reshape(L, -1, H, D)[:, :n])


def test_share_shaped_import_is_refused(pool, weights):
    """A payload of one rank's share of the KV heads is refused at tp = 2
    (False, nothing allocated), as the JAX engine refuses a layout
    mismatch; the full-head payload of the same export is taken."""
    prompt = _prompts(1)[0]
    tokens, k, v = _jax(_jax_engine(weights, "tiny"),
                        [("hold", "r", prompt), ("export_held", "r")])[1]
    share = (k[:, :, :, :1], v[:, :, :, :1])
    script = [("import", "s", prompt, tokens, *share, 4),
              ("import", "f", prompt, tokens, k, v, 4)]
    got, _ = _sharded(pool, weights, "tiny", dict(tp=2), script)
    want = _jax(_jax_engine(weights, "tiny"), script)
    assert got[0] is False and want[0] is False
    assert got[1] is True and want[1] is True


# ---------------------------------------------------------------------------
# (c) the block fetch, (d) the host spill tier
# ---------------------------------------------------------------------------

FETCH = [5 + (i * 7) % 200 for i in range(22)]      # 5 full blocks


def test_block_fetch_port_holder_to_jax(pool, weights):
    """A tp = 2 holder's ``export_blocks`` (its pool shares joined, bit
    for bit) adopted by a JAX requester: its stream on the prompt is its
    own cold one."""
    script = [("serve", "h", FETCH, 4), ("block_pages", FETCH, 5),
              ("export_blocks", FETCH, 5)]
    got, pools = _sharded(pool, weights, "tiny", dict(tp=2), script)
    n, k, v = got[2]
    assert n == 5
    jk, jv = _joined(pools, _owners("tp2"), got[1])
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)
    want = _jax(_jax_engine(weights, "tiny"),
                [("serve", "h", FETCH, 4), ("export_blocks", FETCH, 5)])[1]
    np.testing.assert_allclose(k, want[1], **TOL)
    np.testing.assert_allclose(v, want[2], **TOL)
    cold = _jax(_jax_engine(weights, "tiny"), [("serve", "c", FETCH, 6)])
    req = _jax(_jax_engine(weights, "tiny"),
               [("adopt", FETCH, 0, k, v), ("serve", "c", FETCH, 6),
                ("stats",)])
    assert req[0] == 5 and req[1] == cold[0]
    assert req[2]["fetched_blocks_total"] == 5


def test_block_fetch_jax_holder_to_port(pool, weights):
    """A JAX holder's blocks adopted by a tp = 2 requester: each rank's
    pools hold its slice, bit for bit, the admission hits them, and the
    stream is the JAX engine's cold one."""
    n, k, v = _jax(_jax_engine(weights, "tiny"),
                   [("serve", "h", FETCH, 4),
                    ("export_blocks", FETCH, 5)])[1]
    cold = _jax(_jax_engine(weights, "tiny"), [("serve", "c", FETCH, 6)])
    got, pools = _sharded(
        pool, weights, "tiny", dict(tp=2),
        [("adopt", FETCH, 0, k, v), ("block_pages", FETCH, 5),
         ("serve", "c", FETCH, 6), ("stats",)])
    assert got[0] == n == 5
    jk, jv = _joined(pools, _owners("tp2"), got[1])
    np.testing.assert_array_equal(jk, k)
    np.testing.assert_array_equal(jv, v)
    assert got[2] == cold[0]
    assert got[3]["fetched_blocks_total"] == 5
    assert got[3]["hit_tokens_total"] >= 4 * ENGINE["page_size"]


def test_spill_tier_matches_jax(pool, weights):
    """tp = 2 with a host tier under spilling pressure: the streams (P1,
    FILLER, P1 restored) and the tier's counts equal the JAX engine's;
    the tier holds P1's blocks as the ranks' pools held them before
    FILLER reclaimed them (a first run stopped there), bit for bit, near
    the unsharded port engine's tier; a fetch of P1's blocks, all in the
    tier, returns those bits, within 2e-4 of the JAX holder's; and the
    restored pages hold them again on every rank."""
    before = [("serve", "a", P1, 8), ("block_pages", P1, 2)]
    got0, pools0 = _sharded(pool, weights, "tiny", dict(tp=2), before,
                            **SPILL)
    script = [("serve", "a", P1, 8), ("serve", "b", FILLER, 8),
              ("tier", P1), ("export_blocks", P1, 2), ("stats",),
              ("serve", "c", P1, 8), ("block_pages", P1, 2), ("stats",)]
    got, pools = _sharded(pool, weights, "tiny", dict(tp=2), script,
                          **SPILL)
    want = _jax(_jax_engine(weights, "tiny", **SPILL), script[:2] + [
        ("export_blocks", P1, 2), ("stats",), ("serve", "c", P1, 8),
        ("stats",)])
    unsharded = _port(weights, "tiny", script[:3], **SPILL)
    assert got[0] == want[0] and got[1] == want[1] and got[5] == want[4]
    assert got[4] == want[3] and got[7] == want[5]
    assert got[4]["spilled_pages"] > 0 and got[7]["restored_pages"] > 0
    tier = got[2][:2]
    assert all(b is not None for b in tier)
    spilled = _joined(pools0, _owners("tp2"), got0[1])
    for j, (k, v) in enumerate(tier):
        np.testing.assert_array_equal(k, spilled[0][:, j])
        np.testing.assert_array_equal(v, spilled[1][:, j])
        np.testing.assert_allclose(k, unsharded[2][j][0], **NEAR)
        np.testing.assert_allclose(v, unsharded[2][j][1], **NEAR)
    n, k, v = got[3]
    assert n == 2 == want[2][0]
    np.testing.assert_array_equal(k, np.stack([b[0] for b in tier], 1))
    np.testing.assert_array_equal(v, np.stack([b[1] for b in tier], 1))
    np.testing.assert_allclose(k, want[2][1], **TOL)
    np.testing.assert_allclose(v, want[2][2], **TOL)
    restored = _joined(pools, _owners("tp2"), got[6])
    np.testing.assert_array_equal(restored[0], k)
    np.testing.assert_array_equal(restored[1], v)


# ---------------------------------------------------------------------------
# (f) a tp = 2 PREFILL worker beside a JAX DECODE worker
# ---------------------------------------------------------------------------

HB_S = 0.2
WORKER_ENGINE = dict(page_size=16, num_pages=64, max_model_len=256,
                     max_batch_size=4, max_prefill_tokens=256,
                     prefill_buckets=(32, 64, 128))
TEXTS = ["migrate me at tp two", "the decode side is JAX"]
FAULT_PROMPTS = ["a clean one", "POISON in this prompt", "another clean",
                 "and the last clean one"]


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _complete(addr, prompt, max_tokens=6):
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=120)
    conn.request("POST", "/v1/completions", body=json.dumps(
        {"model": "tiny", "prompt": prompt, "max_tokens": max_tokens,
         "temperature": 0.0, "ignore_eos": True}),
        headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _text(addr, prompt):
    status, body = _complete(addr, prompt)
    assert status == 200, body
    return body["choices"][0]["text"]


@pytest.fixture(scope="module")
def worker_models(weights):
    """The tiny model at vocabulary 512 in both packages (the JAX
    worker's registry entry patched to it), float32."""
    jcfg = dataclasses.replace(JaxModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    tcfg = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                               dtype="float32")
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny", lambda: jcfg)
    yield jcfg, tcfg, params_from_jax(jparams, tcfg, "cpu")
    mp.undo()


def _jax_worker(role, store, service_addr=""):
    return jax_worker.Worker(
        jax_worker.WorkerOptions(
            port=0, instance_type=JaxInstanceType(role),
            service_addr=service_addr, model="tiny",
            heartbeat_interval_s=HB_S, lease_ttl_s=3 * HB_S,
            pd_direct_kv=False, pd_device_wire=False),
        store, engine_cfg=JaxEngineConfig(**WORKER_ENGINE)).start()


def test_tp2_prefill_worker_hands_off_to_jax_decode(worker_models):
    """Behind the port's master (round robin, PD): a JAX PREFILL and a
    JAX DECODE worker answer TEXTS; then a tp = 2 port PREFILL worker
    takes the prefill worker's place, exports its held prefills (gathered
    from its two ranks) to the JAX DECODE worker, and the texts are the
    JAX pair's."""
    _, tcfg, tparams = worker_models
    server = coordination_net.StoreServer().start()
    master = Master(ServiceOptions(
        http_port=0, rpc_port=0, num_output_pools=4,
        load_balance_policy=type(ServiceOptions().load_balance_policy)(
            "RR"),
        block_size=16, heartbeat_interval_s=HB_S,
        master_upload_interval_s=HB_S), store=server.store).start()
    mgr = master.scheduler.instance_mgr
    workers = []
    try:
        jprefill = _jax_worker("PREFILL", server.store, master.rpc_address)
        workers.append(jprefill)
        workers.append(_jax_worker("DECODE", server.store,
                                   master.rpc_address))
        assert _wait(lambda: len(mgr.prefill_instances()) == 1
                     and len(mgr.decode_instances()) == 1)
        want = [_text(master.http_address, p) for p in TEXTS]
        jprefill.stop()
        workers.remove(jprefill)
        assert _wait(lambda: not mgr.prefill_instances())
        port = torch_worker.Worker(
            torch_worker.WorkerOptions(
                model="tiny", device="cpu", warmup=False,
                instance_type=InstanceType.PREFILL,
                store_addr=server.address,
                service_addr=master.rpc_address,
                heartbeat_interval_s=HB_S, pd_direct_kv=False,
                dist_backend="gloo"),
            engine_cfg=EngineConfig(**WORKER_ENGINE, tp=2),
            model_cfg=tcfg, params=tparams).start()
        workers.append(port)
        assert _wait(lambda: list(mgr.prefill_instances()) == [port.name])
        got = [_text(master.http_address, p) for p in TEXTS]
        assert got == want
        # Both handoffs went through the mesh's gather.
        assert port.mesh.counts["gather"] >= len(TEXTS)
        assert port.kv_migration_bytes > 0
    finally:
        for w in workers:
            w.stop()
        master.stop()
        server.stop()


# ---------------------------------------------------------------------------
# (g) the step fault boundary at tp = 2
# ---------------------------------------------------------------------------

def _traffic(addr):
    """FAULT_PROMPTS at once: (status, body) each."""
    out = [None] * len(FAULT_PROMPTS)

    def one(i):
        out[i] = _complete(addr, FAULT_PROMPTS[i])
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(FAULT_PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    return out


@pytest.fixture(scope="module")
def jax_fault_body(worker_models):
    """A JAX worker's answer to the request ``worker.fault_step_req``
    blames."""
    w = _jax_worker("DEFAULT", InMemoryStore())
    try:
        w.failpoints.arm("worker.fault_step_req", mode="always",
                         value="POISON")
        return _complete(w.name, FAULT_PROMPTS[1])
    finally:
        w.stop()


@pytest.fixture(scope="module")
def tp2_worker(worker_models):
    _, tcfg, tparams = worker_models
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(model="tiny", device="cpu", warmup=False,
                                   dist_backend="gloo"),
        engine_cfg=EngineConfig(**WORKER_ENGINE, tp=2), model_cfg=tcfg,
        params=tparams).start()
    yield w
    w.stop()


def _engine_fault_message(body):
    """The blamed request's message without the worker's name."""
    return body["error"]["message"].rsplit(" on ", 1)[0]


def test_fault_step_req_fails_only_its_request(tp2_worker, jax_fault_body):
    """At tp = 2, four requests at once, one marked by
    ``worker.fault_step_req``: only it fails, with the JAX worker's typed
    500 (the fault fires before the section's launch, so the world stays
    in step: epoch 0), and the other three answer as without the
    failpoint."""
    w = tp2_worker
    clean = _traffic(w.name)
    assert all(s == 200 for s, _ in clean), clean
    epoch = w.mesh.epoch
    w.failpoints.arm("worker.fault_step_req", mode="always", value="POISON")
    try:
        faulted = _traffic(w.name)
    finally:
        w.failpoints.disarm("worker.fault_step_req")
    jstatus, jbody = jax_fault_body
    status, body = faulted[1]
    assert status == jstatus == 500, body
    assert body["error"]["type"] == jbody["error"]["type"] == "engine_fault"
    assert body["error"]["code"] == jbody["error"]["code"]
    assert _engine_fault_message(body) == _engine_fault_message(jbody)
    for i in (0, 2, 3):
        assert faulted[i] == (200, faulted[i][1])
        assert faulted[i][1]["choices"] == clean[i][1]["choices"]
    assert w.mesh.epoch == epoch
    assert w._engine_loop_alive and w._rank_procs[0].poll() is None


def test_rank0_mid_forward_raise_is_contained(tp2_worker, monkeypatch):
    """A raise planted in rank 0's MLP, after its follower has joined the
    forward's collectives: the follower's collective fails at once, the
    world re-forms under the next epoch with the same follower process,
    the request in the step gets the typed 500, and the next request is
    served, all within 30 s."""
    w = tp2_worker
    epoch, follower = w.mesh.epoch, w._rank_procs[0]
    mlp = ttf._mlp
    fired = []

    def planted(*args, **kwargs):
        if not fired:
            fired.append(1)
            raise RuntimeError("planted fault in a sharded forward")
        return mlp(*args, **kwargs)
    monkeypatch.setattr(ttf, "_mlp", planted)
    t0 = time.monotonic()
    status, body = _complete(w.name, "the step that faults")
    assert status == 500, body
    assert body["error"]["type"] == "engine_fault"
    assert "planted fault" in body["error"]["message"]
    assert _text(w.name, "the next request")
    assert time.monotonic() - t0 < 30.0
    assert w.mesh.epoch == epoch + 1
    assert follower.poll() is None and w._rank_procs == [follower]
    assert w._engine_loop_alive


def test_follower_raise_is_contained(pool, weights, tmp_path):
    """A raise on rank 1 alone (planted in its MLP by a rank function):
    its peer's collective fails at once, the world re-forms with epoch 1,
    the request in the step gets the typed 500, and the requests before
    and after it are served within 30 s."""
    _, tcfg, _, _, nparams = weights["tiny"]
    ecfg = EngineConfig(**{**ENGINE, "tp": 2})
    flag = str(tmp_path / "fault")
    res = pool.run({"tp": 2}, "worker_fault", tcfg, ecfg, nparams,
                   ["before", "the step that faults", "after"], flag)
    (before, faulted, after), epoch, alive = res[0]
    assert before[0] == 200 and after[0] == 200, (before, after)
    assert faulted[0] == 500 and \
        faulted[1]["error"]["type"] == "engine_fault", faulted
    assert faulted[2] < 30.0 and after[2] < 30.0
    assert epoch == 1 and alive
    assert res[1] > 0 and not os.path.exists(flag)


# ---------------------------------------------------------------------------
# The mesh's moves and its re-formation; the KV head rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_mesh_gather_scatter_agree(pool, tp):
    """Rank 0 gets every rank's tensor in source order, each rank its
    own part, and an agreement is False on every rank when one rank
    says so; each move is counted once on each rank."""
    res = pool.run({"tp": tp}, "mesh_moves")
    got, _, _, _ = res[0]
    assert got == [[[float(r)] * 3] * 2 for r in range(tp)]
    for rank, (g, mine, agreed, counts) in enumerate(res):
        assert (g is None) == (rank != 0)
        assert mine == [[10.0 * rank] * 3] * 2
        assert agreed == (True, False)
        assert counts == {"gather": 1, "scatter": 1, "agree": 2}


@pytest.mark.parametrize("tp", [2, 4])
def test_reform_frees_ranks_blocked_in_a_collective(pool, tp):
    """The blocked-follower case: rank 0 leaves its groups while the
    others wait in an all-reduce. Their gloo pairs see the peer close, so
    each collective fails within seconds (not at ``mesh.TIMEOUT``),
    every rank re-forms under epoch 1, and the new world's all-reduce
    and agreement meet."""
    res = pool.run({"tp": tp}, "reform_blocked")
    want = float(sum(range(1, tp + 1)))
    for rank, (failed, waited, epoch, y, agreed) in enumerate(res):
        assert failed is (None if rank == 0 else True)
        assert waited < 20.0
        assert epoch == 1 and agreed is True
        assert y == [want] * 3


KV_RULE_CASES = {"tiny_tp1": ("tiny", dict(tp=1)),
                 "tiny_tp2": ("tiny", dict(tp=2)),
                 "tiny_tp4": ("tiny", dict(tp=4)),
                 "tiny_dp2_sp2_tp2": ("tiny", dict(dp=2, sp=2, tp=2)),
                 "mla_ep2_tp2": ("v2_lite", dict(ep=2, tp=2))}


@pytest.mark.parametrize("case", sorted(KV_RULE_CASES))
def test_kv_sources_join_the_shards(case):
    """``kv_sources`` names one rank a KV head group, all at dp = ep =
    sp = 0, in head order; joining their ``shard_kv_cache`` shares gives
    the full pools back, and every rank's share is ``kv_share`` of them
    (what a scatter sends it)."""
    from xllm_service_tpu_torch.parallel import mesh as tmesh
    from xllm_service_tpu_torch.parallel import sharding as tsharding
    model, spec = KV_RULE_CASES[case]
    cfg = ModelConfig(**MODELS[model])
    ms = tmesh.MeshSpec(**spec)
    rng = np.random.default_rng(1)
    full = [torch.from_numpy(rng.standard_normal(
        (cfg.num_layers, 3, 4, cfg.kv_cache_heads, cfg.kv_cache_dim))
        .astype(np.float32)) for _ in range(2)]
    shares = {r: tsharding.shard_kv_cache(
        full, tmesh.Mesh(ms, r, "gloo", "cpu", {}), cfg)
        for r in range(ms.num_devices)}
    sources = tsharding.kv_sources(cfg, ms)
    assert sources[0] == 0
    assert all(ms.coords(r)["dp"] == ms.coords(r)["ep"] ==
               ms.coords(r)["sp"] == 0 for r in sources)
    heads = cfg.kv_cache_heads if cfg.mla or ms.tp == 1 else \
        min(ms.tp, cfg.num_kv_heads)
    assert len(sources) == (1 if cfg.mla or ms.tp == 1 else heads)
    for i in range(2):
        joined = tsharding.unshard_kv_cache(
            [shares[r][i] for r in sources], cfg)
        assert torch.equal(joined, full[i])
        for r in range(ms.num_devices):
            assert torch.equal(shares[r][i], tsharding.kv_share(
                full[i], cfg, ms.tp, ms.coords(r)["tp"]))
