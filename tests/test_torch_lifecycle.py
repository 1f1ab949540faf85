"""The port worker's lifecycle plane against the JAX worker's, on the CPU.

Workers of both packages serve the same tiny float32 weights (the JAX
engine's ``init_params(cfg, PRNGKey(0))``, carried into the port by
``params_from_jax``) behind the JAX package's ``StoreServer`` and master
(``Cluster`` of ``tests/test_torch_cluster.py``), so texts at temperature
0 must be equal. Pinned here:

- F5: every catalog failpoint the JAX worker fires (``worker.
  crash_heartbeat``, ``store.fail_rpc``, ``store.hang``,
  ``store.partition``, ``worker.die_after_n_tokens``,
  ``worker.fail_encode``, ``worker.hang_encode``) armed through
  ``POST /admin/failpoint`` on a port worker and on a JAX worker, with
  the same effect and the same trip count;
- ``drain_and_stop`` in the relay and the RPC topology
  (``tests/test_e2e.py:434``, ``:494``), with ``/wakeup`` refused 409
  during the drain;
- sleep and wake through the master's ``/model/triggers``
  (``tests/test_e2e.py:568``): parameters bit-equal after the warm wake,
  texts equal to the port's own before the sleep and to the JAX
  worker's; a request in flight at the sleep ends with a 503 (the JAX
  worker leaves it to its timeout: a known difference);
- ``/fork_master``, ``/sleep``, ``/wakeup``, ``/v1/models`` and a
  generate on a sleeping model answer as the JAX worker's do, status and
  body; the registration carries the awake models and
  ``memory_budget_gb``, the beat every model's state;
- the master's serverless allocator (``tests/test_service.py:268``)
  stages, evicts and wakes models on a port worker as on a JAX worker;
- ``worker.die_after_n_tokens`` mid-stream on a port worker beside a JAX
  peer: the master resumes the streams with the uninterrupted text.
"""

import json
import threading
import time

import pytest
import torch

from xllm_service_tpu.config import (EngineConfig as JaxEngineConfig,
                                     InstanceType as JaxInstanceType,
                                     LoadBalancePolicyType, ServiceOptions)
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service.coordination import \
    InMemoryStore as JaxInMemoryStore
from xllm_service_tpu.service.coordination_net import StoreServer
from xllm_service_tpu.service.httpd import (http_json, http_stream,
                                            iter_sse_events)
from xllm_service_tpu.service.master import Master
from xllm_service_tpu.utils import threads as jax_threads
from xllm_service_tpu_torch.config import EngineConfig
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.utils import threads

from tests.test_torch_cluster import (  # noqa: F401 — a fixture
    ENGINE, HB_S, MODEL, REQUESTS, Cluster, assert_same, generate, models,
    wait_until)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

THREADS = {"torch": threads, "jax": jax_threads}
LONG = {"model": MODEL, "prompt": "drain me", "max_tokens": 60,
        "temperature": 0.0, "ignore_eos": True}


def _add(cluster, models, pkg):
    return (cluster.add_torch_worker(models) if pkg == "torch"
            else cluster.add_jax_worker())


def _add_lasting(cluster, models, pkg, lease_ttl_s=3.0):
    """A worker of ``pkg`` on a lease that outlasts a loaded CPU's
    scheduling gaps (12 beats): the test follows one registration."""
    if pkg == "torch":
        return cluster.add_torch_worker(models, lease_ttl_s=lease_ttl_s)
    w = jax_worker.Worker(
        jax_worker.WorkerOptions(
            port=0, instance_type=JaxInstanceType.DEFAULT,
            service_addr=cluster.master.rpc_address, model=MODEL,
            heartbeat_interval_s=HB_S, lease_ttl_s=lease_ttl_s),
        cluster.server.store, engine_cfg=JaxEngineConfig(**ENGINE)).start()
    cluster.workers.append(w)
    assert wait_until(lambda: w.name in cluster.listed())
    return w


def _stream(addr, body, out):
    """A streamed completion through ``addr``: its text, whether it ended
    in [DONE], the error frames and any transport error, into ``out``."""
    out.update(text="", done=False, errors=[], exc=None)
    try:
        for payload in iter_sse_events(http_stream(
                "POST", addr, "/v1/completions", dict(body, stream=True),
                timeout=120.0)):
            if payload == "[DONE]":
                out["done"] = True
                break
            obj = json.loads(payload)
            if "error" in obj:
                out["errors"].append(obj["error"])
            for ch in obj.get("choices") or []:
                out["text"] += ch.get("text", "")
    except Exception as e:  # noqa: BLE001 — the failure mode under test
        out["exc"] = f"{type(e).__name__}: {e}"
    return out


def _text(cluster, body=LONG):
    status, resp = http_json("POST", cluster.master.http_address,
                             "/v1/completions", body, timeout=120.0)
    assert status == 200, resp
    return resp["choices"][0]["text"]


@pytest.fixture(scope="module")
def jax_ref(models):
    """A JAX worker behind its own master: the reference texts."""
    c = Cluster()
    c.add_jax_worker()
    yield c
    c.close()


# ---------------------------------------------------------------------------
# F5: the catalog's failpoints fire on a port worker as on a JAX worker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f5_clusters(models):
    out = {}
    for pkg in ("torch", "jax"):
        c = Cluster()
        _add(c, models, pkg)
        out[pkg] = c
    yield out
    for c in out.values():
        c.close()


def _arm(w, name, mode, n=0, value=None):
    status, resp = http_json("POST", w.name, "/admin/failpoint",
                             {"name": name, "mode": mode, "n": n,
                              "value": value})
    assert status == 200, resp


def _trips(w, name):
    status, state = http_json("GET", w.name, "/admin/failpoints")
    assert status == 200
    return state["trips"].get(name, 0)


def _f5_store_case(c, pkg, name):
    """Arm one store or heartbeat failpoint on the cluster's worker and
    observe what it did."""
    w = c.workers[0]
    lease0, outages0 = w._lease_id, w.store.outages_opened
    ev0 = max([e["seq"] for e in w.events.since(0)] or [0])
    if name == "worker.crash_heartbeat":
        book = THREADS[pkg]
        before = book.crash_counts().get("worker.hb_loop", 0)
        _arm(w, name, "count", 1)
        assert wait_until(lambda: book.crash_counts().get(
            "worker.hb_loop", 0) == before + 1, 10.0)
        time.sleep(4 * HB_S)
    elif name == "store.fail_rpc":
        # One failed keepalive: 0.5 s without one, inside the 0.75 s
        # lease.
        _arm(w, name, "count", 1)
        assert wait_until(lambda: _trips(w, name) == 1, 10.0)
    elif name == "store.hang":
        _arm(w, name, "count", 1, 0.05)
        assert wait_until(lambda: _trips(w, name) == 1, 10.0)
    else:                                   # store.partition
        _arm(w, name, "count", 3)
        assert wait_until(lambda: w.store.outages_opened == outages0 + 1,
                          10.0)
        assert wait_until(lambda: w._lease_id != lease0, 10.0)
    assert wait_until(lambda: w.store.health == 2, 10.0)
    assert wait_until(lambda: w.name in c.listed(), 10.0)
    types = [(e["type"], e["attrs"].get("root"), e["attrs"].get("restarting"))
             for e in w.events.since(ev0)]
    return {"trips": _trips(w, name),
            "events": types,
            "outages": w.store.outages_opened - outages0,
            # A heal re-registers on a fresh lease.
            "fresh_lease": (w._lease_id != lease0
                            if name == "store.partition" else None),
            "listed": w.name in c.listed(),
            "serves": _text(c, dict(LONG, max_tokens=4)) is not None}


def _die_case(models, pkg):
    """The armed worker (first) beside a JAX peer: after 6 tokens it dies
    mid-stream; the master resumes the stream on the peer."""
    c = Cluster()
    try:
        w = _add(c, models, pkg)
        c.add_jax_worker()
        body = dict(LONG, max_tokens=24)
        base = _text(c, body)
        _arm(w, "worker.die_after_n_tokens", "after", 6)
        outs = [{} for _ in range(4)]
        ts = [threading.Thread(target=_stream,
                               args=(c.master.http_address, body, o))
              for o in outs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert wait_until(lambda: w.name not in c.listed(), 20.0)
        return {"trips": _trips(w, "worker.die_after_n_tokens"),
                "dead": w._dead,
                "streams": [(o["done"], o["text"] == base, o["errors"],
                             o["exc"]) for o in outs],
                "left_list": w.name not in c.listed()}
    finally:
        c.close()


def _f5_encode_case(c, name):
    """Arm an encode site once on the cluster's worker and ask it to
    encode: a failed ask's status and message, a hung one's delay."""
    w = c.workers[0]
    _arm(w, name, "count", 1, 0.3 if name == "worker.hang_encode" else None)
    t0 = time.monotonic()
    status, resp = http_json("POST", w.name, "/encode",
                             {"images": ["random:1"]}, timeout=60.0)
    held = time.monotonic() - t0
    again, _ = http_json("POST", w.name, "/encode", {"images": ["random:1"]},
                         timeout=60.0)
    return {"trips": _trips(w, name), "status": status,
            "error": (resp or {}).get("error") if status != 200 else None,
            "held": held >= 0.3, "again": again}


F5_NAMES = ("worker.crash_heartbeat", "store.fail_rpc", "store.hang",
            "store.partition", "worker.die_after_n_tokens",
            "worker.fail_encode", "worker.hang_encode")


@pytest.mark.parametrize("name", F5_NAMES)
def test_f5_every_catalog_failpoint_fires_as_on_jax(models, f5_clusters,
                                                    name):
    if name == "worker.die_after_n_tokens":
        mine, ref = _die_case(models, "torch"), _die_case(models, "jax")
        assert mine["trips"] == 1 and mine["dead"] and mine["left_list"]
        assert all(s == (True, True, [], None) for s in mine["streams"])
    elif name.endswith("_encode"):
        mine = _f5_encode_case(f5_clusters["torch"], name)
        ref = _f5_encode_case(f5_clusters["jax"], name)
        assert mine["trips"] == 1 and mine["again"] == 200
        assert mine["status"] == (500 if name == "worker.fail_encode"
                                  else 200)
        assert mine["held"] == (name == "worker.hang_encode")
    else:
        mine = _f5_store_case(f5_clusters["torch"], "torch", name)
        ref = _f5_store_case(f5_clusters["jax"], "jax", name)
        assert mine["trips"] == {"worker.crash_heartbeat": 1,
                                 "store.fail_rpc": 1, "store.hang": 1,
                                 "store.partition": 3}[name]
        assert mine["listed"] and mine["serves"]
    assert mine == ref


# ---------------------------------------------------------------------------
# Drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["relay", "rpc"])
def test_drain_finishes_inflight_stream(models, jax_ref, topology):
    """tests/test_e2e.py:434 and :494 on a port worker: the stream in
    flight at the drain ends in [DONE] with the greedy text (the JAX
    worker's), a /wakeup during the drain is a 409, the worker leaves
    the master's list, a late request gets a 503, stop() again is a
    no-op."""
    c = Cluster(rpc_topology=topology == "rpc")
    try:
        w = c.add_torch_worker(models)
        if topology == "rpc":
            assert wait_until(lambda: w._decode_to_service, 10.0)
        want = _text(jax_ref)
        assert _text(c) == want
        out = {}
        reader = threading.Thread(target=_stream,
                                  args=(c.master.http_address, LONG, out))
        reader.start()
        assert wait_until(lambda: w.engine.has_work(), 10.0)
        drained = []
        drainer = threading.Thread(
            target=lambda: drained.append(w.drain_and_stop(30.0)))
        drainer.start()
        assert wait_until(lambda: w._draining, 5.0)
        status, resp = http_json("POST", w.name, "/wakeup",
                                 {"model": MODEL})
        assert (status, resp["error"]["type"]) == (409, "unavailable")
        drainer.join(40)
        reader.join(40)
        assert drained == [True]
        assert out["done"] and out["text"] == want and not out["errors"]
        assert wait_until(lambda: w.name not in c.listed(), 10.0)
        status, _ = http_json("POST", c.master.http_address,
                              "/v1/completions",
                              {"model": MODEL, "prompt": "late",
                               "max_tokens": 1}, timeout=30.0)
        assert status == 503
        w.stop()                          # idempotent after the drain
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Sleep and wake
# ---------------------------------------------------------------------------

def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def test_sleep_and_wake_through_model_triggers(models, jax_ref):
    """tests/test_e2e.py:568 on a port worker: asleep through the master
    (no engine, the master's row and the beat say asleep), awake again
    with the carried parameters bit for bit and the texts of before the
    sleep, which are the JAX worker's."""
    _, tcfg, jparams = models
    carried = _flat(params_from_jax(jparams, tcfg, "cpu"))
    c = Cluster()
    try:
        w = c.add_torch_worker(models)
        before = {k: generate(c, *REQUESTS[k], stream=True)
                  for k in sorted(REQUESTS)}
        status, resp = http_json("POST", c.master.http_address,
                                 "/model/triggers",
                                 {"model": MODEL, "action": "sleep"},
                                 timeout=60.0)
        assert status == 200, resp
        rt = w.primary_runtime()
        assert rt.state == "asleep" and rt.engine is None
        assert rt.timings["param_bytes"] == sum(
            t.numel() * t.element_size() for t in carried.values())
        # The master's books follow the trigger and the beats after it.
        mgr = c.master.scheduler.instance_mgr
        assert wait_until(lambda: (mgr.get(w.name) is not None and mgr.get(
            w.name).model_states.get(MODEL) == "asleep"), 5.0)
        hb = w._build_heartbeat()[0]
        assert hb.model_states == {MODEL: "asleep"}
        assert hb.load.running_requests == 0 and not hb.cache_stored
        status, resp = http_json("POST", c.master.http_address,
                                 "/model/triggers",
                                 {"model": MODEL, "action": "wakeup"},
                                 timeout=120.0)
        assert status == 200, resp
        assert rt.state == "awake" and rt.engine is not None
        woke = _flat(rt.engine.params)
        assert woke.keys() == carried.keys()
        for k, t in carried.items():
            assert woke[k].dtype == t.dtype and torch.equal(woke[k], t), k
        for k in sorted(REQUESTS):
            after = generate(c, *REQUESTS[k], stream=True)
            assert_same(after, before[k])
            assert_same(after, generate(jax_ref, *REQUESTS[k], stream=True))
    finally:
        c.close()


def test_sleep_ends_requests_in_flight_with_a_503(models):
    """A request in flight at its model's sleep: the JAX worker drops the
    engine and leaves the request to its timeout (``_serve_sleep`` +
    ``ModelRuntime.sleep``, JAX worker :2469, :275); the port ends it at
    once with a typed 503 (ROADMAP, Known differences)."""
    c = Cluster()
    try:
        w = c.add_torch_worker(models)
        out = {}
        reader = threading.Thread(target=_stream,
                                  args=(w.name, dict(LONG, max_tokens=200),
                                        out))
        reader.start()
        assert wait_until(lambda: w.engine.has_work(), 10.0)
        status, resp = http_json("POST", w.name, "/sleep", {"model": MODEL})
        assert status == 200 and resp["state"] == "asleep"
        reader.join(30)
        assert not reader.is_alive()
        assert out["errors"] == [{"message": f"model {MODEL} was put to "
                                             f"sleep",
                                  "type": "unavailable", "code": 503}]
        assert not out["done"] and not w._live_srid
    finally:
        c.close()


def _jax_standalone():
    return jax_worker.Worker(
        jax_worker.WorkerOptions(port=0, model=MODEL,
                                 instance_type=JaxInstanceType.DEFAULT),
        JaxInMemoryStore(sweep_interval_s=0.05),
        engine_cfg=JaxEngineConfig(**ENGINE)).start()


ROUTE_STEPS = (
    ("GET", "/v1/models", None),
    ("POST", "/fork_master", {"models": ["tiny-b", MODEL]}),
    ("POST", "/fork_master", {"models": ["tiny-b"]}),
    ("POST", "/fork_master", {"models": ["no-such-model"]}),
    ("GET", "/v1/models", None),
    ("POST", "/sleep", {"model": "no-such-model"}),
    ("POST", "/wakeup", {"model": "no-such-model"}),
    ("POST", "/sleep", {"model": MODEL}),
    ("POST", "/sleep", {"model": MODEL}),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "hi",
                                 "max_tokens": 2}),
    ("GET", "/v1/models", None),
    ("POST", "/wakeup", {"model": "tiny-b"}),
    ("POST", "/wakeup", {"model": MODEL}),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "hi",
                                 "max_tokens": 3, "temperature": 0.0,
                                 "ignore_eos": True}),
    ("GET", "/v1/models", None),
)


def _route_answers(w):
    answers = []
    for method, path, body in ROUTE_STEPS:
        status, resp = http_json(method, w.name, path, body, timeout=60.0)
        if path == "/v1/completions" and status == 200:
            resp = (resp["choices"][0]["text"], resp["usage"])
        if path == "/fork_master" and status == 400:
            # The message lists each package's model registry.
            resp["error"]["message"] = \
                resp["error"]["message"].split(";")[0]
        answers.append((path, status, resp))
    return answers


def test_lifecycle_routes_answer_as_jax(models):
    """``/fork_master``, ``/sleep``, ``/wakeup``, ``/v1/models`` and a
    generate on a sleeping model: the JAX worker's status codes and
    bodies, step by step; then the registration and the beat of a
    worker with a model staged asleep."""
    jcfg, tcfg, jparams = models
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_worker._MODEL_REGISTRY, "tiny-b", lambda: jcfg)
    mp.setitem(torch_worker._MODEL_REGISTRY, "tiny-b", lambda: tcfg)
    tw = torch_worker.Worker(
        torch_worker.WorkerOptions(model=MODEL, device="cpu"),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu")).start()
    jw = _jax_standalone()
    try:
        mine, ref = _route_answers(tw), _route_answers(jw)
        for a, b in zip(mine, ref):
            assert a == b
        assert [a[1] for a in mine] == [200, 200, 200, 400, 200, 404, 404,
                                        200, 200, 400, 200, 200, 200, 200,
                                        200]
    finally:
        tw.stop()
        jw.stop()
        mp.undo()
    c = Cluster()
    try:
        mp = pytest.MonkeyPatch()
        mp.setitem(torch_worker._MODEL_REGISTRY, "tiny-b", lambda: tcfg)
        w = c.add_torch_worker(models, memory_budget_gb=42.0)
        status, _ = http_json("POST", w.name, "/fork_master",
                              {"models": ["tiny-b"]})
        assert status == 200
        assert w._build_heartbeat()[0].model_states == {
            MODEL: "awake", "tiny-b": "asleep"}
        mgr = c.master.scheduler.instance_mgr
        assert wait_until(lambda: mgr.get(w.name).model_states == {
            MODEL: "awake", "tiny-b": "asleep"}, 5.0)
        w._register()
        rec = c.server.store.get_json(f"XLLM:DEFAULT:{w.name}")
        # The awake models only.
        assert rec["models"] == [MODEL] and rec["memory_budget_gb"] == 42.0
        mp.undo()
    finally:
        c.close()


# ---------------------------------------------------------------------------
# The master's serverless allocator
# ---------------------------------------------------------------------------

MEMORY = {MODEL: 30.0, "cold1": 20.0, "cold2": 25.0, "big": 40.0}
# The master's staging of a worker's serverless models (JAX
# service/instance_mgr.py:449-470), then two wakes: cold1 fits beside the
# hot model; cold2 does not, and the coldest awake model (cold1) sleeps.


def _serverless_run(models, pkg):
    """tests/test_service.py:268 with a real master and worker of
    ``pkg``: the master forks and stages the cold models, two wakes
    evict the coldest, and the hot model's text is served throughout."""
    server = StoreServer().start()
    master = Master(ServiceOptions(
        http_port=0, rpc_port=0, num_output_pools=4,
        load_balance_policy=LoadBalancePolicyType.ROUND_ROBIN,
        block_size=ENGINE["page_size"], heartbeat_interval_s=HB_S,
        master_upload_interval_s=HB_S), store=server.store,
        model_memory_gb=MEMORY, serverless_models=list(MEMORY)).start()
    c = Cluster.__new__(Cluster)
    c.server, c.master, c.workers = server, master, []
    try:
        w = _add_lasting(c, models, pkg)
        mgr = master.scheduler.instance_mgr
        states = []

        def snap():
            inst = mgr.get(w.name).model_states
            worker_side = {m: rt.state for m, rt in w.runtimes.items()}
            states.append((dict(inst), worker_side))
        assert wait_until(lambda: len(mgr.get(w.name).model_states) == 4,
                          10.0)
        snap()
        hot = _text(c, dict(LONG, max_tokens=8))
        mgr.update_model_heat(MODEL)
        mgr.update_model_heat(MODEL)
        assert mgr.allocate_instance_for_model("cold1") == w.name
        snap()
        assert mgr.allocate_instance_for_model("cold2") == w.name
        snap()
        # A request for the cold model the allocator woke: served there.
        status, resp = http_json("POST", master.http_address,
                                 "/v1/completions",
                                 dict(LONG, model="cold2", max_tokens=4),
                                 timeout=120.0)
        assert _text(c, dict(LONG, max_tokens=8)) == hot
        snap()
        return {"states": states, "hot": hot,
                "cold2": (status, resp["usage"]["completion_tokens"])}
    finally:
        c.close()


def test_serverless_allocation_with_eviction(models):
    jcfg, tcfg, _ = models
    mp = pytest.MonkeyPatch()
    for name in ("cold1", "cold2", "big"):
        mp.setitem(jax_worker._MODEL_REGISTRY, name, lambda: jcfg)
        mp.setitem(torch_worker._MODEL_REGISTRY, name, lambda: tcfg)
    try:
        mine = _serverless_run(models, "torch")
        ref = _serverless_run(models, "jax")
    finally:
        mp.undo()
    assert mine == ref
    A, S = "awake", "asleep"
    assert [s[0] for s in mine["states"]] == [
        {MODEL: A, "cold1": S, "cold2": S, "big": S},
        {MODEL: A, "cold1": A, "cold2": S, "big": S},
        {MODEL: A, "cold1": S, "cold2": A, "big": S},
        {MODEL: A, "cold1": S, "cold2": A, "big": S}]
    assert all(master_side == worker_side
               for master_side, worker_side in mine["states"])


# ---------------------------------------------------------------------------
# The simulated death, mid-stream, beside a JAX peer
# ---------------------------------------------------------------------------

def test_die_after_n_tokens_resumes_on_a_jax_peer(models, jax_ref):
    """tests/test_failpoints.py's relay recovery with the port worker as
    the one that dies, armed through the master's admin proxy: every
    stream ends in [DONE] with the uninterrupted greedy text (the JAX
    worker's), the master counts a recovery, the port worker is dead and
    leaves the list."""
    c = Cluster()
    try:
        w = c.add_torch_worker(models)
        peer = c.add_jax_worker()
        body = dict(LONG, max_tokens=24)
        want = _text(jax_ref, body)
        status, resp = http_json(
            "POST", c.master.http_address, "/admin/failpoint",
            {"instance": w.name, "name": "worker.die_after_n_tokens",
             "mode": "after", "n": 6}, timeout=10.0)
        assert status == 200, resp
        outs = [{} for _ in range(4)]
        ts = [threading.Thread(target=_stream,
                               args=(c.master.http_address, body, o))
              for o in outs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert w._dead and w.failpoints.trips(
            "worker.die_after_n_tokens") == 1
        for o in outs:
            assert (o["done"], o["text"], o["errors"], o["exc"]) == \
                (True, want, [], None), o
        status, ev = http_json("GET", c.master.http_address,
                               "/admin/events?limit=512")
        rec = [e for e in ev["events"] if e["type"] == "request_recovered"]
        assert rec and rec[0]["attrs"]["to"] == peer.name
        assert wait_until(lambda: w.name not in c.listed(), 20.0)
    finally:
        c.close()
