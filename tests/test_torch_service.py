"""The port's service plane against the JAX package's, on the CPU, with
no model: every scenario runs through both packages from the same
inputs, and the outcomes must be equal.

- Instance books: the two-phase registration (a registration record is
  pending until the worker's first heartbeat) and the lease's expiry.
- Routing: round robin, cache-aware (with the ``kv_fetch`` plan) and
  SLO-aware decisions for the same registrations, heartbeats and cache
  index, with each decision's audit; the cache index's walk and scores.
- Election: a takeover after the leader's stop, a partitioned master
  that demotes, and ``compare_create`` atomic under the port's
  ``InMemoryStore``, ``RemoteStore`` and ``EtcdStore`` (two masters on
  one store elect one leader, one of each package too).
- The fan-in: each request's outputs reach its callback in the order
  they were handed in.
- Recovery: the relay ledger over a worker death and its resume, and the
  poison ledger's strikes and quarantine.
- Admission at ``max_concurrency`` on the master's front door.
- ``options_from_env`` under the same environment, and ``TimePredictor``
  fits (tolerance 1e-9).
"""

import importlib
import json
import threading
import time
import types

import pytest

from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

MODULES = ("config", "service.coordination", "service.coordination_net",
           "service.etcd_store", "service.httpd", "service.instance_mgr",
           "service.instance_types", "service.kvcache_mgr",
           "service.lb_policy", "service.recovery", "service.scheduler",
           "service.time_predictor", "obs.spans", "obs.metrics",
           "obs.events", "utils.hashing", "utils.misc", "utils.types")


def _package(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace()
    for name in MODULES:
        setattr(ns, name.split(".")[-1],
                importlib.import_module(f"{root}.{name}"))
    return ns


PKGS = {"jax": _package("xllm_service_tpu"),
        "port": _package("xllm_service_tpu_torch")}


def both(scenario):
    """``scenario(pkg)`` for each package; asserts the outcomes equal and
    returns the port's."""
    got = {name: scenario(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def wait_until(cond, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class FakeControl:
    """The master's worker-control transport, recording its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, path, body):
        self.calls.append((address, path, body))
        return 200, {"ok": True}


def _opts(pkg, **kw):
    kw.setdefault("num_output_pools", 4)
    return pkg.config.ServiceOptions(**kw)


def _register(pkg, store, name, itype="PREFILL", ttl=5.0, **meta):
    it = pkg.config.InstanceType(itype)
    info = pkg.instance_types.InstanceMetaInfo(
        name=name, rpc_address=name, instance_type=it, **meta)
    lid = store.lease_grant(ttl)
    store.put_json(pkg.coordination.instance_prefix(itype) + name,
                   info.to_json(), lid)
    return lid


def _beat(pkg, name, itype="PREFILL", **fields):
    return pkg.instance_types.Heartbeat.from_json(
        {"name": name, "instance_type": itype, **fields})


# ---------------------------------------------------------------------------
# Instance books
# ---------------------------------------------------------------------------

def test_two_phase_registration_and_lease_expiry():
    def scenario(pkg):
        store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
        mgr = pkg.instance_mgr.InstanceMgr(_opts(pkg), store,
                                           control=FakeControl())
        seen = []
        try:
            _register(pkg, store, "w1", ttl=0.3)
            assert wait_until(lambda: "w1" in mgr._pending)
            seen.append(("pending", mgr.prefill_instances()))
            seen.append(("beat", mgr.on_heartbeat(_beat(pkg, "w1"))))
            seen.append(("registered", mgr.prefill_instances()))
            assert wait_until(lambda: mgr.prefill_instances() == [])
            seen.append(("expired", mgr.prefill_instances(),
                         mgr.get("w1") is None))
            # A beat from an instance the store no longer lists is refused.
            seen.append(("late beat", mgr.on_heartbeat(_beat(pkg, "w1")),
                         mgr.prefill_instances()))
        finally:
            mgr.close()
            store.close()
        return seen

    assert both(scenario)[2] == ("registered", ["w1"])


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

BLOCK = 4
PROMPTS = [list(range(16)), list(range(16)) + [90, 91],
           list(range(100, 116)), list(range(8)) + [7, 7, 7, 7],
           list(range(16)), [5] * 3]


def _route_run(pkg, policy: str):
    """Three instances registered with profiling data and block hashing;
    heartbeats with load, latency and cache digests; the same requests
    scheduled in order. Returns each decision's routing and audit."""
    store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
    opts = _opts(pkg, load_balance_policy=pkg.config.LoadBalancePolicyType(
        policy), block_size=BLOCK, target_ttft_ms=200.0,
        target_tpot_ms=20.0)
    sched = pkg.scheduler.Scheduler(opts, store, control=FakeControl())
    sched.spans = pkg.spans.SpanStore()
    sched.obs = pkg.metrics.Registry()
    profiles = {
        "p1": dict(ttft_profiling_data=[[n, 20 + 0.9 * n]
                                        for n in (16, 64, 256)]),
        "p2": dict(ttft_profiling_data=[[n, 5 + 0.1 * n]
                                        for n in (16, 64, 256)]),
        "d1": dict(tpot_profiling_data=[[b, t, 4 + 0.5 * b]
                                        for b in (1, 2, 4)
                                        for t in (32, 64)])}
    itypes = {"p1": "PREFILL", "p2": "PREFILL", "d1": "DECODE"}
    try:
        for name, itype in itypes.items():
            _register(pkg, store, name, itype, models=["m"],
                      page_size=BLOCK, kv_block_bytes=4096,
                      **profiles[name])
        assert wait_until(lambda: len(sched.instance_mgr._pending) == 3)
        held = [h.hex() for h in pkg.hashing.prefix_block_hashes(
            list(range(16)), BLOCK)]
        loads = {"p1": dict(waiting_requests=1, kv_cache_usage=0.2),
                 "p2": dict(waiting_requests=9, running_requests=4,
                            kv_cache_usage=0.95),
                 "d1": dict(running_requests=2, kv_cache_usage=0.3)}
        for name, itype in itypes.items():
            sched.handle_instance_heartbeat(_beat(
                pkg, name, itype, load=loads[name],
                latency=dict(prefill_tok_s=8000.0, kv_gbps=2.0),
                cache_stored=held if name == "p2" else []))
        out = []
        for i, ids in enumerate(PROMPTS):
            req = pkg.types.Request(model="m", service_request_id=f"r{i}",
                                    token_ids=list(ids))
            status, routing = sched.schedule(req)
            audit = (sched.spans.get(f"r{i}") or {}).get(
                "attrs", {}).get("schedule_decision")
            out.append((status.ok, routing.to_json(), audit))
        # The in-flight ledger each decision left on the instances.
        metrics = {name: sched.instance_mgr.get(name).req_metrics.to_json()
                   for name in itypes}
        return out, metrics
    finally:
        sched.stop()
        store.close()


@pytest.mark.parametrize("policy", ["RR", "CAR", "SLO_AWARE"])
def test_routes_equal(policy):
    decisions, _ = both(lambda pkg: _route_run(pkg, policy))
    assert all(ok for ok, _, _ in decisions)
    if policy == "RR":
        assert {r["prefill_name"] for _, r, _ in decisions} == {"p1", "p2"}


def test_cache_index_walk_and_scores():
    def scenario(pkg):
        store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
        mgr = pkg.kvcache_mgr.GlobalKVCacheMgr(store, block_size=BLOCK)
        tokens = list(range(32))
        h = pkg.hashing.prefix_block_hashes(tokens, BLOCK)
        out = []
        try:
            mgr.record_updated_kvcaches("a", stored=h[:5])
            mgr.record_updated_kvcaches("b", stored=h[1:4])   # no lead
            mgr.record_updated_kvcaches("c", stored=[h[0], h[2]])  # hole
            mgr.record_updated_kvcaches("d", stored=h[:8])
            out.append(mgr.match(tokens))
            mgr.record_updated_kvcaches("d", offloaded=h[:2])
            mgr.record_updated_kvcaches("a", offloaded_ssd=[h[0]])
            out.append(mgr.match(tokens))
            mgr.record_updated_kvcaches("d", removed=h[4:])
            mgr.remove_instance("c")
            out.append(mgr.match(tokens))
            out.append(mgr.match(tokens[:7]))
        finally:
            store.close()
        return [(m, sorted(s.items())) for m, s in out]

    got = both(scenario)
    assert got[0][0] == 8


# ---------------------------------------------------------------------------
# Election
# ---------------------------------------------------------------------------

def test_election_takeover_and_partitioned_master_demotes():
    def scenario(pkg):
        store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
        kw = dict(heartbeat_interval_s=0.2, master_upload_interval_s=0.1)
        s1 = pkg.scheduler.Scheduler(_opts(pkg, **kw), store,
                                     control=FakeControl())
        s2 = pkg.scheduler.Scheduler(_opts(pkg, **kw), store,
                                     control=FakeControl())
        KEY_MASTER = pkg.coordination.KEY_MASTER
        seen = [("boot", s1.is_master, s2.is_master,
                 store.get(KEY_MASTER) == s1.service_id, s1.epoch)]
        try:
            # s1's partition outlives its lease: the store expires it.
            store.lease_revoke(s1._lease_id)
            assert wait_until(lambda: s2.is_master)
            assert wait_until(lambda: not s1.is_master)
            seen.append(("partition", s1.is_master, s2.is_master,
                         store.get(KEY_MASTER) == s2.service_id, s2.epoch,
                         s1.instance_mgr.is_master))
            s2.stop()
            assert wait_until(lambda: s1.is_master)
            seen.append(("takeover", s1.is_master,
                         store.get(KEY_MASTER) == s1.service_id, s1.epoch,
                         sorted(store.get_prefix(
                             pkg.coordination.KEY_EPOCH_PREFIX))))
        finally:
            s1.stop()
            s2.stop()
            store.close()
        return seen

    got = both(scenario)
    assert got[0] == ("boot", True, False, True, 1)
    assert got[-1][:4] == ("takeover", True, True, 3)


def _store_kinds():
    """For each store the port's master can elect over, a maker:
    make() -> (client factory, closer, the server's address)."""
    from xllm_service_tpu.service import etcd_store as jax_etcd
    from xllm_service_tpu_torch.service import (coordination,
                                                coordination_net,
                                                etcd_store)

    def in_memory():
        s = coordination.InMemoryStore()
        return (lambda: s), s.close, ""

    def remote():
        srv = coordination_net.StoreServer().start()
        return (lambda: coordination_net.RemoteStore(srv.address)), \
            srv.stop, srv.address

    def etcd():
        srv = jax_etcd.MockEtcdServer().start()
        return (lambda: etcd_store.EtcdStore(srv.address)), srv.stop, \
            srv.address

    return {"in_memory": in_memory, "remote": remote, "etcd": etcd}


@pytest.mark.parametrize("kind", ["in_memory", "remote", "etcd"])
def test_compare_create_is_atomic(kind):
    """Eight clients race ``compare_create`` on one key, eight times:
    exactly one wins each race, and the key holds the winner's value."""
    make, close, _ = _store_kinds()[kind]()
    try:
        clients = [make() for _ in range(8)]
        for round_ in range(8):
            key = f"ELECT:{round_}"
            wins = [None] * len(clients)
            go = threading.Barrier(len(clients))

            def race(i):
                go.wait()
                wins[i] = clients[i].compare_create(key, f"c{i}")
            ts = [threading.Thread(target=race, args=(i,))
                  for i in range(len(clients))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            assert wins.count(True) == 1, wins
            assert clients[0].get(key) == f"c{wins.index(True)}"
            assert clients[0].delete(key) is True
            assert clients[0].delete(key) is False
        assert clients[0].delete_prefix("ELECT:") == 0
    finally:
        if kind != "in_memory":
            for c in clients:
                c.close()
        close()


@pytest.mark.parametrize("kind", ["remote", "etcd"])
def test_one_leader_across_packages(kind):
    """A JAX scheduler and a port scheduler on one store: one leader; it
    stops and the other takes over (both orders of boot)."""
    from xllm_service_tpu.service import coordination_net as jax_net
    from xllm_service_tpu.service import etcd_store as jax_etcd
    make, close, addr = _store_kinds()[kind]()
    jax_client = (jax_net.RemoteStore(addr) if kind == "remote"
                  else jax_etcd.EtcdStore(addr))
    try:
        for first in ("jax", "port"):
            clients = {"jax": jax_client, "port": make()}
            order = [first, "port" if first == "jax" else "jax"]
            scheds = {k: PKGS[k].scheduler.Scheduler(
                _opts(PKGS[k]), clients[k], control=FakeControl())
                for k in order}
            try:
                assert scheds[order[0]].is_master
                assert not scheds[order[1]].is_master
                scheds[order[0]].stop()
                assert wait_until(lambda: scheds[order[1]].is_master)
            finally:
                for s in scheds.values():
                    s.stop()
    finally:
        close()


# ---------------------------------------------------------------------------
# Fan-in
# ---------------------------------------------------------------------------

def test_fan_in_order():
    """The scheduler's fan-in delivers each request's outputs in the
    order they were handed in, however the requests interleave and
    whichever threads hand them in."""
    def scenario(pkg):
        store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
        sched = pkg.scheduler.Scheduler(_opts(pkg, num_output_pools=3),
                                        store, control=FakeControl())
        got = {f"r{i}": [] for i in range(6)}
        done = threading.Semaphore(0)
        try:
            for rid in got:
                def cb(out, rid=rid):
                    time.sleep(0.0005 * (int(rid[1:]) % 2))
                    got[rid].extend(s.text for s in out.outputs)
                    if out.finished:
                        done.release()
                    return True
                sched.record_new_request(pkg.types.Request(
                    model="m", prompt="x", service_request_id=rid), cb)

            def feed(rids):
                for k in range(30):
                    for rid in rids:
                        sched.handle_generation(pkg.types.RequestOutput(
                            request_id=rid, service_request_id=rid,
                            outputs=[pkg.types.SequenceOutput(
                                text=f"{rid}.{k}", token_ids=[k])],
                            finished=(k == 29)))
            feeders = [threading.Thread(target=feed, args=(rids,))
                       for rids in (["r0", "r3"], ["r1", "r4"],
                                    ["r2", "r5"])]
            for t in feeders:
                t.start()
            for t in feeders:
                t.join(10)
            for _ in got:
                assert done.acquire(timeout=10)
            return got, sched.num_tracked_requests()
        finally:
            sched.stop()
            store.close()

    got, tracked = both(scenario)
    assert got["r4"] == [f"r4.{k}" for k in range(30)] and tracked == 0

    def pools(pkg):
        fan = pkg.misc.OrderedFanInPools(4)
        seen = {f"q{i}": [] for i in range(8)}
        try:
            for k in range(50):
                for rid in seen:
                    fan.submit(rid, lambda rid=rid, k=k:
                               seen[rid].append(k))
            fan.drain()
            return seen, [fan.pool_for(f"q{i}") for i in range(8)]
        finally:
            fan.stop()

    seen, assignment = both(pools)
    assert seen["q7"] == list(range(50)) and assignment == [
        0, 1, 2, 3, 0, 1, 2, 3]


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

def _chunk(content, ids, created=111, finish=None, role=None):
    delta = {"role": role} if role else {"content": content}
    obj = {"id": "r1", "object": "chat.completion.chunk",
           "created": created, "model": "m",
           "choices": [{"index": 0, "delta": delta,
                        "finish_reason": finish}]}
    if ids:
        obj["xllm"] = {"token_ids": list(ids)}
    return json.dumps(obj, separators=(",", ":"))


def test_relay_ledger_resume_after_a_worker_death():
    """One relay stream over the scheduler's delivered ledger: the first
    worker streams a role chunk, text, a held-back token and dies; the
    resume body carries the prompt plus what the client has and the
    budget left; the survivor's duplicate role chunk is dropped, its
    ``created`` pinned and its usage rewritten to the client's truth."""
    def scenario(pkg):
        store = pkg.coordination.InMemoryStore(sweep_interval_s=0.02)
        sched = pkg.scheduler.Scheduler(_opts(pkg), store,
                                        control=FakeControl())
        spans, events = pkg.spans.SpanStore(), pkg.events.EventLog()
        obs = pkg.metrics.Registry()
        try:
            mgr = pkg.recovery.RecoveryManager(sched.opts, sched, spans,
                                               events, obs, None)
            req = pkg.types.Request(
                model="m", service_request_id="r1", stream=True,
                token_ids=[1, 2, 3],
                sampling=pkg.types.SamplingParams(max_tokens=8))
            sched.record_new_request(req, lambda out: True)
            fwd = {"model": "m", "token_ids": [1, 2, 3],
                   "sampling": req.sampling.to_json()}
            ctx = mgr.arm(req, fwd, "/v1/chat/completions", "relay")
            ledger = pkg.recovery.RelayLedger(mgr, req, is_chat=True)
            frames = []
            for payload in (_chunk("", (), role="assistant"),
                            _chunk("He", (7, 8)), _chunk("", (9,)),
                            _chunk("llo", (10,))):
                frames.append(ledger.on_payload(payload))
            delivered = sched.resume_ledger("r1")
            resume = mgr.resume_fwd(fwd, req, delivered)
            ledger.resumed = True
            for payload in (_chunk("", (), created=999, role="assistant"),
                            _chunk(" w", (11,), created=999),
                            _chunk("", (12,), created=999,
                                   finish="length"),
                            json.dumps({"id": "r1",
                                        "object": "chat.completion.chunk",
                                        "created": 999, "model": "m",
                                        "choices": [],
                                        "usage": {"prompt_tokens": 7,
                                                  "completion_tokens": 2,
                                                  "total_tokens": 9}}),
                            "[DONE]"):
                frames.append(ledger.on_payload(payload))
            return ([(f.decode() if f else None, n) for f, n in frames],
                    delivered, resume, ctx["owner"], fwd["ledger_tokens"],
                    sched.delivered_total("r1"), ledger.finished,
                    ledger.done)
        finally:
            sched.stop()
            store.close()

    frames, delivered, resume, *_ = both(scenario)
    assert delivered == [7, 8, 9, 10]
    assert resume["token_ids"] == [1, 2, 3, 7, 8, 9, 10]
    assert resume["sampling"]["max_tokens"] == 4
    assert frames[4] == (None, 0)          # the survivor's role chunk


def test_poison_ledger():
    def scenario(pkg):
        led = pkg.recovery.PoisonLedger(strikes=3, ttl_s=0.2)
        d1 = pkg.hashing.prompt_digest([1, 2, 3])
        d2 = pkg.hashing.prompt_digest([1, 2, 3, 4])
        seen = [led.strike("a", d1), led.strike("b", d1),
                led.quarantined(d1), led.strike("c", d2),
                led.strike("a", d1), led.quarantined(d1),
                led.quarantined(d2)]
        state = led.state()
        seen.append((sorted(state["strikes"].items()),
                     sorted(state["quarantined"]), state["max_strikes"]))
        time.sleep(0.25)
        seen += [led.quarantined(d1), led.strike("z", d1)]
        return seen

    got = both(scenario)
    assert got[4] == (3, True) and got[5] is True and got[-2] is False


# ---------------------------------------------------------------------------
# Admission, options, predictor
# ---------------------------------------------------------------------------

def test_admission_at_max_concurrency():
    """The master's front door at ``max_concurrency`` 1: with one
    request in flight another entry request is shed with the same 503
    and headers, while ``/metrics``, ``/admin/*`` and ``/rpc/*`` pass."""
    import http.client

    def scenario(pkg):
        httpd = pkg.httpd
        release, entered = threading.Event(), threading.Event()

        def slow(req):
            entered.set()
            release.wait(10)
            return httpd.Response.json({"ok": True})
        router = httpd.Router()
        router.route("POST", "/v1/chat/completions", slow)
        for path in ("/metrics", "/admin/flags", "/rpc/hello"):
            router.route("GET", path, lambda req: httpd.Response.json({}))
        srv = httpd.HttpServer("127.0.0.1", 0, router, max_concurrency=1)
        srv.start()
        held = {}

        def hold():
            held["r"] = httpd.http_json("POST", srv.address,
                                        "/v1/chat/completions", {})
        t = threading.Thread(target=hold)
        t.start()
        try:
            assert entered.wait(10)
            host, port = srv.address.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            conn.request("POST", "/v1/chat/completions", body=b"{}",
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            shed = (resp.status, json.loads(resp.read()),
                    resp.getheader("Retry-After"))
            conn.close()
            exempt = [httpd.http_json("GET", srv.address, p)[0]
                      for p in ("/metrics", "/admin/flags", "/rpc/hello")]
        finally:
            release.set()
            t.join(10)
            srv.stop()
        return shed, exempt, held["r"][0], srv.admission.rejected_total

    shed, exempt, held, rejected = both(scenario)
    assert shed[0] == 503 and exempt == [200, 200, 200] and held == 200
    assert rejected == 1


@pytest.mark.parametrize("env", [
    {},
    {"ENABLE_DECODE_RESPONSE_TO_SERVICE": "yes",
     "XLLM_MAX_CONCURRENCY": "7"},
    {"ENABLE_DECODE_RESPONSE_TO_SERVICE": "0",
     "XLLM_MAX_CONCURRENCY": "not-a-number"}])
def test_options_from_env(monkeypatch, env):
    for k in ("ENABLE_DECODE_RESPONSE_TO_SERVICE", "XLLM_MAX_CONCURRENCY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def scenario(pkg):
        cfg = pkg.config
        plain = cfg.options_from_env(host="127.0.0.1", http_port=0,
                                     block_size=16).to_json()
        pinned = cfg.options_from_env(
            max_concurrency=3, load_balance_policy=(
                cfg.LoadBalancePolicyType.SLO_AWARE)).to_json()
        return plain, pinned

    plain, pinned = both(scenario)
    assert pinned["max_concurrency"] == 3
    assert plain["max_concurrency"] == (7 if env.get(
        "XLLM_MAX_CONCURRENCY") == "7" else 128)


def test_time_predictor_fits():
    ttft = [(n, 5 + 0.1 * n + 0.001 * n * n + (n % 7) * 0.3)
            for n in (10, 50, 100, 200, 500, 1000)]
    tpot = [(b, t, 2 + 0.5 * b + 0.001 * b * (t - 1) + (b * t % 5) * 0.01)
            for b in (1, 2, 4, 8) for t in (64, 256, 1024)]
    got = {}
    for name, pkg in PKGS.items():
        p = pkg.time_predictor.TimePredictor.from_profiling(ttft, tpot)
        got[name] = ([p.predict_ttft(n) for n in (0, 33, 300, 4096)]
                     + [p.predict_tpot(t, b) for b, t in
                        ((1, 100), (3, 900), (16, 16384))],
                     p.has_ttft, p.has_tpot)
    assert got["port"][1:] == got["jax"][1:] == (True, True)
    assert got["port"][0] == pytest.approx(got["jax"][0], rel=1e-9,
                                           abs=1e-9)
    empty = {name: (pkg.time_predictor.TimePredictor().predict_ttft(9),
                    pkg.time_predictor.TimePredictor().fit_tpot([(1, 1, 1)]))
             for name, pkg in PKGS.items()}
    assert empty["port"] == empty["jax"] == (0.0, False)


def test_native_etcd_launcher():
    """The port's launcher builds the same ``csrc/xllm_etcd.cpp`` binary
    as the JAX one and starts it; the election's transaction holds on
    it from either package's client (skipped only without g++)."""
    from xllm_service_tpu.service import etcd_native as jax_native
    from xllm_service_tpu.service import etcd_store as jax_etcd
    from xllm_service_tpu_torch.service import etcd_native, etcd_store
    binary = etcd_native.build_binary()
    if binary is None:
        pytest.skip("no C++ toolchain for xllm_etcd")
    assert binary == jax_native.build_binary()
    server = etcd_native.NativeEtcdServer().start()
    try:
        port, ref = (etcd_store.EtcdStore(server.address),
                     jax_etcd.EtcdStore(server.address))
        assert port.compare_create("E:1", "port") is True
        assert ref.compare_create("E:1", "jax") is False
        assert ref.get("E:1") == "port" and ref.delete("E:1") is True
        port.close()
        ref.close()
    finally:
        server.stop()
