"""The port's master (``service/master.py``) and store
(``coordination_net.StoreServer``) against the JAX package's, on the CPU.

A port ``Master`` on a port ``StoreServer``, in-process, fronts the
tiny port worker (the weights of ``tests/test_torch_cluster.py``: the
JAX engine's ``init_params(cfg, PRNGKey(0))``, float32, the byte
tokenizer). At temperature 0 its texts, finish reasons, usage and
chosen-token logprobs must equal the JAX stack's (a JAX worker behind
the JAX master), in the relay and the RPC topology, and so must a JAX
worker's behind the port's master. Also:

- a port master and a JAX master on one store elect one leader, and the
  worker follows a takeover from one package's master to the other's;
- every master-side failpoint (``store.*``, ``service.fail_redispatch``)
  fires as on the JAX master, and the arming proxies to a worker;
- ``/metrics`` passes the JAX ``validate_exposition`` with the JAX
  master's family names and label sets;
- every ``/admin/*`` route answers with the JAX master's status and
  top-level keys;
- ``python -m xllm_service_tpu_torch.service.coordination_net`` and
  ``.master`` start, print the JAX modules' readiness lines and serve,
  with neither ``jax`` nor ``xllm_service_tpu`` importable.
"""

import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from xllm_service_tpu.config import ServiceOptions as JaxOptions
from xllm_service_tpu.obs import parse_exposition, validate_exposition
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.service.master import Master as JaxMaster
from xllm_service_tpu_torch.config import ServiceOptions
from xllm_service_tpu_torch.service import coordination_net
from xllm_service_tpu_torch.service.coordination import KEY_MASTER
from xllm_service_tpu_torch.service.master import Master
from xllm_service_tpu_torch.utils.types import Request, SamplingParams

from tests.test_torch_cluster import (  # noqa: F401 — fixtures
    ENGINE, HB_S, LOADED_LEASE_S, MODEL, REQUESTS, Cluster, assert_same,
    generate, jax_ref, models, wait_until)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _options(cls, rpc_topology=False, **kw):
    return cls(http_port=0, rpc_port=0, num_output_pools=4,
               load_balance_policy=type(cls().load_balance_policy)("RR"),
               block_size=ENGINE["page_size"], heartbeat_interval_s=HB_S,
               master_upload_interval_s=HB_S,
               enable_decode_response_to_service=rpc_topology, **kw)


class PortCluster(Cluster):
    """A port ``StoreServer`` and a port ``Master`` on its store, and
    workers (the JAX ``Cluster``'s worker helpers)."""

    def __init__(self, rpc_topology: bool = False) -> None:
        self.server = coordination_net.StoreServer().start()
        self.master = Master(_options(ServiceOptions, rpc_topology),
                             store=self.server.store).start()
        self.workers = []


@pytest.fixture(scope="module")
def port_relay(models):
    c = PortCluster()
    c.add_torch_worker(models)
    yield c
    c.close()


@pytest.fixture(scope="module")
def port_rpc(models):
    c = PortCluster(rpc_topology=True)
    w = c.add_torch_worker(models, lease_ttl_s=LOADED_LEASE_S)
    assert w._decode_to_service
    yield c
    c.close()


@pytest.fixture(scope="module")
def jax_master_port_worker(models):
    """The same port worker behind the JAX master (relay)."""
    c = Cluster()
    c.add_torch_worker(models)
    yield c
    c.close()


@pytest.mark.parametrize("stream", [False, True], ids=["full", "stream"])
@pytest.mark.parametrize("kind", sorted(REQUESTS))
@pytest.mark.parametrize("topology", ["port_relay", "port_rpc"])
def test_port_master_texts_match_jax(request, jax_ref,
                                     jax_master_port_worker, topology,
                                     kind, stream):
    cluster = request.getfixturevalue(topology)
    path, body = REQUESTS[kind]
    mine = generate(cluster, path, body, stream)
    ref = generate(jax_ref, path, body, stream)
    assert len(ref[3]) == ref[2]["completion_tokens"] > 0
    assert_same(mine, ref)
    assert_same(mine, generate(jax_master_port_worker, path, body, stream))


@pytest.mark.parametrize("rpc_topology", [False, True],
                         ids=["relay", "rpc"])
def test_jax_worker_behind_port_master(models, jax_ref, rpc_topology):
    c = PortCluster(rpc_topology)
    try:
        w = c.add_jax_worker(lease_ttl_s=LOADED_LEASE_S)
        assert wait_until(lambda: w._decode_to_service == rpc_topology)
        for kind in sorted(REQUESTS):
            for stream in (False, True):
                path, body = REQUESTS[kind]
                assert_same(generate(c, path, body, stream),
                            generate(jax_ref, path, body, stream))
    finally:
        c.close()


def test_port_and_jax_masters_elect_one_leader(models):
    """A port master leads, a JAX master stands by on the same store; the
    port master stops and the JAX master takes over, the port worker
    follows it and is served through it. Then a port master joins as the
    replica of the JAX leader."""
    c = PortCluster()
    replica = port2 = None
    try:
        replica = JaxMaster(_options(JaxOptions),
                            store=coordination_net.RemoteStore(
                                c.server.address)).start()
        assert c.master.scheduler.is_master
        assert not replica.scheduler.is_master
        w = c.add_torch_worker(models)
        path, body = REQUESTS["completion"]
        before = generate(c, path, body, stream=False)
        c.master.stop()
        assert wait_until(lambda: replica.scheduler.is_master, 10.0)
        assert c.server.store.get(KEY_MASTER) == \
            replica.scheduler.service_id
        assert wait_until(lambda: w.service_addr == replica.rpc_address
                          and w.name in http_json(
                              "GET", replica.rpc_address,
                              "/rpc/static_prefill_list")[1]["instances"],
                          15.0)
        c.master = replica
        assert_same(generate(c, path, body, stream=False), before)
        port2 = Master(_options(ServiceOptions),
                       store=coordination_net.RemoteStore(
                           c.server.address)).start()
        assert not port2.scheduler.is_master and replica.scheduler.is_master
        epochs = c.server.store.get_prefix("XLLM:SERVICE:EPOCH:")
        assert len(epochs) == 2
    finally:
        if port2 is not None:
            port2.stop()
        if replica is not None:
            replica.stop()
        c.close()


# ---------------------------------------------------------------------------
# Failpoints, /metrics, /admin/*
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(models):
    """A port master and a JAX master (each on its own package's store),
    each with one port worker, after the same requests."""
    port, jax_c = PortCluster(), Cluster()
    for c in (port, jax_c):
        c.add_torch_worker(models)
        for kind in sorted(REQUESTS):
            generate(c, *REQUESTS[kind], stream=True)
    yield {"port": port, "jax": jax_c}
    port.close()
    jax_c.close()


def _trips(cluster, name):
    status, state = http_json("GET", cluster.master.http_address,
                              "/admin/failpoints")
    assert status == 200
    return state["trips"].get(name, 0)


@pytest.mark.parametrize("name", ["store.fail_rpc", "store.hang",
                                  "store.partition",
                                  "service.fail_redispatch"])
def test_master_failpoints_fire_as_on_jax(pair, name):
    got = {}
    for pkg, c in pair.items():
        m = c.master
        spec = f"{name}=count:1:0.05" if name == "store.hang" \
            else f"{name}=count:1"
        status, resp = http_json("POST", m.http_address, "/admin/failpoint",
                                 {"spec": spec})
        assert status == 200 and resp["ok"]
        armed = name in resp["state"]["armed"]
        if name == "service.fail_redispatch":
            rec = m.http_service.recovery
            req = Request(model=MODEL, service_request_id=f"fp-{pkg}",
                          token_ids=[1, 2, 3],
                          sampling=SamplingParams(max_tokens=4))
            routed = rec.reroute(req, {})
        else:
            routed = None     # the master loop's next store call trips it
        assert wait_until(lambda: _trips(c, name) == 1, 10.0)
        status, evs = http_json("GET", m.http_address, "/admin/events")
        tripped = [e for e in evs["events"]
                   if e["type"] == "failpoint_tripped"
                   and e["attrs"].get("name") == name]
        # A count-mode point leaves the armed set on the pass after its
        # last trip.
        spent = wait_until(lambda: name not in http_json(
            "GET", m.http_address, "/admin/failpoints")[1]["armed"], 10.0) \
            if name != "service.fail_redispatch" else None
        got[pkg] = (armed, routed, _trips(c, name), len(tripped) >= 1,
                    spent)
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][2] == 1 and got["port"][3]


def test_failpoint_arming_proxies_to_the_worker(pair):
    got = {}
    for pkg, c in pair.items():
        w = c.workers[0]
        spec = {"spec": "worker.slow_response_ms=count:1:1",
                "instance": w.name}
        status, resp = http_json("POST", c.master.http_address,
                                 "/admin/failpoint", dict(spec))
        armed = sorted(w.failpoints.state()["armed"])
        w.failpoints.disarm("worker.slow_response_ms")
        status2, resp2 = http_json("POST", c.master.http_address,
                                   "/admin/failpoint",
                                   {"spec": "x=1", "instance": "nobody"})
        bad = http_json("POST", c.master.http_address, "/admin/failpoint",
                        {"spec": "no.such.failpoint=always"})
        got[pkg] = (status, resp["ok"], armed, status2, resp2, bad)
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["worker.slow_response_ms"]


def _families(text):
    """{family: (declared type, sorted label names)} of an exposition."""
    samples, types, errors = parse_exposition(text)
    assert errors == []
    labels = {name: set() for name in types}
    for name, lab, _ in samples:
        fam = next((f for f in (name, name.rsplit("_", 1)[0])
                    if f in types), name)
        labels.setdefault(fam, set()).update(set(lab) - {"le"})
    return {f: (types.get(f), sorted(v)) for f, v in labels.items()}


# Mirrors of a package's process-wide books (utils/threads.py): a family
# appears once any thread of the process crashed or dropped a callback,
# which other tests in the same process decide.
PROCESS_BOOKS = ("xllm_thread_crashes_total", "xllm_callback_errors_total")


def test_metrics_exposition_matches_jax(pair):
    got = {}
    for pkg, c in pair.items():
        status, _ = http_json("GET", c.master.http_address, "/hello")
        assert status == 200
        text = _get_text(c.master.http_address, "/metrics")
        assert validate_exposition(text) == []
        got[pkg] = _families(text)
    for name in PROCESS_BOOKS:
        if name in got["port"] and name in got["jax"]:
            assert got["port"][name] == got["jax"][name]
        got["port"].pop(name, None)
        got["jax"].pop(name, None)
    assert got["port"] == got["jax"]
    assert "xllm_service_instances" in got["port"]
    assert "xllm_service_hotpath_ms" in got["port"]


def _get_text(addr, path):
    from http.client import HTTPConnection
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        assert r.status == 200
        return r.read().decode()
    finally:
        conn.close()


ADMIN_GETS = ["/admin/flags", "/admin/slo", "/admin/events",
              "/admin/debug_bundle", "/admin/timeline",
              "/admin/profile?seconds=0.05", "/admin/failpoints",
              "/admin/trace/no-such-request", "/v1/models", "/hello"]


def _keys(body):
    return sorted(body) if isinstance(body, dict) else type(body).__name__


@pytest.mark.parametrize("path", ADMIN_GETS)
def test_admin_routes_answer_with_jax_keys(pair, path):
    got = {}
    for pkg, c in pair.items():
        status, body = http_json("GET", c.master.http_address, path,
                                 timeout=30.0)
        got[pkg] = (status, _keys(body))
        if path == "/admin/debug_bundle":
            got[pkg] += (_keys(body["instances"][0]), _keys(body["spans"]),
                         _keys(body["profile"]), body["is_master"])
    assert got["port"] == got["jax"]


def test_admin_trace_and_flags_match_jax(pair):
    """A traced request's merged span (the master's stages and the
    worker's, shipped on the beat) and a flag reload answer as on the
    JAX master."""
    got = {}
    for pkg, c in pair.items():
        rid = f"traced-{pkg}"
        generate(c, *REQUESTS["chat"], stream=True,
                 headers={"x-request-id": rid})

        def worker_stages():
            status, span = http_json("GET", c.master.http_address,
                                     f"/admin/trace/{rid}")
            stages = [(e["plane"], e["stage"]) for e in span["events"]] \
                if status == 200 else []
            return stages if ("worker", "finished") in stages else None
        stages = wait_until(worker_stages, 15.0) and worker_stages()
        assert stages
        status, flags = http_json("POST", c.master.http_address,
                                  "/admin/flags", {"target_ttft_ms": 321.0})
        bad = http_json("POST", c.master.http_address, "/admin/flags",
                        {"no_such_flag": 1})
        got[pkg] = (sorted(set(stages)), status, flags, bad[0])
        http_json("POST", c.master.http_address, "/admin/flags",
                  {"target_ttft_ms": 1000.0})
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# The entry points, with neither jax nor the JAX package importable
# ---------------------------------------------------------------------------

BLOCKER = textwrap.dedent("""
    import runpy, sys
    class _Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "xllm_service_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None
    sys.meta_path.insert(0, _Block())
    module = sys.argv[1]
    sys.argv = [module] + sys.argv[2:]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
""")


def _child(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKER, module, *args], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line.strip())
    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)
    return proc.stderr.read()


def test_entry_points_run_without_jax(models):
    store, s_lines = _child(
        "xllm_service_tpu_torch.service.coordination_net", "--port", "0")
    master = None
    try:
        assert wait_until(lambda: s_lines, 60.0), _stop(store)
        assert s_lines[0].startswith("coordination store serving on ")
        addr = s_lines[0].split()[-1]
        client = coordination_net.RemoteStore(addr)
        client.put("SMOKE:k", "v")
        assert client.get("SMOKE:k") == "v"
        master, m_lines = _child(
            "xllm_service_tpu_torch.service.master", "--host", "127.0.0.1",
            "--http-port", "0", "--rpc-port", "0", "--etcd-addr", addr,
            "--block-size", str(ENGINE["page_size"]),
            "--heartbeat-interval", str(HB_S),
            "--load-balance-policy", "RR")
        assert wait_until(lambda: m_lines, 60.0), _stop(master)
        up = m_lines[0].split()
        assert up[0] == "XLLM_SERVICE_UP" and up[3] == "master=1", m_lines
        fields = dict(f.split("=", 1) for f in up[1:])
        c = Cluster.__new__(Cluster)
        c.server = type("S", (), {"address": addr})()
        c.master = type("M", (), {"rpc_address": fields["rpc"],
                                  "http_address": fields["http"]})()
        c.workers = []
        try:
            c.add_torch_worker(models)
            path, body = REQUESTS["chat"]
            text, finish, usage, lps = generate(c, path, body, stream=True)
            assert finish == "length" and usage["completion_tokens"] == \
                body["max_tokens"] == len(lps)
        finally:
            for w in c.workers:
                w.stop()
    finally:
        err = _stop(master) if master is not None else ""
        err += _stop(store)
    assert "blocked import" not in err, err[-2000:]
