"""The port's etcd v3 client against the JAX package's servers, on the CPU.

- The contract cases of ``tests/test_coordination.py::TestEtcdStore``
  (inherited, not copied) over both packages' ``EtcdStore``, against the
  JAX ``MockEtcdServer`` and the native server built from
  ``csrc/xllm_etcd.cpp`` (skipped only without g++, as there).
- What the port adds around the client: a raising watch callback is
  counted and the watch goes on, ``StoreGuard`` fires the ``store.*``
  failpoints on it, and the resync of a compacted resume delivers the
  state diff.
- A port worker joins the JAX master over ``etcd://``: it is listed and
  served, its lease expires when it goes silent, and it heals after the
  store restarts empty.
"""

import base64
import http.client
import json
import time

import pytest

import tests.test_coordination as jax_coordination
from xllm_service_tpu.config import (LoadBalancePolicyType,
                                     ServiceOptions)
from xllm_service_tpu.service import etcd_store as jax_etcd
from xllm_service_tpu.service.etcd_native import (NativeEtcdServer,
                                                  build_binary)
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.service.master import Master
from xllm_service_tpu_torch.config import EngineConfig, InstanceType
from xllm_service_tpu_torch.models.weights import params_from_jax
from xllm_service_tpu_torch.obs.failpoints import Failpoints
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.service import etcd_store as port_etcd
from xllm_service_tpu_torch.service.store_guard import (StoreGuard,
                                                       StoreOutageError)
from xllm_service_tpu_torch.utils import threads

from tests.test_torch_cluster import (  # noqa: F401 — a fixture
    ENGINE, HB_S, MODEL, models, wait_until)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

CLIENTS = {"port": port_etcd.EtcdStore, "jax": jax_etcd.EtcdStore}


def _server(kind):
    if kind == "native":
        if build_binary() is None:
            pytest.skip("no C++ toolchain for xllm_etcd")
        return NativeEtcdServer().start()
    return jax_etcd.MockEtcdServer().start()


class TestPortEtcdStore(jax_coordination.TestEtcdStore):
    """Every contract case of the JAX suite, over each client and each
    server."""

    @pytest.fixture(params=[f"{c}-{s}" for c in CLIENTS
                            for s in ("mock", "native")])
    def etcd(self, request):
        client_kind, server_kind = request.param.split("-")
        server = _server(server_kind)
        client = CLIENTS[client_kind](server.address)
        yield client
        client.close()
        server.stop()

    def test_range_end_convention(self):
        for prefix in ("A:", "XLLM:", "", "aÿ", "XLLM:PREFILL:"):
            assert port_etcd.range_end_for_prefix(prefix) == \
                jax_etcd.range_end_for_prefix(prefix)
        assert base64.b64decode(
            port_etcd.range_end_for_prefix("A:")) == b"A;"


@pytest.fixture
def native():
    server = _server("native")
    yield server
    server.stop()


def test_raising_watch_callback_is_counted(native):
    client = port_etcd.EtcdStore(native.address)
    before = threads.callback_error_counts().get("etcd.watch_loop", 0)
    got = []

    def cb(ev):
        got.append(ev)
        if ev[1] == "CB:bad":
            raise RuntimeError("bad callback")

    try:
        client.add_watch("CB:", cb)
        time.sleep(0.3)
        client.put("CB:bad", "1")
        client.put("CB:good", "2")
        assert wait_until(lambda: ("PUT", "CB:good", "2") in got, 5.0)
        assert threads.callback_error_counts()["etcd.watch_loop"] == \
            before + 1
    finally:
        client.close()


def test_resync_delivers_the_state_diff(native):
    """The resync a compacted resume falls back to: synthetic DELETEs
    for the keys that vanished, PUTs for new or changed ones."""
    client = port_etcd.EtcdStore(native.address)
    got = []
    try:
        client.put("R:gone", "x")
        client.put("R:same", "1")
        known = {"R:gone": "x", "R:same": "1", "R:old": "o"}
        client.delete("R:gone")
        client.put("R:added", "3")
        client._resync("R:", known, got.append)
        assert ("DELETE", "R:gone", None) in got
        assert ("DELETE", "R:old", None) in got
        assert ("PUT", "R:added", "3") in got
        assert all(ev[1] != "R:same" for ev in got)
    finally:
        client.close()


def test_store_guard_fires_store_failpoints_on_etcd(native):
    fp = Failpoints()
    guard = StoreGuard(port_etcd.EtcdStore(native.address), failpoints=fp)
    try:
        guard.put("G:k", "v")
        fp.arm("store.fail_rpc", mode="count", n=1)
        with pytest.raises(StoreOutageError):
            guard.get("G:k")
        assert guard.get("G:k") == "v" and guard.health == 2
        fp.arm("store.partition", mode="count", n=3)
        for _ in range(3):
            with pytest.raises(StoreOutageError):
                guard.lease_grant(5.0)
        assert guard.health == 0
        assert guard.get("G:k") == "v" and guard.health == 2
        assert (fp.trips("store.fail_rpc"), fp.trips("store.partition")) \
            == (1, 3)
    finally:
        guard.close()


def _revision(addr):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("POST", "/v3/kv/range", json.dumps(
            {"key": base64.b64encode(b"\0").decode()}),
            {"Content-Type": "application/json"})
        return int(json.loads(conn.getresponse().read())["header"]
                   ["revision"])
    finally:
        conn.close()


def _listed(master):
    status, resp = http_json("GET", master.rpc_address,
                             "/rpc/static_prefill_list")
    return resp["instances"] if status == 200 else []


def test_port_worker_joins_the_jax_master_over_etcd(models, native):
    """Listed and served over ``etcd://``; silent (``worker.drop_
    heartbeats``), its lease expires and the master drops it, then it
    re-registers; the store restarts empty on the same port, the worker's
    guard sees the outage and heals into a fresh registration; ``stop()``
    revokes the lease."""
    _, tcfg, jparams = models
    port = int(native.address.rsplit(":", 1)[1])
    master = Master(ServiceOptions(
        http_port=0, rpc_port=0, num_output_pools=4,
        load_balance_policy=LoadBalancePolicyType.ROUND_ROBIN,
        block_size=ENGINE["page_size"], heartbeat_interval_s=HB_S,
        master_upload_interval_s=HB_S),
        store=jax_etcd.EtcdStore(native.address)).start()
    w = torch_worker.Worker(
        torch_worker.WorkerOptions(
            model=MODEL, device="cpu", instance_type=InstanceType.DEFAULT,
            store_addr=f"etcd://{native.address}",
            service_addr=master.rpc_address, heartbeat_interval_s=HB_S),
        engine_cfg=EngineConfig(**ENGINE), model_cfg=tcfg,
        params=params_from_jax(jparams, tcfg, "cpu"))
    restarted = None
    try:
        assert isinstance(w.store.inner, port_etcd.EtcdStore)
        w.start()
        assert wait_until(lambda: w.name in _listed(master))
        status, resp = http_json("POST", master.http_address,
                                 "/v1/completions",
                                 {"model": MODEL, "prompt": "etcd",
                                  "max_tokens": 3, "temperature": 0.0},
                                 timeout=60.0)
        assert status == 200 and resp["usage"]["completion_tokens"] == 3
        # Silent: no keepalive, the 1 s lease expires.
        w.failpoints.arm("worker.drop_heartbeats", mode="always")
        assert wait_until(lambda: w.name not in _listed(master), 15.0)
        lease0 = w._lease_id
        w.failpoints.disarm("worker.drop_heartbeats")
        assert wait_until(lambda: w.name in _listed(master), 15.0)
        assert w._lease_id != lease0
        # The store restarts empty on its port.
        old_rev = _revision(native.address)
        native.stop()
        assert wait_until(lambda: w.store.health == 0, 15.0)
        restarted = NativeEtcdServer(port=port).start()
        assert wait_until(lambda: w.store.health == 2, 15.0)
        key = f"XLLM:DEFAULT:{w.name}"
        client = port_etcd.EtcdStore(restarted.address)
        assert wait_until(lambda: client.get(key) is not None, 20.0)
        assert wait_until(lambda: w.name in _listed(master), 20.0)
        # Every watch resumes after the last revision it saw: the master
        # hears the restarted store once its revision passes the old.
        while _revision(restarted.address) <= old_rev:
            client.put("PAD", "x")
        w.stop()
        assert wait_until(lambda: w.name not in _listed(master), 15.0)
        assert client.get(key) is None
    finally:
        w.stop()
        master.stop()
        if restarted is not None:
            restarted.stop()
