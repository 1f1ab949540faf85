"""The port's store guard and supervised threads against the JAX package's.

``xllm_service_tpu_torch/service/store_guard.py`` and
``utils/threads.py`` are copies of the JAX modules: the same scripted
store failures (the ``store.*`` failpoints, a slow backend, a fence, a
partition under a watch) go through a port guard and a JAX guard, each
over its own package's in-memory store, and the health after every call,
the calls' outcomes, the events (``tests/test_blackout.py:59``) and the
heal callbacks' order must be equal. The ``spawn`` cases of
``tests/test_threads.py:44-200`` run against both thread modules. Then a
port worker behind the JAX master keeps serving under ``store.partition``
(both planes cut off, for longer than its lease), heals and re-registers
on a fresh lease, as a JAX worker does in the same cluster; and a crashed
heartbeat loop restarts without the worker leaving the master's list.
"""

import threading
import time

import pytest

from xllm_service_tpu.obs import EventLog as JaxEventLog
from xllm_service_tpu.obs import Failpoints as JaxFailpoints
from xllm_service_tpu.service import store_guard as jax_guard
from xllm_service_tpu.service.coordination import \
    InMemoryStore as JaxInMemoryStore
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils import threads as jax_threads
from xllm_service_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from xllm_service_tpu_torch.obs.events import EventLog
from xllm_service_tpu_torch.obs.failpoints import Failpoints
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.service import coordination, coordination_net
from xllm_service_tpu_torch.service import store_guard
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.retry import RetryPolicy

from tests.test_torch_cluster import (  # noqa: F401 — a fixture
    Cluster, MODEL, models, wait_until)
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

PACKAGES = {
    "torch": dict(guard=store_guard, store=coordination.InMemoryStore,
                  events=EventLog,
                  failpoints=lambda ev: Failpoints(env="", events=ev),
                  threads=threads, retry=RetryPolicy),
    "jax": dict(guard=jax_guard, store=JaxInMemoryStore,
                events=JaxEventLog,
                failpoints=lambda ev: JaxFailpoints(events=ev, env=""),
                threads=jax_threads, retry=JaxRetryPolicy),
}


class _SlowStore:
    """A backend whose ``get`` takes ``delay`` seconds."""
    delay = 0.08

    def get(self, key):
        time.sleep(self.delay)
        return "v"

    def close(self):
        pass


# Each script: (backend, [op, ...]). Ops: ("arm", name, mode, n, value),
# ("get",), ("put", value), ("fence", on), ("deadline", s),
# ("delay", s), ("heal_cb_raises",).
SCRIPTS = {
    # tests/test_blackout.py::test_health_state_machine_and_heal_callbacks
    "outage_and_heal": ("memory", [
        ("arm", "store.fail_rpc", "always", 0, None),
        ("get",), ("get",), ("get",), ("get",),
        ("arm", "store.fail_rpc", "off", 0, None),
        ("get",), ("get",)]),
    # ..._flaky_recovers_without_outage_event
    "flaky_recovers": ("memory", [
        ("arm", "store.fail_rpc", "count", 2, None),
        ("get",), ("get",), ("get",)]),
    # ..._deadline_slow_call_degrades_but_returns
    "deadline_slow_call": ("slow", [
        ("deadline", 0.02), ("get",), ("get",), ("get",),
        ("delay", 0.0), ("get",)]),
    # ..._hang_failpoint_times_out_against_deadline
    "hang": ("memory", [
        ("deadline", 0.2), ("arm", "store.hang", "always", 0, 0.05),
        ("get",), ("get",), ("get",),
        ("arm", "store.hang", "off", 0, None), ("get",)]),
    # ..._epoch_fence_rejects_writes_allows_reads
    "fence": ("memory", [
        ("put", "old"), ("fence", True), ("put", "new"), ("get",),
        ("fence", False), ("put", "new"), ("get",)]),
    # A heal callback that raises: counted, the next one still runs.
    "heal_callback_raises": ("memory", [
        ("heal_cb_raises",),
        ("arm", "store.partition", "count", 3, None),
        ("get",), ("get",), ("get",), ("get",), ("get",)]),
}


def _run_script(pkg, backend, ops):
    p = PACKAGES[pkg]
    events = p["events"](capacity=64)
    fp = p["failpoints"](events)
    inner = p["store"](sweep_interval_s=0.02) if backend == "memory" \
        else _SlowStore()
    g = p["guard"].StoreGuard(inner, failpoints=fp, events=events)
    healed = []
    trace = []
    cb_errors0 = p["threads"].callback_error_counts().get(
        "store_guard.heal", 0)
    try:
        g.on_heal(lambda: healed.append(("first", g.health)))
        for op in ops:
            kind = op[0]
            if kind == "arm":
                fp.arm(op[1], mode=op[2], n=op[3], value=op[4])
                continue
            if kind == "deadline":
                g.deadline_s = op[1]
                continue
            if kind == "delay":
                inner.delay = op[1]
                continue
            if kind == "fence":
                g.fence_check = (lambda: True) if op[1] else None
                continue
            if kind == "heal_cb_raises":
                def boom():
                    raise RuntimeError("heal hook failed")
                g.on_heal(boom)
                g.on_heal(lambda: healed.append(("after", g.health)))
                continue
            try:
                out = g.get("K") if kind == "get" else g.put("K", op[1])
                outcome = ("ok", out)
            except Exception as e:  # noqa: BLE001 — the outcome compared
                outcome = ("raise", type(e).__name__)
            # The heal callbacks ran before the call returned.
            trace.append((kind, outcome, g.health, len(healed)))
        state = {k: v for k, v in g.state().items() if k != "outage_open_s"}
        evs = [(e["type"], sorted(e["attrs"]),
                e["attrs"].get("name"), e["attrs"].get("op"))
               for e in events.since(0)]
        cb_errors = p["threads"].callback_error_counts().get(
            "store_guard.heal", 0) - cb_errors0
        return {"trace": trace, "healed": healed, "state": state,
                "events": evs, "trips": fp.state()["trips"],
                "callback_errors": cb_errors}
    finally:
        g.close()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_guard_sequence_matches_jax(script):
    backend, ops = SCRIPTS[script]
    mine = _run_script("torch", backend, ops)
    ref = _run_script("jax", backend, ops)
    assert mine == ref
    if script == "outage_and_heal":
        healths = [t[2] for t in mine["trace"]]
        assert healths == [1, 1, 0, 0, 2, 2]
        assert mine["healed"] == [("first", 2)]
        assert mine["trace"][4][3] == 1       # healed before it returned
        types = [e[0] for e in mine["events"]]
        assert types.count("store_outage_open") == 1
        assert types.count("store_outage_close") == 1
    if script == "heal_callback_raises":
        assert mine["callback_errors"] == 1
        assert [h[0] for h in mine["healed"]] == ["first", "after"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_partition_suppresses_watch_events(pkg):
    """tests/test_blackout.py::test_partition_suppresses_watch_events on
    both guards: what each watcher hears is the same."""
    p = PACKAGES[pkg]
    events = p["events"](capacity=64)
    fp = p["failpoints"](events)
    store = p["store"](sweep_interval_s=0.02)
    g = p["guard"].StoreGuard(store, failpoints=fp, events=events)
    got = []
    try:
        g.add_watch("P:", got.append)
        store.put("P:a", "1")
        assert wait_until(lambda: ("PUT", "P:a", "1") in got, 5.0)
        fp.arm("store.partition", mode="always")
        store.put("P:b", "2")
        time.sleep(0.3)
        assert not any(e[1] == "P:b" for e in got)
        assert g.state()["suppressed_watch_events"] >= 1
        with pytest.raises(p["guard"].StoreOutageError):
            g.get("P:a")
        fp.arm("store.partition", mode="off")
        store.put("P:c", "3")
        assert wait_until(lambda: ("PUT", "P:c", "3") in got, 5.0)
        assert [e[1] for e in got] == ["P:a", "P:c"]
    finally:
        g.close()


def test_one_store_outage_class():
    """The guard, the remote client and the worker share one class."""
    assert coordination_net.StoreOutageError is store_guard.StoreOutageError
    assert torch_worker.StoreOutageError is store_guard.StoreOutageError
    with pytest.raises(store_guard.StoreOutageError):
        coordination_net.RemoteStore("127.0.0.1:1",
                                     timeout=2.0).lease_keepalive(1)
    # A backend failure of any class leaves the guard as this one, with
    # the cause chained.
    g = store_guard.StoreGuard(coordination_net.RemoteStore(
        "127.0.0.1:1", timeout=2.0))
    with pytest.raises(store_guard.StoreOutageError) as info:
        g.get("K")
    assert isinstance(info.value.__cause__, store_guard.StoreOutageError)


# ---------------------------------------------------------------------------
# Supervised threads (tests/test_threads.py:44-200), both modules
# ---------------------------------------------------------------------------

def _crashes(th, root):
    return th.crash_counts().get(root, 0)


def _spawn_case(case, p):
    """One ``spawn`` case of tests/test_threads.py::TestSpawn; returns
    what the case observed (compared across the packages)."""
    th, Retry, Log = p["threads"], p["retry"], p["events"]
    root = f"t.{case}"
    before = _crashes(th, root)
    if case == "crash":
        events = Log(capacity=16)

        def boom():
            raise RuntimeError("kaboom")
        t = th.spawn(root, boom, events=events)
        t.start()
        t.join(5)
        evs = [e for e in events.since() if e["type"] == "thread_crashed"]
        return {"alive": t.is_alive(), "crashes": _crashes(th, root) - before,
                "events": [(e["attrs"]["root"], e["attrs"]["restarting"],
                            "kaboom" in e["attrs"]["error"]) for e in evs]}
    if case == "restart":
        runs = [0]
        stop = threading.Event()

        def flaky():
            runs[0] += 1
            if runs[0] < 3:
                raise ValueError("transient")
            stop.set()
        t = th.spawn(root, flaky, restart=Retry(
            base_delay_s=0.01, max_delay_s=0.05, jitter=0), stop=stop)
        t.start()
        t.join(10)
        return {"runs": runs[0], "crashes": _crashes(th, root) - before}
    if case == "stop_interrupts_backoff":
        stop = threading.Event()

        def always():
            raise RuntimeError("dead again")
        t = th.spawn(root, always, restart=Retry(
            base_delay_s=30.0, max_delay_s=30.0, jitter=0), stop=stop)
        t.start()
        assert wait_until(lambda: _crashes(th, root) >= before + 1)
        stop.set()
        t.join(5)
        return {"alive": t.is_alive(), "crashes": _crashes(th, root) - before}
    if case == "base_exception":
        def die():
            raise SystemExit(3)
        t = th.spawn(root, die, restart=Retry(base_delay_s=0.01, jitter=0))
        t.start()
        t.join(5)
        return {"alive": t.is_alive(), "crashes": _crashes(th, root) - before}
    if case == "lazy_events":
        holder = {"log": None}

        def boom():
            raise RuntimeError("late-bound sink")
        t = th.spawn(root, boom, events=lambda: holder["log"])
        holder["log"] = Log(capacity=4)
        t.start()
        t.join(5)
        return {"types": [e["type"] for e in holder["log"].since()]}
    if case == "flush_metrics":
        from xllm_service_tpu_torch.obs.metrics import Registry

        def boom():
            raise RuntimeError("for the books")
        t = th.spawn(root, boom)
        t.start()
        t.join(5)
        th.record_callback_error(f"{root}.cb", RuntimeError("cb"))
        reg = Registry()
        th.flush_metrics(reg)
        text = reg.render()
        return {"crash_series": f'xllm_thread_crashes_total{{root="{root}"}}'
                in text,
                "cb_series": f'xllm_callback_errors_total{{root="{root}.cb"}}'
                in text}
    raise AssertionError(case)


SPAWN_CASES = ("crash", "restart", "stop_interrupts_backoff",
               "base_exception", "lazy_events", "flush_metrics")


@pytest.mark.parametrize("case", SPAWN_CASES)
def test_spawn_matches_jax(case):
    mine = _spawn_case(case, PACKAGES["torch"])
    ref = _spawn_case(case, PACKAGES["jax"])
    assert mine == ref
    assert mine == {
        "crash": {"alive": False, "crashes": 1,
                  "events": [("t.crash", False, True)]},
        "restart": {"runs": 3, "crashes": 2},
        "stop_interrupts_backoff": {"alive": False, "crashes": 1},
        "base_exception": {"alive": False, "crashes": 1},
        "lazy_events": {"types": ["thread_crashed"]},
        "flush_metrics": {"crash_series": True, "cb_series": True},
    }[case]


# ---------------------------------------------------------------------------
# Workers behind the JAX master
# ---------------------------------------------------------------------------

def _reg_key(cluster, w):
    return f"XLLM:DEFAULT:{w.name}"


def _complete(cluster):
    status, resp = http_json(
        "POST", cluster.master.http_address, "/v1/completions",
        {"model": MODEL, "prompt": "blackout survivor ", "max_tokens": 6,
         "temperature": 0.0, "ignore_eos": True}, timeout=60.0)
    assert status == 200, resp
    return resp["choices"][0]["text"]


def _partition_run(models, pkg):
    """tests/test_blackout.py::test_blackout_shorter_and_longer_than_
    lease_ttl's phase 2 and heal on one worker of ``pkg``: both planes
    partitioned past 3x the worker's lease (0.75 s), a completion served
    mid-outage, then the heal."""
    c = Cluster()
    try:
        w = (c.add_torch_worker(models) if pkg == "torch"
             else c.add_jax_worker())
        raw = c.server.store
        base = _complete(c)
        lease0 = w._lease_id
        t0 = time.monotonic()
        c.master.failpoints.arm("store.partition", mode="always")
        status, _ = http_json("POST", w.name, "/admin/failpoint",
                              {"name": "store.partition", "mode": "always"})
        assert status == 200
        assert wait_until(lambda: w.store.is_down, 10.0)
        assert wait_until(lambda: raw.get(_reg_key(c, w)) is None, 10.0)
        listed_mid = w.name in c.listed()
        time.sleep(max(0.0, t0 + 3 * 0.75 - time.monotonic()))
        mid = _complete(c)
        c.master.failpoints.arm("store.partition", mode="off")
        http_json("POST", w.name, "/admin/failpoint",
                  {"name": "store.partition", "mode": "off"})
        assert wait_until(lambda: w.store.health == 2, 10.0)
        assert wait_until(lambda: raw.get(_reg_key(c, w)) is not None, 10.0)
        assert wait_until(lambda: w.name in c.listed(), 10.0)
        types = [e["type"] for e in w.events.since(0)
                 if e["type"].startswith("store_outage")]
        return {"served": (mid == base, _complete(c) == base),
                "listed_mid_outage": listed_mid,
                "fresh_lease": w._lease_id not in (None, lease0),
                "events": types[:2],
                "outages": w.store.outages_opened}
    finally:
        c.close()


def test_partition_heals_into_a_reregistration_as_on_jax(models):
    mine = _partition_run(models, "torch")
    ref = _partition_run(models, "jax")
    assert mine == ref
    assert mine == {"served": (True, True), "listed_mid_outage": True,
                    "fresh_lease": True,
                    "events": ["store_outage_open", "store_outage_close"],
                    "outages": 1}


def test_heartbeat_crash_restarts_without_leaving_the_list(models):
    """tests/test_threads.py::TestHeartbeatCrashRestart on a port worker:
    one injected crash, a restart with backoff, the lease kept past 3x
    its TTL, the crash on /metrics and in the event ring."""
    c = Cluster()
    try:
        # The JAX test's lease (1.5 s): the crash, the restart's backoff
        # and the next tick stay inside it.
        w = c.add_torch_worker(models, lease_ttl_s=1.5)
        before = threads.crash_counts().get("worker.hb_loop", 0)
        lease0 = w._lease_id
        w.failpoints.arm("worker.crash_heartbeat", mode="count", n=1)
        assert wait_until(lambda: threads.crash_counts().get(
            "worker.hb_loop", 0) == before + 1, 10.0)
        crashed = [e for e in w.events.since()
                   if e["type"] == "thread_crashed"]
        assert crashed and crashed[-1]["attrs"]["root"] == "worker.hb_loop"
        assert crashed[-1]["attrs"]["restarting"] is True
        time.sleep(3 * w.lease_ttl_s)
        assert w.name in c.listed() and w._lease_id == lease0
        assert threads.crash_counts()["worker.hb_loop"] == before + 1
        assert ('xllm_thread_crashes_total{root="worker.hb_loop"} '
                f'{before + 1}') in w.metrics_text()
        assert _complete(c)
    finally:
        c.close()
