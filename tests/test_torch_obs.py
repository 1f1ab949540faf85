"""The port's observability plane against the JAX package's, on the CPU.

- ``obs/spans.py``: one seeded call script (record, annotate, drain,
  requeue, overflow) through both ``SpanStore``s, equal outputs with
  the timestamps aside.
- The worker-plane spans at the JAX master's ``GET /admin/trace/<id>``:
  a port worker and a JAX worker, each behind its own master (the
  ``epd`` clusters of ``tests/test_torch_multimodal.py``, each worker
  encoding with the same float32 synthetic ViT), serve the same chats;
  the stage names, their order and each stage's attr keys must be
  equal: a plain chat, a request blamed under ``worker.fault_step_req``,
  an image chat through a remote ENCODE worker (the ``encoded`` span), a
  PD prefill -> decode handoff, and a beat that fails once and then
  delivers, with no span lost.
- ``obs/profiler.py``: the catalog, ``recent_events``' keys, the
  families ``flush_metrics`` writes (lock sampling on), and the worker's
  ``/admin/steptrace`` sections and ``/metrics`` families.
- ``utils/locks.py``: ``LockOrderViolation`` where the JAX checker
  raises it, the shared names' ranks, and F8 (a generate that took
  ``worker.live`` under ``worker.engine``).
"""

import ast
import pathlib
import random
import re
import threading
import time

import pytest

from xllm_service_tpu.config import EngineConfig as JaxEngineConfig
from xllm_service_tpu.config import InstanceType as JaxInstanceType
from xllm_service_tpu.obs import profiler as jprof
from xllm_service_tpu.obs import spans as jspans
from xllm_service_tpu.obs.metrics import Registry as JaxRegistry
from xllm_service_tpu.runtime import worker as jax_worker
from xllm_service_tpu.service.httpd import http_json
from xllm_service_tpu.utils import locks as jlocks
from xllm_service_tpu_torch.config import InstanceType
from xllm_service_tpu_torch.obs import profiler as tprof
from xllm_service_tpu_torch.obs import spans as tspans
from xllm_service_tpu_torch.obs.metrics import Registry
from xllm_service_tpu_torch.runtime import worker as torch_worker
from xllm_service_tpu_torch.utils import locks as tlocks

from tests.test_torch_cluster import (  # noqa: F401 — fixtures
    ENGINE, HB_S, MODEL, Cluster, generate, models, wait_until)
from tests.test_torch_multimodal import (  # noqa: F401 — fixtures
    CHATS, _chat, _port_worker, epd, vit)
from tests.test_torch_pd import PdCluster
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Keys of a stage event that are not its attrs.
EVENT_KEYS = {"stage", "plane", "t_mono", "t_wall", "source"}


# ---------------------------------------------------------------------------
# SpanStore
# ---------------------------------------------------------------------------

def _span_script(store_cls, seed):
    """One seeded call script; returns every observable output with the
    timestamps dropped."""
    rng = random.Random(seed)
    s = store_cls(capacity=6)
    out = []

    def strip(spans):
        return [{"request_id": sp["request_id"], "attrs": sp["attrs"],
                 "events": [{k: v for k, v in e.items()
                             if k not in ("t_mono", "t_wall")}
                            for e in sp["events"]]}
                for sp in spans]

    stages = list(tspans.WORKER_STAGES)
    held = []
    for step in range(80):
        rid = f"r{rng.randrange(12)}"
        op = rng.random()
        if op < 0.55:
            s.record(rid, rng.choice(stages), plane="worker",
                     k=rng.randrange(3))
        elif op < 0.7:
            s.annotate(rid, hits=rng.randrange(5))
        elif op < 0.85:
            batch = s.drain_finished()
            out.append(("drain", strip(batch)))
            held.append(batch)
        elif held:
            s.requeue(held.pop(rng.randrange(len(held))))
        got = s.get(rid)
        out.append(("get", strip([got]) if got else None,
                    s.eviction_count()))
    out.append(("final", strip(s.drain_finished())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_store_script_matches_jax(seed):
    assert tspans.WORKER_STAGES == jspans.WORKER_STAGES
    assert tspans.REQUEST_ID_HEADER == jspans.REQUEST_ID_HEADER
    assert tspans.DEFAULT_CAPACITY == jspans.DEFAULT_CAPACITY
    mine = _span_script(tspans.SpanStore, seed)
    assert mine == _span_script(jspans.SpanStore, seed)
    assert any(o[0] == "get" and o[2] > 0 for o in mine), "no overflow"


# ---------------------------------------------------------------------------
# The worker plane's spans at the master
# ---------------------------------------------------------------------------

def _trace(cluster, rid):
    status, tr = http_json("GET", cluster.master.http_address,
                           f"/admin/trace/{rid}", timeout=10.0)
    return tr if status == 200 else None


def _worker_view(cluster, rid, finished=1, roles=None):
    """The master's worker-plane stages of ``rid`` once ``finished``
    sources have shipped a ``finished`` stage: ``[(role, [(stage, attr
    keys)])]`` per source in the master's wall-clock order, and the
    worker attrs' keys. ``roles`` names each source (its worker)."""
    def done():
        tr = _trace(cluster, rid)
        return tr is not None and sum(
            e["stage"] == "finished" for e in tr["events"]
            if e["plane"] == "worker") >= finished
    assert wait_until(done, 20.0), _trace(cluster, rid)
    time.sleep(3 * HB_S)       # a late duplicate would show up now
    tr = _trace(cluster, rid)
    per = {}
    for e in tr["events"]:
        if e["plane"] == "worker":
            per.setdefault(e.get("source"), []).append(
                (e["stage"], sorted(set(e) - EVENT_KEYS)))
    role = roles or {}
    view = sorted((role.get(src, "worker"), stages)
                  for src, stages in per.items())
    return view, sorted(tr["attrs"].get("worker", {}))


def _both(port, ref, body, rid, **kw):
    out = []
    for tag, c in (("port", port), ("jax", ref)):
        generate(c, "/v1/chat/completions", body, False,
                 headers={"x-request-id": f"{rid}-{tag}"})
        out.append(_worker_view(c, f"{rid}-{tag}", **kw))
    return out


def test_plain_chat_spans_match_jax(epd):
    port, ref = epd
    mine, want = _both(port, ref, _chat(max_tokens=4), "obs-plain")
    assert mine == want
    assert [s for s, _ in mine[0][0][1]] == [
        "received", "scheduled", "first_token", "finished"]
    assert mine[1] == ["cache_hit_tokens", "correlation_header"]


def test_faulted_request_span_matches_jax(epd):
    """A request blamed by the step fault boundary: ``faulted``, never
    ``finished``, so its span stays on the worker (none ships) in both
    packages."""
    port, ref = epd
    seen = []
    for tag, c in (("port", port), ("jax", ref)):
        w = c.workers[0]
        w.failpoints.arm("worker.fault_step_req", mode="always",
                         value="POISON")
        try:
            body = _chat(text="POISON here ", max_tokens=4)
            status, _ = http_json("POST", c.master.http_address,
                                  "/v1/chat/completions", body,
                                  timeout=60.0,
                                  headers={"x-request-id": f"obs-f-{tag}"})
        finally:
            w.failpoints.disarm("worker.fault_step_req")
        assert status != 200
        assert wait_until(lambda: w.spans.get(f"obs-f-{tag}") is not None
                          and any(e["stage"] == "faulted" for e in
                                  w.spans.get(f"obs-f-{tag}")["events"]))
        local = w.spans.get(f"obs-f-{tag}")
        tr = _trace(c, f"obs-f-{tag}") or {"events": []}
        seen.append(([e["stage"] for e in local["events"]],
                     [e["stage"] for e in tr["events"]
                      if e["plane"] == "worker"]))
    assert seen[0] == seen[1]
    assert seen[0] == (["received", "scheduled", "faulted"], [])


@pytest.fixture(scope="module")
def encode_clusters(models, vit):
    """Per package: an ENCODE-only worker and a worker that asks it for
    its images, behind one master."""
    out = {}
    for tag in ("port", "jax"):
        c = Cluster()
        if tag == "port":
            enc = _port_worker(c, models, vit, InstanceType.ENCODE,
                               encode_only=True)
            _port_worker(c, models, vit)
        else:
            enc = jax_worker.Worker(
                jax_worker.WorkerOptions(
                    port=0, instance_type=JaxInstanceType.ENCODE,
                    encode_only=True, service_addr=c.master.rpc_address,
                    model=MODEL, heartbeat_interval_s=HB_S,
                    lease_ttl_s=3 * HB_S),
                c.server.store,
                engine_cfg=JaxEngineConfig(**ENGINE)).start()
            c.workers.append(enc)
            c.add_jax_worker()
        mgr = c.master.scheduler.instance_mgr
        assert wait_until(lambda: mgr.encode_instances() == [enc.name])
        out[tag] = c
    yield out
    for c in out.values():
        c.close()


def test_encoded_span_matches_jax(encode_clusters):
    body = _chat(*CHATS["one"], max_tokens=3)
    mine, want = _both(encode_clusters["port"], encode_clusters["jax"],
                       body, "obs-enc")
    assert mine == want
    stages = mine[0][0][1]
    assert [s for s, _ in stages] == ["received", "encoded", "scheduled",
                                      "first_token", "finished"]
    assert dict(stages)["encoded"] == ["cache_hits", "images", "ms",
                                       "remote"]
    for tag, c in encode_clusters.items():
        gen = c.workers[1]
        assert gen.encode_calls == 0, tag     # the remote encoder served


def test_pd_handoff_spans_match_jax(models):
    views = []
    for pkg in ("port", "jax"):
        c = PdCluster(models, pkg, pkg)
        try:
            roles = {c.prefill.name: "prefill", c.decode.name: "decode"}
            generate(c, "/v1/completions",
                     {"model": "tiny", "prompt": "hand me over",
                      "max_tokens": 5, "temperature": 0.0,
                      "ignore_eos": True}, False,
                     headers={"x-request-id": f"obs-pd-{pkg}"})
            views.append(_worker_view(c, f"obs-pd-{pkg}", finished=2,
                                      roles=roles))
        finally:
            c.close()
    assert views[0] == views[1]
    assert [r for r, _ in views[0][0]] == ["decode", "prefill"]


def test_failed_beat_requeues_spans(epd, monkeypatch):
    """The first beat that carries the chat's span fails in its send;
    the span goes back to the ring and the next beat delivers it: the
    master holds each stage once, as from a JAX worker."""
    port, ref = epd
    views = []
    for tag, c, mod in (("port", port, torch_worker),
                        ("jax", ref, jax_worker)):
        rid = f"obs-beat-{tag}"
        real = mod.http_json
        failed = []

        def flaky(method, addr, path, obj=None, *a, **kw):
            if path == "/rpc/heartbeat" and not failed and any(
                    s.get("request_id") == rid
                    for s in (obj or {}).get("spans", [])):
                failed.append(obj)
                raise ConnectionResetError("injected beat failure")
            return real(method, addr, path, obj, *a, **kw)

        monkeypatch.setattr(mod, "http_json", flaky)
        generate(c, "/v1/chat/completions", _chat(max_tokens=3), False,
                 headers={"x-request-id": rid})
        views.append(_worker_view(c, rid))
        monkeypatch.setattr(mod, "http_json", real)
        assert len(failed) == 1, tag
        assert c.workers[0].spans.get(rid) is None, tag   # shipped
    assert views[0] == views[1]
    assert [s for s, _ in views[0][0][0][1]] == [
        "received", "scheduled", "first_token", "finished"]


# ---------------------------------------------------------------------------
# The profiler
# ---------------------------------------------------------------------------

def test_profiler_catalog_and_events_match_jax():
    assert tprof.SECTIONS == jprof.SECTIONS
    assert tprof.HOTPATH_BUCKETS_MS == jprof.HOTPATH_BUCKETS_MS
    assert tprof.GC_PAUSE_BUCKETS_MS == jprof.GC_PAUSE_BUCKETS_MS
    for mod in (tprof, jprof):
        with pytest.raises(ValueError, match="closed catalog"):
            mod.section("not.a.section")
    keys = []
    for mod in (tprof, jprof):
        with mod.section("tokenize"):
            pass
        ev = [e for e in mod.recent_events() if e["name"] == "tokenize"]
        assert ev and ev[-1]["dur_ms"] >= 0.0
        keys.append(sorted(ev[-1]))
        assert mod.section_snapshot()["tokenize"]["ops"] >= 1
    assert keys[0] == keys[1]


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def _series(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_flush_metrics_families_match_jax(monkeypatch):
    """With lock sampling on, both profilers write the same families
    and series names into a registry."""
    texts = []
    for prof, locks, reg in ((tprof, tlocks, Registry),
                             (jprof, jlocks, JaxRegistry)):
        monkeypatch.setattr(locks, "PROFILE_SAMPLE", 1)
        lk = locks.make_lock("test.sampled", 50)
        with lk:
            pass
        with prof.section("span.write"):
            pass
        prof.register_thread_root("test.root")
        r = reg()
        prof.flush_metrics(r)
        prof.flush_metrics(r)       # the second scrape has a CPU%
        texts.append(r.render())
    assert _families(texts[0]) == _families(texts[1])
    assert _series(texts[0]) == _series(texts[1])
    assert {"xllm_lock_wait_ms", "xllm_lock_contended_total",
            "xllm_service_hotpath_ms", "xllm_thread_cpu_seconds_total",
            "xllm_gc_pause_ms", "xllm_process_rss_bytes",
            "xllm_process_cpu_percent"} <= _families(texts[0])
    assert 'xllm_thread_cpu_seconds_total{root="test.root"}' in texts[0]


PROFILER_FAMILIES = re.compile(
    r"^(xllm_service_hotpath_|xllm_lock_|xllm_thread_cpu_|xllm_process_"
    r"|xllm_gc_|xllm_http_conn_pool_|xllm_span_evictions)")


def test_worker_steptrace_sections_and_metrics_match_jax(epd):
    port, ref = epd
    fams = []
    for c in (port, ref):
        w = c.workers[0]
        generate(c, "/v1/chat/completions",
                 {**_chat(max_tokens=3), "stream": True}, True)
        st, body = http_json("GET", w.name, "/admin/steptrace?window_s=600")
        assert st == 200 and body["sections"], "no section recorded"
        assert {"sse.assemble", "span.write"} <= {
            e["name"] for e in body["sections"]}
        for _ in range(2):
            status, text = _scrape(w)
        fams.append({f for f in _families(text)
                     if PROFILER_FAMILIES.match(f)})
    assert fams[0] == fams[1]
    assert "xllm_span_evictions_total" in fams[0]
    assert "xllm_http_conn_pool_hits_total" in fams[0]


def _scrape(w):
    import http.client
    host, port = w.name.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Locks
# ---------------------------------------------------------------------------

def _lock_script(locks):
    """Acquisition orders, each 'ok' or 'violation'."""
    out = []
    cases = [((10, "a"), (20, "b")), ((20, "b"), (10, "a")),
             ((10, "a"), (10, "c")), ((5, "h"), (93, "r"), (94, "s")),
             ((94, "s"), (93, "r"))]
    for case in cases:
        made = [locks.make_lock(f"t.{n}", r) for r, n in case]
        taken = []
        try:
            for lk in made:
                lk.acquire()
                taken.append(lk)
            out.append("ok")
        except locks.LockOrderViolation:
            out.append("violation")
        finally:
            for lk in reversed(taken):
                lk.release()
    rl = locks.make_rlock("t.re", 30)
    with rl:
        with rl:                 # re-entry is not an order question
            out.append("reentrant")
    return out


@pytest.mark.expected_lock_violations
def test_lock_order_check_matches_jax():
    n = tlocks.violation_count()
    mine, want = _lock_script(tlocks), _lock_script(jlocks)
    assert mine == want == ["ok", "violation", "violation", "ok",
                            "violation", "reentrant"]
    assert tlocks.violation_count() == n + 3
    assert tlocks.LOCK_WAIT_BUCKETS_MS == jlocks.LOCK_WAIT_BUCKETS_MS


def _declared_ranks(pkg):
    """{name: rank} of every make_lock / make_rlock call in a package."""
    out = {}
    for path in (ROOT / pkg).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "make_lock", "make_rlock") and len(node.args) == 2 \
                    and all(isinstance(a, ast.Constant) for a in node.args):
                out.setdefault(node.args[0].value, set()).add(
                    node.args[1].value)
    return out


def test_shared_lock_names_keep_the_jax_ranks():
    mine = _declared_ranks("xllm_service_tpu_torch")
    ref = _declared_ranks("xllm_service_tpu")
    assert all(len(r) == 1 for r in mine.values()), mine
    shared = set(mine) & set(ref)
    assert {n: mine[n] for n in shared} == {n: ref[n] for n in shared}
    assert {"worker.hb", "worker.reg", "worker.live", "worker.engine",
            "kv_cache.tier", "worker.kvfetch", "coordination_net",
            "etcd.watches", "store_guard", "obs.spans"} <= shared
    # Every rank the port's own names use is stated in its table.
    doc = tlocks.__doc__
    for name in set(mine) - shared:
        assert re.search(rf"\b{next(iter(mine[name]))}\s+{re.escape(name)}",
                         doc), name


def test_f8_generate_takes_live_before_engine(epd):
    """F8: the port's generate registered its live request under
    ``worker.live`` while holding ``worker.engine`` (the JAX worker
    orders them live, then engine). Under XLLM_LOCK_CHECK the chat is
    served and the checker saw no inversion."""
    assert tlocks.enabled()
    port, _ = epd
    w = port.workers[0]
    assert isinstance(w._engine_lock, tlocks.CheckedLock)
    assert isinstance(w._live_lock, tlocks.CheckedLock)
    n = tlocks.violation_count()
    errors = []

    def chat(i):
        try:
            generate(port, "/v1/chat/completions",
                     _chat(text=f"f8 {i} ", max_tokens=3), i % 2 == 1)
        except Exception as e:  # noqa: BLE001 — collected
            errors.append(e)

    ts = [threading.Thread(target=chat, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert not errors
    assert tlocks.violations()[n:] == []
