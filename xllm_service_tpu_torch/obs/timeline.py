"""Cluster-merged Perfetto/chrome-trace export.

A copy of the JAX package's ``obs/timeline.py``: the same behaviour and
names, importing only this package (and no device code).

``GET /admin/timeline?seconds=N`` on the master merges three evidence
streams into one chrome://tracing- and Perfetto-loadable JSON document:

- **service-plane request spans** (obs/spans.py): each request becomes
  a track of "X" duration slices, one per consecutive stage pair
  (received→admitted→scheduled→…), on the master process;
- **hot-path section slices** (obs/profiler.py event tail): the PR-18
  section timers, one track per thread, on whichever plane recorded
  them;
- **worker step records** (obs/steptrace.py): one "engine" track per
  worker instance with an "X" slice per engine iteration, per-phase
  child slices laid out inside it (sequential placement — the ledger
  carries durations, not offsets, so sub-slices are attribution, not
  exact timing), plus counter tracks ("C") for KV usage and batch
  occupancy sampled at every step.

Flow events ("s"/"t"/"f", one flow id per request id) stitch a request
from its ``received`` stage on the master through the engine steps that
carried it on a worker — the artifact the PD-migration/sharded-serving
ROADMAP items will be debugged with.

Determinism is part of the contract (tier-1 pins it byte-for-byte):
instances sort by name, pids/tids/flow-ids are assigned in sorted
order, timestamps are integer microseconds relative to the earliest
event, and ``render()`` serializes with sorted keys and fixed
separators. Two builds over the same inputs are identical bytes.

``CHROME_PHASES`` is the CLOSED catalog of chrome-trace "ph" values
this exporter may emit — xlint rule ``steptrace-schema`` pins every
``{"ph": ...}`` literal in the tree to it, so a typo'd phase can't
silently produce an unloadable trace.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

# The closed chrome-trace event-phase catalog: X = complete slice,
# M = metadata (process/thread names), C = counter sample, s/t/f =
# flow start/step/finish, i = instant.
CHROME_PHASES: Tuple[str, ...] = ("X", "M", "C", "s", "t", "f", "i")

# Pid of the master process track; workers are assigned 2.. in sorted
# instance-name order.
MASTER_PID = 1


def _us(t_wall: float, t0: float) -> int:
    return max(0, int(round((t_wall - t0) * 1e6)))


def _meta(pid: int, tid: int, what: str, name: str) -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def build_timeline(*, service_id: str,
                   spans: List[Dict[str, Any]],
                   sections: List[Dict[str, Any]],
                   workers: Dict[str, Dict[str, Any]],
                   window_s: float = 60.0,
                   master_counters: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Any]:
    """Merge spans + section slices + worker step records into one
    chrome-trace dict. ``spans`` is SpanStore.tail() output;
    ``sections`` is profiler.recent_events() (master-side);
    ``workers`` maps instance name → {"steps": [...], "sections":
    [...]} (each worker's ring pull or heartbeat book). ``window_s``
    clips everything older than the newest event minus the window."""
    # ---- collect every wall timestamp first: t0 anchors the trace.
    walls: List[float] = []
    for span in spans:
        for ev in span.get("events", []):
            walls.append(float(ev.get("t_wall", 0.0)))
    for ev in sections:
        walls.append(float(ev.get("t_wall", 0.0)))
    for wname in workers:
        for rec in workers[wname].get("steps", []):
            walls.append(float(rec.get("t_wall", 0.0)))
        for ev in workers[wname].get("sections", []):
            walls.append(float(ev.get("t_wall", 0.0)))
    walls = [w for w in walls if w > 0.0]
    if not walls:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "metadata": {"service_id": service_id, "window_s":
                             window_s, "instances": []}}
    newest = max(walls)
    horizon = newest - window_s
    t0 = min(w for w in walls if w >= horizon)

    events: List[Dict[str, Any]] = []
    instance_names = sorted(workers)
    pids = {name: MASTER_PID + 1 + i
            for i, name in enumerate(instance_names)}

    # ---- process/thread metadata tracks ------------------------------
    events.append(_meta(MASTER_PID, 0, "process_name",
                        f"service:{service_id}"))
    events.append(_meta(MASTER_PID, 1, "thread_name", "requests"))
    events.append(_meta(MASTER_PID, 2, "thread_name", "hotpath"))
    for name in instance_names:
        events.append(_meta(pids[name], 0, "process_name",
                            f"worker:{name}"))
        events.append(_meta(pids[name], 1, "thread_name", "engine"))
        events.append(_meta(pids[name], 2, "thread_name", "hotpath"))

    # ---- flow ids: one per request id BOTH planes saw inside the
    # window (a span with service stages AND ≥1 step that carried it) —
    # so every emitted flow is complete (one "s" … one "f") by
    # construction, the invariant tools/trace_view.py enforces. A
    # span-only rid (steps evicted/not pulled) gets slices, no flow.
    step_rids = set()
    for name in instance_names:
        for rec in workers[name].get("steps", []):
            if float(rec.get("t_wall", 0.0)) >= horizon:
                step_rids.update(rec.get("members") or ())
    svc_rids = {
        span.get("request_id", "") for span in spans
        if span.get("request_id")
        and any(e.get("plane") == "service"
                and float(e.get("t_wall", 0.0)) >= horizon
                for e in span.get("events", []))}
    rids = sorted(svc_rids & step_rids)
    flow_ids = {rid: i + 1 for i, rid in enumerate(rids)}

    # ---- service-plane spans → per-request stage slices + flow "s" ---
    for span in sorted(spans, key=lambda s: s.get("request_id", "")):
        rid = span.get("request_id", "")
        evs = [e for e in span.get("events", [])
               if float(e.get("t_wall", 0.0)) >= horizon]
        evs.sort(key=lambda e: (float(e.get("t_wall", 0.0)),
                                str(e.get("stage", ""))))
        svc = [e for e in evs if e.get("plane") == "service"]
        for a, b in zip(svc, svc[1:]):
            ts = _us(float(a["t_wall"]), t0)
            dur = max(1, _us(float(b["t_wall"]), t0) - ts)
            events.append({
                "ph": "X", "pid": MASTER_PID, "tid": 1,
                "ts": ts, "dur": dur,
                "name": f"{a.get('stage')}→{b.get('stage')}",
                "cat": "span", "args": {"request_id": rid}})
        if svc and rid in flow_ids:
            # Flow start rides the first service-plane stage slice.
            events.append({
                "ph": "s", "pid": MASTER_PID, "tid": 1,
                "ts": _us(float(svc[0]["t_wall"]), t0),
                "name": "request", "cat": "flow",
                "id": flow_ids[rid], "args": {"request_id": rid}})
        # Worker-plane stages merged into the span ring (heartbeats)
        # land on that worker's engine track as instants.
        for e in evs:
            if e.get("plane") != "worker":
                continue
            src = e.get("source", "")
            pid = pids.get(src)
            if pid is None:
                continue
            events.append({
                "ph": "i", "pid": pid, "tid": 1,
                "ts": _us(float(e["t_wall"]), t0),
                "name": f"{rid}:{e.get('stage')}", "cat": "span",
                "s": "t", "args": {"request_id": rid}})

    # ---- hot-path section slices (master + per-worker tails) ---------
    def _section_events(tail: List[Dict[str, Any]], pid: int) -> None:
        for ev in tail:
            wall = float(ev.get("t_wall", 0.0))
            if wall < horizon:
                continue
            dur_ms = float(ev.get("dur_ms", 0.0))
            ts = _us(wall - dur_ms / 1000.0, t0)
            events.append({
                "ph": "X", "pid": pid, "tid": 2, "ts": ts,
                "dur": max(1, int(round(dur_ms * 1000.0))),
                "name": str(ev.get("name", "")), "cat": "hotpath",
                "args": {"thread": str(ev.get("thread", ""))}})

    _section_events(sections, MASTER_PID)
    for name in instance_names:
        _section_events(workers[name].get("sections", []), pids[name])

    # ---- worker step records → engine slices, phase sub-slices,
    #      counter tracks, and flow "t"/"f" stitches -------------------
    finished_flow: Dict[str, Tuple[int, int]] = {}
    for name in instance_names:
        pid = pids[name]
        recs = [r for r in workers[name].get("steps", [])
                if float(r.get("t_wall", 0.0)) >= horizon]
        recs.sort(key=lambda r: int(r.get("seq", 0)))
        for rec in recs:
            step_ms = float(rec.get("step_ms", 0.0))
            end = float(rec.get("t_wall", 0.0))
            ts = _us(end - step_ms / 1000.0, t0)
            dur = max(1, int(round(step_ms * 1000.0)))
            args = {k: rec.get(k) for k in
                    ("seq", "kind", "model", "prefill_tokens",
                     "decode_tokens", "attn_dispatches", "ragged",
                     "mfu", "bound", "debt_ms")
                    if k in rec}
            events.append({
                "ph": "X", "pid": pid, "tid": 1, "ts": ts,
                "dur": dur, "name": f"step:{rec.get('kind', '?')}",
                "cat": "step", "args": args})
            # Phase sub-slices: sequential within the parent, clamped
            # to its duration (durations, not offsets — attribution).
            cursor = ts
            budget = ts + dur
            for phase in sorted(rec.get("phases", {})):
                ms = float(rec["phases"][phase])
                if ms <= 0.0 or cursor >= budget:
                    continue
                sub = min(max(1, int(round(ms * 1000.0))),
                          budget - cursor)
                events.append({
                    "ph": "X", "pid": pid, "tid": 1, "ts": cursor,
                    "dur": sub, "name": phase, "cat": "phase",
                    "args": {"ms": round(ms, 3)}})
                cursor += sub
            # Counter samples at every step: ≥1 counter track per
            # worker (KV usage + live batch occupancy).
            if "kv_usage" in rec:
                events.append({
                    "ph": "C", "pid": pid, "tid": 0, "ts": ts,
                    "name": "kv_usage",
                    "args": {"kv_usage":
                             round(float(rec["kv_usage"]), 4)}})
            members = rec.get("members") or ()
            events.append({
                "ph": "C", "pid": pid, "tid": 0, "ts": ts,
                "name": "batch", "args": {"running": len(members)}})
            # Flow stitches: a step that carried a known request id
            # gets a "t" riding its slice; the LAST such step per rid
            # is upgraded to the flow finish below.
            for rid in sorted(members):
                if rid in flow_ids:
                    finished_flow[rid] = (pid, ts)
                    events.append({
                        "ph": "t", "pid": pid, "tid": 1, "ts": ts,
                        "name": "request", "cat": "flow",
                        "id": flow_ids[rid],
                        "args": {"request_id": rid}})
    if master_counters:
        for cname in sorted(master_counters):
            events.append({
                "ph": "C", "pid": MASTER_PID, "tid": 0,
                "ts": _us(newest, t0), "name": cname,
                "args": {cname: master_counters[cname]}})
    for rid in sorted(finished_flow):
        pid, ts = finished_flow[rid]
        events.append({
            "ph": "f", "pid": pid, "tid": 1, "ts": ts, "bp": "e",
            "name": "request", "cat": "flow", "id": flow_ids[rid],
            "args": {"request_id": rid}})

    # Deterministic event order: chrome-trace consumers don't require
    # sorting, but byte-stability does.
    events.sort(key=lambda e: (int(e.get("ts", -1)),
                               int(e.get("pid", 0)),
                               int(e.get("tid", 0)),
                               str(e.get("ph", "")),
                               str(e.get("name", ""))))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "service_id": service_id,
            "window_s": window_s,
            "instances": instance_names,
        },
    }


def render(trace: Dict[str, Any]) -> str:
    """Canonical byte-stable serialization (sorted keys, fixed
    separators) — what /admin/timeline returns and what the merge-
    determinism test pins byte-for-byte."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":"))
