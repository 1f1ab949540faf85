"""A pool of rank processes for the port's parallel tests (CPU, gloo).

``RankPool(n)`` spawns n processes once; ``pool.run(world, fn, *args)``
has ranks 0 .. world-1 each call ``fn(mesh, *args)`` with a fresh mesh
of ``world`` ranks over a gloo world rendezvousing at a ``FileStore`` in
the pool's directory (no TCP port), and returns the ranks' results in
rank order. A rank that raises fails the run with its traceback. Each
run leaves the world afterwards, so that the next run can make another
mesh in the same processes. The rank functions live here, beside the
pool, so that the spawned processes import neither JAX nor the test
modules.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
import uuid
from typing import Any, Dict, List

import numpy as np


def _serve(rank: int, tasks, results) -> None:
    os.environ.setdefault("XLLM_LOCK_CHECK", "1")
    import torch
    torch.set_num_threads(1)
    from xllm_service_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    while True:
        task = tasks.get()
        if task is None:
            return
        fn_name, spec, init, args = task
        mesh = None
        try:
            mesh = make_mesh(MeshSpec(**spec), rank, "cpu", "gloo", init)
            results.put((rank, True, globals()[fn_name](mesh, *args)))
        except BaseException:  # noqa: BLE001 — reported to the test
            results.put((rank, False, traceback.format_exc()))
        finally:
            if mesh is not None:
                mesh.close()


class RankPool:
    def __init__(self, n: int, directory: str) -> None:
        ctx = mp.get_context("spawn")
        self.directory = directory
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve,
                                  args=(r, self.tasks[r], self.results),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, spec: Dict[str, int], fn: str, *args,
            timeout: float = 180.0) -> List[Any]:
        world = int(np.prod(list(spec.values())))
        assert world <= len(self.procs)
        init = f"file://{os.path.join(self.directory, uuid.uuid4().hex)}"
        for r in range(world):
            self.tasks[r].put((fn, spec, init, args))
        out: Dict[int, Any] = {}
        errors = []
        for _ in range(world):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"{fn}: a rank did not answer in "
                                     f"{timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        assert not errors, "\n".join(errors)
        return [out[r] for r in range(world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# Rank functions: fn(mesh, *args) -> picklable result
# ---------------------------------------------------------------------------

def _tensors(tree, dtype=None):
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def ring(mesh, q, k, v, lengths):
    """This rank's ring attention over its sp block of q/k/v [B, T, H,
    D] (full arrays in, the local output block out)."""
    import torch
    from xllm_service_tpu_torch.parallel.ring import ring_attention
    n, r = mesh.size("sp"), mesh.index("sp")
    T = q.shape[1]
    blk = slice(r * T // n, (r + 1) * T // n)
    out = ring_attention(torch.from_numpy(q[:, blk]),
                         torch.from_numpy(k[:, blk]),
                         torch.from_numpy(v[:, blk]), mesh,
                         torch.from_numpy(lengths))
    return out.numpy()


def forward(mesh, cfg, params, prefill, decode, num_pages, page_size):
    """One sharded prefill then one decode over a fresh pool: returns
    (prefill logits, decode logits, MoE drops of each) as numpy.
    ``prefill``: (tokens, start, lengths, page_table); ``decode``:
    (tokens, positions, active, page_table)."""
    import torch
    from xllm_service_tpu_torch.models import transformer
    from xllm_service_tpu_torch.parallel import sharding
    shard = sharding.shard_params(_tensors(params), mesh, cfg)
    scfg = sharding.shard_config(cfg, mesh.spec)
    kv = transformer.init_kv_cache(scfg, num_pages, page_size, "cpu",
                                   torch.float32)
    toks, start, lengths, table = (torch.from_numpy(a) for a in prefill)
    d1 = torch.zeros((), dtype=torch.int64)
    logits, kv = transformer.forward_prefill(
        shard, scfg, toks.long(), start, lengths, kv, table,
        write_then_attend=False, moe_dropped=d1, mesh=mesh)
    dt, dpos, dact, dtable = (torch.from_numpy(a) for a in decode)
    d2 = torch.zeros((), dtype=torch.int64)
    dlogits, kv = transformer.forward_decode(
        shard, scfg, dt.long(), dpos, dact.bool(), kv, dtable,
        write_then_attend=False, moe_dropped=d2, mesh=mesh)
    return logits.numpy(), dlogits.numpy(), int(d1), int(d2)


def engine_streams(mesh, cfg, ecfg, params, prompts, max_tokens,
                   steps: int = 200):
    """A sharded engine serving ``prompts`` greedily: rank 0 returns
    (streams, census of prefill_ring steps, steps whose kind), the
    followers their runner calls."""
    from xllm_service_tpu_torch.runtime import ranks
    from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
    from xllm_service_tpu_torch.utils.types import SamplingParams
    eng = Engine(cfg, ecfg, params=_tensors(params), device="cpu",
                 mesh=mesh)
    if mesh.rank:
        return ranks.follow(eng, mesh)
    try:
        for i, p in enumerate(prompts):
            eng.add_request(EngineRequest(f"r{i}", list(p),
                            sampling=SamplingParams(max_tokens=max_tokens,
                                                    temperature=0.0)))
        toks: Dict[str, List[int]] = {f"r{i}": [] for i in range(len(prompts))}
        windows = []
        for _ in range(steps):
            if not eng.has_work():
                break
            for out in eng.step():
                toks[out.request_id].extend(out.new_token_ids)
            windows.append(eng.last_step_prefill_windows)
        report = eng.capture_report()
        return ([toks[f"r{i}"] for i in range(len(prompts))],
                report.get("prefill_ring", {}).get("eager_steps", {}),
                windows, eng.compile_report())
    finally:
        ranks.stop_followers(mesh)


def refusal(mesh, cfg, ecfg):
    """The message an Engine under this mesh raises with ``ecfg`` (None
    when it builds)."""
    from xllm_service_tpu_torch.runtime.engine import Engine
    try:
        Engine(cfg, ecfg, device="cpu", mesh=mesh)
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return None


def control_logits(mesh, cfg, ecfg, params, ids, next_id, T):
    """Rank 0's ``ranks.control`` forwards through a sharded engine: the
    whole-prompt prefill and one decode logits, the ring prefill's
    (sp > 1) and the counters of both."""
    from xllm_service_tpu_torch.runtime import ranks
    from xllm_service_tpu_torch.runtime.engine import Engine
    eng = Engine(cfg, ecfg, params=_tensors(params), device="cpu",
                 mesh=mesh)
    if mesh.rank:
        return ranks.follow(eng, mesh)
    try:
        ranks.control(eng, "reset")
        lp, ld = ranks.control(eng, "forward_logits", ids, next_id,
                               page_size=4)
        lr = (ranks.control(eng, "ring_logits", ids, T, page_size=4)
              if mesh.size("sp") > 1 else None)
        return lp, ld, lr, ranks.control(eng, "report")
    finally:
        ranks.stop_followers(mesh)


# ---------------------------------------------------------------------------
# The KV plane: one script of engine calls, run on a sharded engine's
# rank 0 (``kv_engine``) or, in the test process, on an unsharded port
# engine or a JAX engine (``run_kv_script`` with that package's request
# and sampling types)
# ---------------------------------------------------------------------------

def _np(x):
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_kv_script(eng, script, request=None, sampling=None):
    """Run ``script``, a list of ops, on ``eng``; returns one result per
    op (numpy for tensors):

    - ("serve", rid, prompt, max_tokens): a greedy request served to its
      end alone; its tokens;
    - ("hold", rid, prompt): a prefill held for the PD export (one
      token); the pages it holds;
    - ("export_held", rid): (tokens, k, v);
    - ("import", rid, prompt, tokens, k, v, max_tokens): the verdict;
    - ("drain",): every stream stepped to its end since the last drain
      ({rid: tokens}, an import's first token included);
    - ("export_blocks", prompt, n): (n, k, v) of the prompt's first n
      block digests, or None;
    - ("adopt", prompt, start, k, v): the blocks adopted;
    - ("tier", prompt): the host tier's (k, v) of each full block of the
      prompt (None where it holds none);
    - ("stats",): ``prefix_cache_stats()``;
    - ("pages", rid): the pages a live request holds;
    - ("block_pages", prompt, n): the pool page of each of the prompt's
      first n block digests (None where none).
    """
    if request is None:
        from xllm_service_tpu_torch.runtime.engine import EngineRequest
        from xllm_service_tpu_torch.utils.types import SamplingParams
        request, sampling = EngineRequest, SamplingParams
    out, streams = [], {}

    def drain():
        while eng.has_work():
            for o in eng.step():
                streams.setdefault(o.request_id, []).extend(
                    o.new_token_ids)

    for op in script:
        kind = op[0]
        if kind == "serve":
            _, rid, prompt, n = op
            eng.add_request(request(rid, list(prompt), sampling(
                max_tokens=n, temperature=0.0, ignore_eos=True)))
            drain()
            out.append(streams.pop(rid))
        elif kind == "hold":
            _, rid, prompt = op
            eng.add_request(request(rid, list(prompt), sampling(
                max_tokens=1, temperature=0.0), hold_after_finish=True))
            drain()
            streams.pop(rid, None)
            out.append(list(eng._held[rid].pages))
        elif kind == "export_held":
            tokens, k, v = eng.export_held(op[1])
            out.append((list(tokens), _np(k), _np(v)))
        elif kind == "import":
            _, rid, prompt, tokens, k, v, n = op
            ok = eng.import_sequence(request(rid, list(prompt), sampling(
                max_tokens=n, temperature=0.0, ignore_eos=True)),
                list(tokens), k, v)
            if ok:
                streams.setdefault(rid, []).append(tokens[-1])
            out.append(bool(ok))
        elif kind == "drain":
            drain()
            out.append(dict(streams))
            streams.clear()
        elif kind == "export_blocks":
            _, prompt, n = op
            got = eng.export_blocks(eng.prefix_cache.block_hashes(prompt)[:n])
            out.append(None if got is None
                       else (int(got[0]), _np(got[1]), _np(got[2])))
        elif kind == "adopt":
            _, prompt, start, k, v = op
            out.append(int(eng.adopt_blocks(list(prompt), start, k, v)))
        elif kind == "tier":
            blocks = []
            for h in eng.prefix_cache.block_hashes(op[1]):
                blk = eng.host_tier.peek(h) if eng.host_tier else None
                blocks.append(None if blk is None
                              else (_np(blk[0]), _np(blk[1])))
            out.append(blocks)
        elif kind == "stats":
            out.append(dict(eng.prefix_cache_stats()))
        elif kind == "pages":
            out.append(list(eng._by_id[op[1]].pages))
        elif kind == "block_pages":
            _, prompt, n = op
            out.append([eng.prefix_cache.page_of(h) for h in
                        eng.prefix_cache.block_hashes(prompt)[:n]])
        else:
            raise ValueError(f"unknown op {kind!r}")
    return out


def kv_engine(mesh, cfg, ecfg, params, script):
    """A sharded engine: rank 0 runs ``script`` (``run_kv_script``) and
    returns (its results, its pools, its collectives' counts); every
    follower follows, then returns its pools. Pools as numpy."""
    from xllm_service_tpu_torch.runtime import ranks
    from xllm_service_tpu_torch.runtime.engine import Engine
    eng = Engine(cfg, ecfg, params=_tensors(params), device="cpu",
                 mesh=mesh)
    if mesh.rank:
        ranks.follow(eng, mesh)
        return [p.numpy().copy() for p in eng.kv]
    try:
        out = run_kv_script(eng, script)
        return out, [p.numpy().copy() for p in eng.kv], dict(mesh.counts)
    finally:
        ranks.stop_followers(mesh)


def _complete(addr: str, prompt: str, max_tokens: int = 4):
    import json
    from http.client import HTTPConnection
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps(
        {"model": "tiny", "prompt": prompt, "max_tokens": max_tokens,
         "temperature": 0.0, "ignore_eos": True}),
        headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def worker_fault(mesh, cfg, ecfg, params, prompts, flag):
    """Rank 0 serves a worker on this mesh (its followers follow);
    rank 1 raises once in its MLP, in the first forward after the file
    ``flag`` appears, which rank 0 writes after its first request.
    Rank 0 returns, per prompt, (status, body, seconds), then the
    mesh's epoch; a follower its calls."""
    import os
    import time
    from xllm_service_tpu_torch.runtime import ranks
    if mesh.rank:
        from xllm_service_tpu_torch.models import transformer
        from xllm_service_tpu_torch.runtime.engine import Engine
        mlp = transformer._mlp

        def planted(*args, **kwargs):
            if os.path.exists(flag):
                os.remove(flag)
                raise RuntimeError(f"planted fault on rank {mesh.rank}")
            return mlp(*args, **kwargs)
        transformer._mlp = planted
        eng = Engine(cfg, ecfg, params=_tensors(params), device="cpu",
                     mesh=mesh, name="tiny")
        return ranks.follow(eng, mesh)
    from xllm_service_tpu_torch.runtime import worker
    w = worker.Worker(worker.WorkerOptions(model="tiny", device="cpu",
                                           warmup=False),
                      engine_cfg=ecfg, model_cfg=cfg,
                      params=_tensors(params), mesh=mesh).start()
    out = []
    try:
        for i, prompt in enumerate(prompts):
            if i == 1:
                open(flag, "w").close()
            t0 = time.monotonic()
            status, body = _complete(w.name, prompt)
            out.append((status, body, time.monotonic() - t0))
        return out, mesh.epoch, w._engine_loop_alive
    finally:
        w.stop()


def mesh_moves(mesh):
    """Rank 0 gathers every rank's tensor, sends each rank its part, and
    the ranks agree twice (all True, then rank 1 False). Returns (what
    rank 0 gathered or None, this rank's part, the agreements, the
    counts)."""
    import torch
    world = mesh.world
    x = torch.full((2, 3), float(mesh.rank))
    got = mesh.gather(x, list(range(world)))
    parts = ({r: torch.full((2, 3), 10.0 * r) for r in range(world)}
             if mesh.rank == 0 else None)
    mine = mesh.scatter(parts, (2, 3), torch.float32, "cpu")
    agreed = (mesh.agree(True), mesh.agree(mesh.rank != 1))
    return (None if got is None else [t.tolist() for t in got],
            mine.tolist(), agreed, dict(mesh.counts))


def reform_blocked(mesh):
    """Rank 0 re-forms the world while every other rank waits in an
    all-reduce it never joins: each waiting rank's collective fails,
    that rank re-forms too, and the new world's collectives meet.
    Returns (whether this rank's collective failed, the seconds to the
    new world, its epoch, an all-reduce over it, an agreement)."""
    import time
    import torch
    t0 = time.monotonic()
    failed = None
    if mesh.rank == 0:
        time.sleep(0.5)
        mesh.reform()
    else:
        try:
            mesh.all_reduce(torch.ones(4), "tp")
            failed = False
        except RuntimeError as exc:
            failed = True
            mesh.reform(exc)
    waited = time.monotonic() - t0
    y = mesh.all_reduce(torch.full((3,), float(mesh.rank + 1)), "tp")
    return failed, waited, mesh.epoch, y.tolist(), mesh.agree(True)


# ---------------------------------------------------------------------------
# The sharded worker's lifecycle and encode plane
# ---------------------------------------------------------------------------

def _post(addr: str, path: str, body, timeout: float = 120.0):
    import json
    from http.client import HTTPConnection
    host, port = addr.rsplit(":", 1)
    conn = HTTPConnection(host, int(port), timeout=timeout)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _texts(addr: str, model: str, prompts, **extra):
    out = []
    for prompt in prompts:
        status, body = _post(addr, "/v1/completions", {
            "model": model, "prompt": prompt, "max_tokens": 12,
            "temperature": 0.0, "ignore_eos": True, **extra})
        assert status == 200, body
        out.append(body["choices"][0]["text"])
    return out


def _seeded_init(cfg_params):
    """Make the engine's random init give ``params`` for each (config,
    params) pair: the weights the JAX engine draws from PRNGKey(0) for a
    model staged without a directory."""
    from xllm_service_tpu_torch.models import transformer
    init = transformer.init_params

    def seeded(cfg, generator, device):
        for c, p in cfg_params:
            if cfg == c:
                return _to_device(_tensors(p), device)
        return init(cfg, generator, device)
    transformer.init_params = seeded


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def life_worker(mesh, cfg, ecfg, params, forked, prompts, embed_inputs):
    """A tp worker on this mesh (rank 0; its followers run the model
    book of ``ranks.follow_launch``): texts, a sleep with a request in
    flight, a warm wake, ``/fork_master`` and a cold wake of
    ``forked`` = (name, config, params: what random-from-seed gives),
    ``/v1/embeddings``; with every rank's book (``Worker.mesh_book``)
    between. Rank 0 returns the record; a follower its calls."""
    import threading
    import time
    from xllm_service_tpu_torch.runtime import ranks, worker
    fname, fcfg, fparams = forked
    _seeded_init([(fcfg, fparams)])
    if mesh.rank:
        return ranks.follow_launch(ranks.Launch(
            cfg, ecfg, mesh.spec, ["cpu"] * mesh.world, "gloo", "",
            params=_tensors(params), model="tiny"), mesh)
    resolve = worker.resolve_model_config
    worker.resolve_model_config = lambda name, model_dir="": (
        fcfg if name == fname else resolve(name, model_dir))
    w = worker.Worker(worker.WorkerOptions(model="tiny", device="cpu",
                                           warmup=False),
                      engine_cfg=ecfg, model_cfg=cfg,
                      params=_tensors(params), mesh=mesh).start()
    out = {}
    try:
        out["before"] = _texts(w.name, "tiny", prompts)
        out["book_awake"] = w.mesh_book(digests=True)
        # A long request in flight at the sleep.
        inflight = {}

        def long():
            inflight["reply"] = _post(w.name, "/v1/completions", {
                "model": "tiny", "prompt": "a request in flight",
                "max_tokens": 200, "temperature": 0.0, "ignore_eos": True})
        t = threading.Thread(target=long)
        t.start()
        deadline = time.monotonic() + 30.0
        while not w._live_srid and time.monotonic() < deadline:
            time.sleep(0.005)
        out["sleep"] = _post(w.name, "/sleep", {"model": "tiny"})
        t.join(60.0)
        out["inflight"] = inflight.get("reply")
        out["book_asleep"] = w.mesh_book(digests=True)
        out["asleep_reply"] = _post(w.name, "/v1/completions", {
            "model": "tiny", "prompt": "hi", "max_tokens": 2})[0]
        out["wake"] = _post(w.name, "/wakeup", {"model": "tiny"})
        out["after"] = _texts(w.name, "tiny", prompts)
        out["fork"] = _post(w.name, "/fork_master", {"models": [fname]})
        out["book_forked"] = w.mesh_book()
        out["fork_wake"] = _post(w.name, "/wakeup", {"model": fname})
        rt = w.runtimes[fname]
        out["fork_mesh"] = (rt.mesh is w.mesh, rt.engine.mesh is w.mesh,
                            [rt.engine.shard_cfg.num_heads,
                             rt.engine.shard_cfg.num_kv_heads])
        out["forked"] = _texts(w.name, fname, prompts)
        out["book_both"] = w.mesh_book()
        out["embed"] = _post(w.name, "/v1/embeddings",
                             {"model": "tiny", "input": embed_inputs})
        return out
    finally:
        w.stop()


def pipeline_engine(mesh, cfg, ecfg, params, reqs):
    """A sharded engine serving ``reqs`` = (rid, prompt, sampling
    kwargs) from one step: rank 0 returns (streams, ``overlap_metrics``,
    every rank's ``decode_state``); a follower its calls."""
    from xllm_service_tpu_torch.runtime import ranks
    from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
    from xllm_service_tpu_torch.utils.types import SamplingParams
    eng = Engine(cfg, ecfg, params=_tensors(params), device="cpu",
                 mesh=mesh)
    if mesh.rank:
        return ranks.follow(eng, mesh)
    try:
        for rid, prompt, kw in reqs:
            eng.add_request(EngineRequest(rid, list(prompt),
                                          sampling=SamplingParams(**kw)))
        toks: Dict[str, List[int]] = {rid: [] for rid, _, _ in reqs}
        for _ in range(400):
            if not eng.has_work():
                break
            for o in eng.step():
                toks[o.request_id].extend(o.new_token_ids)
        return (toks, eng.overlap_metrics(),
                ranks.control(eng, "decode_state"))
    finally:
        ranks.stop_followers(mesh)


def image_worker(mesh, cfg, ecfg, params, tower, bodies):
    """A tp worker with ``tower`` = (vision config kwargs, params), the
    followers on ``ranks.follow_launch``; rank 0 returns each body's
    completion text, the image tokens spliced, every rank's collectives
    (``Control.report``) and its decode runner's staged rope deltas."""
    from xllm_service_tpu_torch.models import vision
    from xllm_service_tpu_torch.runtime import ranks, worker
    if mesh.rank:
        return ranks.follow_launch(ranks.Launch(
            cfg, ecfg, mesh.spec, ["cpu"] * mesh.world, "gloo", "",
            params=_tensors(params), model="tiny-vl"), mesh)
    vcfg = vision.VisionConfig(**tower[0])
    w = worker.Worker(worker.WorkerOptions(model="tiny-vl", device="cpu",
                                           warmup=False),
                      engine_cfg=ecfg, model_cfg=cfg,
                      params=_tensors(params), mesh=mesh,
                      vision_tower=(vcfg, _tensors(tower[1]))).start()
    try:
        with w._engine_lock:
            ranks.control(w.engine, "reset")
        texts = []
        for body in bodies:
            status, resp = _post(w.name, "/v1/completions", body)
            assert status == 200, resp
            texts.append(resp["choices"][0]["text"])
        with w._engine_lock:
            reps = ranks.control(w.engine, "report")
            states = ranks.control(w.engine, "decode_state")
        return (texts, w.engine.mm_spliced_tokens,
                [r["collectives"] for r in reps], [s[3] for s in states])
    finally:
        w.stop()
