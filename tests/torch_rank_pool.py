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


def engine_refusals(mesh, cfg, ecfg):
    """The messages a sharded engine's unsharded paths raise: the PD
    export, the PD import, the block export and adoption, an image
    request."""
    import numpy as np
    from xllm_service_tpu_torch.runtime.engine import Engine, EngineRequest
    eng = Engine(cfg, ecfg, device="cpu", mesh=mesh)
    calls = [
        lambda: eng.export_held("x"),
        lambda: eng.import_sequence(EngineRequest("x", [1, 2]), [1, 2],
                                    None, None),
        lambda: eng.export_blocks([b"x"]),
        lambda: eng.adopt_blocks([1, 2], 0, None, None),
        lambda: eng.add_request(EngineRequest(
            "x", [1, 2], mm_embeds=np.zeros((1, cfg.hidden_size),
                                            np.float32),
            mm_positions=[0])),
    ]
    out = []
    for c in calls:
        try:
            c()
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return out


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
