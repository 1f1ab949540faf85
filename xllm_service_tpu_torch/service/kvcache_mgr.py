"""GlobalKVCacheMgr: cluster-wide prefix KV-cache index.

A copy of the JAX package's ``service/kvcache_mgr.py``: the same
behaviour and names, importing only this package (and no device code).

Rebuild of ``scheduler/managers/global_kvcache_mgr.{h,cpp}``: a map from
128-bit chained block digests to the set of instances holding that block,
tiered HBM → host-DRAM → SSD (reference CacheLocations, common/types.h:
272-317). ``match()`` walks a prompt's block-aligned prefix digests until
first miss and scores per-instance overlap (global_kvcache_mgr.cpp:71-129)
— the signal cache-aware routing maximizes. Heartbeats deliver per-worker
deltas (stored/offload/removed, :175-223); the master replica uploads
accumulated deltas to the coordination store under ``XLLM:CACHE:`` every
upload interval (:225-245) and non-masters learn the index by watching that
prefix (:131-173).

Digests travel as hex strings on the wire; in-memory keys are the raw
16-byte digests from ``utils.hashing`` (bit-identical to the worker's
page hashes, so service-side match and worker-side reuse agree exactly).
"""

from __future__ import annotations

import threading


from typing import Dict, Iterable, List, Optional, Set, Tuple

from xllm_service_tpu_torch.service.coordination import (
    KEY_CACHE, CoordinationStore)
from xllm_service_tpu_torch.utils.hashing import prefix_block_hashes
from xllm_service_tpu_torch.utils.locks import make_lock

TIER_HBM = "hbm"
TIER_DRAM = "dram"
TIER_SSD = "ssd"
_TIERS = (TIER_HBM, TIER_DRAM, TIER_SSD)
# Match-score weight per tier: an HBM hit saves more than a DRAM/SSD hit.
TIER_WEIGHT = {TIER_HBM: 1.0, TIER_DRAM: 0.7, TIER_SSD: 0.4}


class CacheLocations:
    """Which instances hold one block, per storage tier."""

    __slots__ = ("tiers",)

    def __init__(self) -> None:
        self.tiers: Dict[str, Set[str]] = {t: set() for t in _TIERS}

    @property
    def empty(self) -> bool:
        return not any(self.tiers.values())

    def holders(self) -> Set[str]:
        out: Set[str] = set()
        for s in self.tiers.values():
            out |= s
        return out


class GlobalKVCacheMgr:
    def __init__(self, store: CoordinationStore, block_size: int = 128,
                 seed: int = 0, is_master: bool = True) -> None:
        self.store = store
        self.block_size = block_size
        self.seed = seed
        self.is_master = is_master
        self._lock = make_lock("kvcache_mgr", 35)
        self._index: Dict[bytes, CacheLocations] = {}  # guarded-by: kvcache_mgr
        # Deltas accumulated since the last master upload, keyed by digest:
        # value None → block gone everywhere (delete the store key).
        self._dirty: Dict[bytes, Optional[Dict[str, List[str]]]] = {}  # guarded-by: kvcache_mgr
        self._watch_id: Optional[int] = None
        if not is_master:
            self._watch_id = store.add_watch(KEY_CACHE, self._on_watch)
        self._bootstrap()

    # ------------------------------------------------------------------
    # Bootstrap / replication
    # ------------------------------------------------------------------
    def _bootstrap(self) -> None:
        """Load the persisted index (global_kvcache_mgr.cpp:45-49).

        The watch is registered BEFORE this runs (no event gap), so
        ``_on_watch`` can already be firing on the store's dispatch
        thread — the index writes must happen under the lock (xlint
        thread-root-race finding XLINT13-003: ``GlobalKVCacheMgr._index``
        mutated from the init tail and the watch root with no common
        guard). The store read stays OUTSIDE the lock: it is network
        I/O for the etcd/remote stores (blocking-under-lock)."""
        items = self.store.get_prefix_json(KEY_CACHE)
        with self._lock:
            for key, val in items.items():
                digest = bytes.fromhex(key[len(KEY_CACHE):])
                self._apply_locations(digest, val)

    def _on_watch(self, event) -> None:
        ev_type, key, value = event
        digest = bytes.fromhex(key[len(KEY_CACHE):])
        with self._lock:
            if ev_type == "DELETE":
                self._index.pop(digest, None)
            else:
                import json
                self._apply_locations(digest, json.loads(value))

    def _apply_locations(self, digest: bytes, val: Dict[str, List[str]]
                         ) -> None:
        loc = CacheLocations()
        for tier in _TIERS:
            loc.tiers[tier] = set(val.get(tier, []))
        if loc.empty:
            self._index.pop(digest, None)
        else:
            self._index[digest] = loc

    # ------------------------------------------------------------------
    # Match
    # ------------------------------------------------------------------
    def match(self, token_ids: List[int]
              ) -> Tuple[int, Dict[str, float]]:
        """Walk block-aligned prefix digests until first global miss.

        Returns (num_matched_blocks, per-instance weighted overlap score in
        blocks). An instance's score counts only its *contiguous* prefix
        blocks — a hole in its copy ends its usable prefix, matching how the
        worker can only reuse contiguous leading pages."""
        matched, scores, _ = self.match_prefix_tiers(token_ids)
        return matched, scores

    def match_prefix_tiers(self, token_ids: List[int]
                           ) -> Tuple[int, Dict[str, float],
                                      Dict[str, List[str]]]:
        """``match()`` plus the evidence the fetch-vs-recompute planner
        needs: per instance, the best storage tier of EVERY block in its
        contiguous leading run (``holders[inst][i]`` = tier of block i).
        ``len(holders[inst])`` is the instance's usable prefix in blocks
        — unweighted, unlike the routing score."""
        hashes = prefix_block_hashes(token_ids, self.block_size, self.seed)
        scores: Dict[str, float] = {}
        holders: Dict[str, List[str]] = {}
        alive: Dict[str, bool] = {}
        matched = 0
        with self._lock:
            for idx, h in enumerate(hashes):
                loc = self._index.get(h)
                if loc is None or loc.empty:
                    break
                matched += 1
                block_holders: Dict[str, Tuple[float, str]] = {}
                for tier in _TIERS:
                    w = TIER_WEIGHT[tier]
                    for inst in loc.tiers[tier]:
                        cur = block_holders.get(inst)
                        if cur is None or w > cur[0]:
                            block_holders[inst] = (w, tier)
                for inst, (w, tier) in block_holders.items():
                    # An instance first seen past block 0 has a hole at the
                    # front — its copy is not a usable leading prefix.
                    if alive.get(inst, idx == 0):
                        scores[inst] = scores.get(inst, 0.0) + w
                        holders.setdefault(inst, []).append(tier)
                        alive[inst] = True
                for inst in list(alive):
                    if inst not in block_holders:
                        alive[inst] = False
        return matched, scores, holders

    def num_blocks(self) -> int:
        with self._lock:
            return len(self._index)

    # ------------------------------------------------------------------
    # Heartbeat ingestion (master path)
    # ------------------------------------------------------------------
    def record_updated_kvcaches(self, instance: str,
                                stored: Iterable[bytes] = (),
                                removed: Iterable[bytes] = (),
                                offloaded: Iterable[bytes] = (),
                                offloaded_ssd: Iterable[bytes] = ()
                                ) -> None:
        """Apply one worker's cache delta (global_kvcache_mgr.cpp:175-223).
        ``stored`` means the block is in HBM *now* — a restore from the
        worker's spill tier re-stores it, so any DRAM/SSD claim this
        instance held is superseded (the worker's tier consumed its
        copy). ``offloaded`` demotes HBM→DRAM (the worker's host-RAM
        spill tier); ``offloaded_ssd`` demotes DRAM→SSD (disk tier);
        ``removed`` drops the instance from every tier.

        Cross-list ordering within one delta is lost on the wire, so
        demotions apply BEFORE ``stored``: a block that spilled and was
        restored inside one beat (the common compound) ends HBM, which
        is its true final state."""
        with self._lock:
            for h in offloaded:
                loc = self._index.get(h)
                if loc is None:
                    continue
                loc.tiers[TIER_HBM].discard(instance)
                loc.tiers[TIER_DRAM].add(instance)
                self._mark_dirty(h, loc)
            for h in offloaded_ssd:
                loc = self._index.get(h)
                if loc is None:
                    continue
                loc.tiers[TIER_HBM].discard(instance)
                loc.tiers[TIER_DRAM].discard(instance)
                loc.tiers[TIER_SSD].add(instance)
                self._mark_dirty(h, loc)
            for h in stored:
                loc = self._index.setdefault(h, CacheLocations())
                loc.tiers[TIER_HBM].add(instance)
                loc.tiers[TIER_DRAM].discard(instance)
                loc.tiers[TIER_SSD].discard(instance)
                self._mark_dirty(h, loc)
            for h in removed:
                loc = self._index.get(h)
                if loc is None:
                    continue
                for tier in _TIERS:
                    loc.tiers[tier].discard(instance)
                if loc.empty:
                    del self._index[h]
                    self._dirty[h] = None
                else:
                    self._mark_dirty(h, loc)

    def remove_instance(self, instance: str) -> None:
        """Instance died: scrub it from every block (part of the etcd-DELETE
        cleanup path, instance_mgr.cpp:606-686)."""
        with self._lock:
            for h in list(self._index):
                loc = self._index[h]
                present = any(instance in loc.tiers[t] for t in _TIERS)
                if not present:
                    continue
                for tier in _TIERS:
                    loc.tiers[tier].discard(instance)
                if loc.empty:
                    del self._index[h]
                    self._dirty[h] = None
                else:
                    self._mark_dirty(h, loc)

    def _mark_dirty(self, h: bytes, loc: CacheLocations) -> None:
        self._dirty[h] = {t: sorted(loc.tiers[t]) for t in _TIERS
                          if loc.tiers[t]}

    # ------------------------------------------------------------------
    # Master upload (called from the scheduler's 3 s loop)
    # ------------------------------------------------------------------
    def upload_kvcache(self) -> int:
        """Flush accumulated deltas to the store (:225-245). Returns the
        number of keys written/deleted."""
        with self._lock:
            dirty, self._dirty = self._dirty, {}
        for h, val in dirty.items():
            key = KEY_CACHE + h.hex()
            if val is None:
                self.store.delete(key)
            else:
                self.store.put_json(key, val)
        return len(dirty)

    def close(self) -> None:
        if self._watch_id is not None:
            self.store.cancel_watch(self._watch_id)
