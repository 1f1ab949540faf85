"""Host-side bookkeeping of the paged KV pool: the page allocator, the
prefix-cache index, the host spill tier and the KV block codec.

The device pools live in ``models.transformer.init_kv_cache``; this
module owns which page holds what. A copy of the JAX package's
``runtime/kv_cache.py``. Pages are the unit of both allocation and
prefix caching: a full page of ``page_size`` tokens is content-addressed
by the chained MurmurHash3 digest of its tokens (``utils.hashing``), the
digest the reference master's cache index keys on, so a worker's local
hits and the cluster's cache-aware routing agree on block identity.

Page 0 is the NULL page that every writer drops and that no sequence
owns. A released page that holds registered content is not freed: it
stays reclaimable, in LRU order, until allocation pressure takes it, and
is reused meanwhile by any prompt that shares its prefix. With a host
tier the reclaimed content is copied to host memory first and restored
on a later hit.

The codec writes a JSON header line ``{"shape", "dtype"}`` and then the
raw K and V bytes. A bfloat16 block is written as the bytes of its
16-bit integer view under the dtype name ``bfloat16`` and read back the
same way, so the bytes equal the JAX codec's without ``ml_dtypes``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.utils.hashing import prefix_block_hashes
from xllm_service_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class KvCacheEvent:
    """Delta of the worker's prefix-cache content, shipped on heartbeats
    to the master's cache index: block digests ``stored`` and
    ``removed``; ``offloaded`` = spilled from the device pool to the host
    tier (still servable here, one tier down); ``offloaded_ssd`` =
    demoted from the host tier to disk."""

    stored: List[bytes] = dataclasses.field(default_factory=list)
    removed: List[bytes] = dataclasses.field(default_factory=list)
    offloaded: List[bytes] = dataclasses.field(default_factory=list)
    offloaded_ssd: List[bytes] = dataclasses.field(default_factory=list)

    def merge(self, other: "KvCacheEvent") -> None:
        self.stored.extend(other.stored)
        self.removed.extend(other.removed)
        self.offloaded.extend(other.offloaded)
        self.offloaded_ssd.extend(other.offloaded_ssd)

    @property
    def empty(self) -> bool:
        return not (self.stored or self.removed or self.offloaded
                    or self.offloaded_ssd)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(t.dtype)


def _raw_bytes(t) -> bytes:
    """The array's bytes in C order; a bfloat16 tensor through its
    16-bit integer view."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)     # the same bytes as uint16
        return t.numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def encode_kv_block(k, v, extra: Optional[Dict] = None) -> bytes:
    """One K/V pair (torch tensors or numpy arrays) as a header line
    ``{"shape", "dtype", **extra}`` followed by the K bytes and the V
    bytes."""
    head = json.dumps({"shape": list(k.shape), "dtype": _dtype_name(k),
                       **(extra or {})})
    return head.encode("utf-8") + b"\n" + _raw_bytes(k) + _raw_bytes(v)


def decode_kv_blob(meta: Dict, blob: bytes
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``encode_kv_block`` given the parsed header ``meta``:
    (k, v) as CPU tensors. Raises ValueError on a size mismatch."""
    shape = tuple(int(s) for s in meta["shape"])
    bf16 = meta["dtype"] == "bfloat16"
    np_dtype = np.dtype(np.int16 if bf16 else meta["dtype"])
    nbytes = int(np.prod(shape)) * np_dtype.itemsize
    if len(blob) != 2 * nbytes:
        raise ValueError(
            f"payload size mismatch: {len(blob)} != {2 * nbytes}")

    def part(raw: bytes) -> torch.Tensor:
        t = torch.from_numpy(
            np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy())
        return t.view(torch.bfloat16) if bf16 else t

    return part(blob[:nbytes]), part(blob[nbytes:])


def _nbytes(k, v) -> int:
    return int(k.nbytes) + int(v.nbytes)


class HostKvTier:
    """Bounded host-memory (plus optional disk) store of spilled KV
    pages, keyed by the block digest the prefix index uses.

    A page reclaimed from the device pool lands here instead of
    vanishing; a later prefix hit restores it into a fresh page. LRU
    within the byte budget; overflow demotes to the disk tier when one
    is configured (``kv_spill_dir`` with a positive ``kv_spill_disk_mb``),
    else drops the block. Its own lock guards it: the engine loop writes
    it, the heartbeat thread drains its events."""

    def __init__(self, capacity_bytes: int, disk_dir: str = "",
                 disk_capacity_bytes: int = 0) -> None:
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self.disk_dir = disk_dir
        self.disk_capacity_bytes = max(int(disk_capacity_bytes), 0)
        self._lock = make_lock("kv_cache.tier", 22)
        # hash → (k, v); insertion order ~ LRU.
        self._blocks: "collections.OrderedDict[bytes, Tuple]" = \
            collections.OrderedDict()
        self._bytes = 0
        # hash → file path of the disk tier; insertion order ~ LRU.
        self._disk: "collections.OrderedDict[bytes, str]" = \
            collections.OrderedDict()
        self._disk_bytes = 0
        self._pending = KvCacheEvent()
        self.spilled_blocks = 0       # lifetime host-tier admissions
        self.restored_blocks = 0      # lifetime restores to the pool
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)

    def put(self, h: bytes, k, v) -> bool:
        """Park one spilled page (host tensors) under its digest. False
        when the tier cannot hold it (the caller then reports the block
        removed, not offloaded)."""
        with self._lock:
            if h in self._blocks:
                self._blocks.move_to_end(h)
                return True
            n = _nbytes(k, v)
            if n > self.capacity_bytes:
                return False
            self._blocks[h] = (k, v)
            self._bytes += n
            self.spilled_blocks += 1
            while self._bytes > self.capacity_bytes and self._blocks:
                old_h, (ok, ov) = self._blocks.popitem(last=False)
                self._bytes -= _nbytes(ok, ov)
                self._demote_locked(old_h, ok, ov)
            return True

    def _demote_locked(self, h: bytes, k, v) -> None:
        """Host-tier overflow: write the block to the disk tier when one
        is configured, else it is gone and the cluster index must forget
        it. A directory without a positive budget is no disk tier."""
        if not self.disk_dir or self.disk_capacity_bytes <= 0:
            self._pending.removed.append(h)
            return
        n = _nbytes(k, v)
        path = os.path.join(self.disk_dir, h.hex() + ".kv")
        try:
            with open(path, "wb") as f:
                f.write(encode_kv_block(k, v))
        except OSError as e:
            logger.warning("kv disk spill of %s failed: %s", h.hex(), e)
            self._pending.removed.append(h)
            return
        self._disk[h] = path
        self._disk_bytes += n
        self._pending.offloaded_ssd.append(h)
        while self._disk_bytes > self.disk_capacity_bytes and self._disk:
            old_h, old_path = self._disk.popitem(last=False)
            try:
                self._disk_bytes -= os.path.getsize(old_path)
                os.unlink(old_path)
            except OSError:
                pass
            self._pending.removed.append(old_h)

    def peek(self, h: bytes) -> Optional[Tuple]:
        """The block's (k, v) without consuming it (the restore peeks
        first, so a failed allocation leaves the tier as it was). A disk
        block is read back from its file."""
        with self._lock:
            blk = self._blocks.get(h)
            if blk is not None:
                self._blocks.move_to_end(h)
                return blk
            path = self._disk.get(h)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                raw = f.read()
            nl = raw.index(b"\n")
            meta = json.loads(raw[:nl].decode("utf-8"))
            return decode_kv_blob(meta, raw[nl + 1:])
        except (OSError, ValueError, KeyError) as e:
            logger.warning("kv disk read of %s failed: %s", h.hex(), e)
            return None

    def pop(self, h: bytes) -> None:
        """Consume one block (it went back to the pool, whose ``stored``
        event supersedes the tier's claim)."""
        with self._lock:
            blk = self._blocks.pop(h, None)
            if blk is not None:
                self._bytes -= _nbytes(*blk)
                self.restored_blocks += 1
                return
            path = self._disk.pop(h, None)
            if path is not None:
                try:
                    self._disk_bytes -= os.path.getsize(path)
                    os.unlink(path)
                except OSError:
                    pass
                self.restored_blocks += 1

    def __contains__(self, h: bytes) -> bool:
        with self._lock:
            return h in self._blocks or h in self._disk

    def drain_event(self) -> KvCacheEvent:
        with self._lock:
            ev = self._pending
            self._pending = KvCacheEvent()
            return ev

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._blocks) + len(self._disk)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes


class PageAllocator:
    """Free-list page allocator over ids [1, num_pages)."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is NULL)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            self._free.append(p)


class PrefixCacheIndex:
    """Content-addressed index of full pages, with LRU reclamation.

    A page's life: allocated → filled by its sequence → registered under
    its chained digest, a reference count tracking its sharers → when
    the last owner releases it, reclaimable (still mapped, content
    intact) → reused by a later prefix hit, or reclaimed LRU-first under
    allocation pressure (spilled to the host tier first when one is
    wired). ``enable`` off makes lookups miss and registration a no-op,
    so every page goes straight back to the free list on release. Engine
    state: only the engine loop calls it."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 seed: int = 0, enable: bool = True) -> None:
        self.allocator = allocator
        self.page_size = page_size
        self.seed = seed
        self.enable = enable
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._ref: Dict[int, int] = collections.defaultdict(int)
        # page id → last-release time; insertion order ~ LRU.
        self._reclaimable: "collections.OrderedDict[int, float]" = \
            collections.OrderedDict()
        self._pending_event = KvCacheEvent()
        # Called with (hash, page) when a reclaimable registered page is
        # about to be reused: True = parked in a lower tier (event
        # ``offloaded``), False or no hook = gone (event ``removed``).
        self.spill_hook: Optional[Callable[[bytes, int], bool]] = None

    def block_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        return prefix_block_hashes(tokens, self.page_size, self.seed)

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens`` in whole pages: (pages,
        cached tokens). The pages are acquired for the caller, who
        releases them with ``release_pages``. Never the whole prompt:
        prefill needs one new token to sample from."""
        if not self.enable:
            return [], 0
        pages: List[int] = []
        for h in self.block_hashes(tokens):
            pid = self._by_hash.get(h)
            if pid is None:
                break
            pages.append(pid)
        while pages and len(pages) * self.page_size >= len(tokens):
            pages = pages[:-1]
        for pid in pages:
            self._acquire(pid)
        return pages, len(pages) * self.page_size

    def register_full_pages(self, tokens: Sequence[int],
                            pages: Sequence[int]) -> None:
        """Register every full page of a sequence under its chained
        digest; ``pages[i]`` holds tokens [i*ps, (i+1)*ps). Safe to call
        again as the sequence grows."""
        if not self.enable:
            return
        if pages and not pages[0]:
            # The leading page was trimmed by a sliding window: no block
            # of this chain is reachable from block 0 any more.
            return
        hashes = self.block_hashes(tokens)
        for i, h in enumerate(hashes):
            if i >= len(pages):
                break
            pid = pages[i]
            if not pid:
                # A trimmed page: blocks above the gap are unreachable,
                # so their digests are not advertised.
                break
            if self._hash_of.get(pid) == h:
                continue
            if h in self._by_hash:
                continue            # another page already holds it
            self._evict_mapping(pid)
            self._by_hash[h] = pid
            self._hash_of[pid] = h
            self._pending_event.stored.append(h)

    def _acquire(self, pid: int) -> None:
        self._ref[pid] += 1
        self._reclaimable.pop(pid, None)

    def acquire_pages(self, pages: Sequence[int]) -> None:
        for pid in pages:
            self._acquire(pid)

    def release_pages(self, pages: Sequence[int]) -> None:
        """The owner is done with these pages: registered ones become
        reclaimable (content kept), others go back to the allocator."""
        now = time.monotonic()
        for pid in pages:
            self._ref[pid] -= 1
            if self._ref[pid] > 0:
                continue
            del self._ref[pid]
            if pid in self._hash_of:
                self._reclaimable[pid] = now
                self._reclaimable.move_to_end(pid)
            else:
                self.allocator.free([pid])

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` acquired pages, reclaiming LRU cached pages if the free
        list is short; None when even that does not cover ``n``. A
        reclaimed page's content is still intact, so this is where it
        may spill."""
        need = n - self.allocator.num_free
        while need > 0 and self._reclaimable:
            pid, _ = self._reclaimable.popitem(last=False)
            self._evict_mapping(pid, spillable=True)
            self.allocator.free([pid])
            need -= 1
        pages = self.allocator.alloc(n)
        if pages is not None:
            for pid in pages:
                self._acquire(pid)
        return pages

    def _evict_mapping(self, pid: int, spillable: bool = False) -> None:
        h = self._hash_of.pop(pid, None)
        if h is None:
            return
        self._by_hash.pop(h, None)
        if spillable and self.spill_hook is not None:
            try:
                if self.spill_hook(h, pid):
                    self._pending_event.offloaded.append(h)
                    return
            except Exception as e:  # noqa: BLE001 — a failed spill is a
                # plain eviction, never an allocation failure
                logger.warning("kv spill of page %d failed: %s", pid, e)
        self._pending_event.removed.append(h)

    def register_blocks(self, hashes: Sequence[bytes],
                        pages: Sequence[int]) -> int:
        """Register digest→page mappings positionally (the adoption of
        blocks fetched from another worker, whose chain below may resolve
        through the host tier, so no full list of lead pages exists).
        The chain's reachability is the caller's contract. A digest
        already owned is skipped (exactly once: the redundant page stays
        unregistered and frees on release). Returns the number
        registered."""
        n = 0
        for h, pid in zip(hashes, pages):
            if self._hash_of.get(pid) == h or h in self._by_hash:
                continue
            self._evict_mapping(pid)
            self._by_hash[h] = pid
            self._hash_of[pid] = h
            self._pending_event.stored.append(h)
            n += 1
        return n

    def pages_for_hashes(self, hashes: Sequence[bytes]) -> List[int]:
        """The pages of a digest run, stopping at the first miss (a fetch
        serves a contiguous leading run), ACQUIRED for the caller: pinned
        against reclamation while an export gathers them, and released
        with ``release_pages``."""
        pages: List[int] = []
        for h in hashes:
            pid = self._by_hash.get(h)
            if pid is None:
                break
            pages.append(pid)
        for pid in pages:
            self._acquire(pid)
        return pages

    def page_of(self, h: bytes) -> Optional[int]:
        return self._by_hash.get(h)

    def drain_event(self) -> KvCacheEvent:
        ev = self._pending_event
        self._pending_event = KvCacheEvent()
        return ev

    @property
    def num_cached_pages(self) -> int:
        return len(self._by_hash)

    @property
    def num_reclaimable(self) -> int:
        """Pages holding cached content with no live owner: capacity a
        load report counts as free."""
        return len(self._reclaimable)


def pool_gather(kv: Tuple[torch.Tensor, ...], pid: int
                ) -> Tuple[torch.Tensor, ...]:
    """Host copies of page ``pid`` of every pool ([L, ps, H, D] each).
    The gather is enqueued on the current stream before any later write
    to the page, and waited for, so it holds the content the page held
    when called."""
    return tuple(p[:, pid].to("cpu", copy=True) for p in kv)
