"""The PD handoff's device wire between two worker processes on one host:
CUDA IPC.

The counterpart of the JAX package's ``runtime/kv_wire.py`` (a PJRT
transfer server). The prefill worker stages the exported [L, n,
page_size, H, D] K/V block in a buffer of its own and hands the decode
worker a ticket inside the ``/kv/import`` meta line instead of the bytes;
the decode worker maps the buffer, waits on the producer's event on its
own stream, copies the block into fresh tensors and scatters them into
its pools. Any failure degrades to the host shuttle (the worker's
``_serve_pd_prefill``), so the wire adds no failure mode.

- ``DeviceWire.stage(k, v)`` copies k then v into a staging segment
  (``cudaMalloc``, once, then reused: the caching allocator's
  sub-blocks and expandable segments cannot be exported) and records the
  segment's interprocess event; it returns the ticket's uuid. The
  segments stay reserved for the life of the process, outside the
  caching allocator, so their total is capped (``MAX_STAGING_BYTES``,
  eight segments of the smallest size): a stage that finds no free segment and no room for a
  new one waits for a release up to ``BUSY_WAIT_S``, then raises
  ``WireBusy`` and the worker takes the host shuttle; such stages are
  counted (``busy``), and ``wire_stats()`` reads the reserved bytes for
  ``/metrics``.
- ``DeviceWire.stage_one(t)`` stages one tensor the same way (the EPD
  embeddings, JAX ``kv_wire.py`` ``stage_one``), in the same segments
  and with the same ``release``; ``pull_one(ticket)`` reads it.
- ``DeviceWire.ticket(uuid)`` is the ``transfer`` dict of the meta line:
  the segment's memory and event handles (hex), the offset of V, the
  shape, dtype and byte count, and the producer's pid.
- ``pull_block(ticket)`` maps the segment (cached per producer segment:
  ``cudaIpcOpenMemHandle`` is slow), waits and copies, and synchronizes
  its stream so that the producer may reuse the segment once
  ``/kv/import`` answers.
- ``DeviceWire.release(uuid, leaked)`` frees the segment for the next
  stage; a ``leaked`` one (a pull that may still be reading it) stays
  reserved and is counted. (The JAX wire's ``drain``, a self-pull that
  frees a transfer server's registration, has nothing to free here.)

The 424 answers of ``/kv/import`` keep the JAX package's meaning:
``wire-unsupported:`` (``WireUnsupported``: this peer can never pull, so
the producer stops offering it, as for a ticket of the consumer's own
process, whose handle CUDA cannot open), ``wire-nopull:``
(``WireNoPull``: no copy started, the segment is untouched) and
``wire-pull:`` (a pull that failed midway).

The runtime calls are ``csrc/kv_ipc.cu``, built with the kernels by
``ops/kernels/_build.py`` and loaded with ``ctypes``. Without a GPU,
or with ``XLLM_KV_DEVICE_WIRE=0``, ``get_device_wire()`` is None and the
host shuttle runs.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

# The smallest staging segment: a llama3-1b block of a 128-token prompt
# is 4 MiB, so a few prompts share none.
_MIN_SEGMENT = 64 << 20

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# The cap on this process's staging segments: eight of the smallest.
MAX_STAGING_BYTES = 8 * _MIN_SEGMENT
# How long a stage waits for a segment to be released before the worker
# takes the host shuttle (a release follows the peer's answer, ms later).
BUSY_WAIT_S = 5.0

_lock = threading.Lock()
_wire: Optional["DeviceWire"] = None
_unsupported = False


class WireUnsupported(RuntimeError):
    """This pair of processes can never move a block over the wire: the
    producer should stop offering it to this peer."""


class WireBusy(RuntimeError):
    """No staging segment is free and the cap leaves no room for a new
    one: this block takes the host shuttle."""


class WireNoPull(RuntimeError):
    """The pull failed before any copy started: the staged block is
    untouched."""


def _lib() -> ctypes.CDLL:
    from xllm_service_tpu_torch.ops.kernels import _build
    lib = _build.load("kv_ipc")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.kv_ipc_alloc.argtypes = [ctypes.c_int, sz, pp, ctypes.c_char_p,
                                 pp, ctypes.c_char_p]
    lib.kv_ipc_copy.argtypes = [vp, vp, sz, vp]
    lib.kv_ipc_record.argtypes = [vp, vp]
    lib.kv_ipc_open.argtypes = [ctypes.c_int, ctypes.c_char_p, pp]
    lib.kv_ipc_open_event.argtypes = [ctypes.c_char_p, pp]
    lib.kv_ipc_close.argtypes = [vp, vp]
    lib.kv_ipc_wait.argtypes = [vp, vp]
    return lib


def _check(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class _Segment:
    __slots__ = ("ptr", "nbytes", "mem_handle", "event", "event_handle",
                 "uuid", "leaked")

    def __init__(self, ptr, nbytes, mem_handle, event, event_handle):
        self.ptr, self.nbytes = ptr, nbytes
        self.mem_handle, self.event = mem_handle, event
        self.event_handle = event_handle
        self.uuid = 0           # the staged ticket, 0 = free
        self.leaked = False


class DeviceWire:
    """This process's staging segments for outbound KV blocks, and its
    mappings of other processes' segments for inbound ones."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = torch.device(device or "cuda")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = _lib()
        self._hbytes = self._lib.kv_ipc_handle_bytes()
        self._mu = threading.Lock()
        self._released = threading.Condition(self._mu)
        self.max_bytes = MAX_STAGING_BYTES
        self.busy = 0
        self._segments: List[_Segment] = []
        self._staged: Dict[int, Tuple[_Segment, Dict[str, Any]]] = {}
        self._next_uuid = 1
        self.leaked = 0
        # (producer pid, memory handle hex) -> (pointer, event).
        self._opened: Dict[Tuple[int, str], Tuple[ctypes.c_void_p,
                                                    ctypes.c_void_p]] = {}
        self.address = f"cuda-ipc:{os.getpid()}"

    # -- producer -----------------------------------------------------
    def reserved_bytes(self) -> int:
        return sum(s.nbytes for s in self._segments)

    def _segment_for(self, nbytes: int) -> _Segment:
        """A free segment of at least ``nbytes``, a new one within the
        cap, or, after waiting for a release, ``WireBusy``. Called
        under ``_mu``."""
        size = max(_MIN_SEGMENT, 1 << max(nbytes - 1, 0).bit_length())
        deadline = None
        while True:
            free = [s for s in self._segments
                    if not s.uuid and not s.leaked and s.nbytes >= nbytes]
            if free:
                return min(free, key=lambda s: s.nbytes)
            if self.reserved_bytes() + size <= self.max_bytes:
                return self._new_segment(size)
            now = time.monotonic()
            # Only a staged segment large enough can help: a release
            # frees no reserved bytes, and a leaked one is never freed.
            if deadline is None and \
                    any(s.uuid and s.nbytes >= nbytes
                        for s in self._segments):
                deadline = now + BUSY_WAIT_S
            if deadline is None or now >= deadline:
                self.busy += 1
                raise WireBusy(
                    f"no staging segment for {nbytes} B: "
                    f"{self.reserved_bytes()} B of {self.max_bytes} "
                    f"reserved ({self.leaked} leaked)")
            self._released.wait(deadline - now)

    def _new_segment(self, size: int) -> _Segment:
        ptr, event = ctypes.c_void_p(), ctypes.c_void_p()
        mh = ctypes.create_string_buffer(self._hbytes)
        eh = ctypes.create_string_buffer(self._hbytes)
        _check("cudaMalloc / IPC export", self._lib.kv_ipc_alloc(
            self.device.index, size, ctypes.byref(ptr), mh,
            ctypes.byref(event), eh))
        seg = _Segment(ptr, size, mh.raw.hex(), event, eh.raw.hex())
        self._segments.append(seg)
        return seg

    def stage(self, k: torch.Tensor, v: torch.Tensor) -> int:
        """Copy (k, v) into a staging segment on the current stream and
        record its event; returns the uuid of the ticket. The segment is
        held until ``release``."""
        if k.shape != v.shape or k.dtype != v.dtype:
            raise ValueError("k and v differ in shape or dtype")
        return self._stage((k, v))

    def stage_one(self, t: torch.Tensor) -> int:
        """``stage`` for one tensor (the EPD embeddings): its ticket has
        no ``v_offset``, and ``pull_one`` reads it."""
        return self._stage((t,))

    def _stage(self, parts: Tuple[torch.Tensor, ...]) -> int:
        if any(t.device != self.device for t in parts):
            raise ValueError(f"stage needs tensors on {self.device}")
        parts = tuple(t.contiguous() for t in parts)
        nb = parts[0].numel() * parts[0].element_size()
        with self._mu:
            seg = self._segment_for(len(parts) * nb)
            uuid = self._next_uuid
            self._next_uuid += 1
            seg.uuid = uuid
        stream = _stream()
        for i, t in enumerate(parts):
            _check("staging copy", self._lib.kv_ipc_copy(
                ctypes.c_void_p(seg.ptr.value + i * nb),
                ctypes.c_void_p(t.data_ptr()), nb, stream))
        _check("event record", self._lib.kv_ipc_record(seg.event, stream))
        ticket = {"addr": self.address, "uuid": uuid, "pid": os.getpid(),
                  "handle": seg.mem_handle, "event": seg.event_handle,
                  "offset": 0, "nbytes": nb, "shape": list(parts[0].shape),
                  "dtype": str(parts[0].dtype).replace("torch.", "")}
        if len(parts) == 2:
            ticket["v_offset"] = nb
        with self._mu:
            self._staged[uuid] = (seg, ticket)
        return uuid

    def ticket(self, uuid: int) -> Dict[str, Any]:
        with self._mu:
            return dict(self._staged[uuid][1])

    def release(self, uuid: int, leaked: bool = False) -> None:
        """Free the uuid's segment for the next stage; ``leaked``: a copy
        may still be reading it, so it stays reserved, and is counted."""
        with self._mu:
            entry = self._staged.pop(uuid, None)
            if entry is None:
                return
            seg = entry[0]
            seg.uuid = 0
            if leaked:
                seg.leaked = True
                self.leaked += 1
            else:
                self._released.notify_all()
        if leaked:
            logger.warning("device-wire uuid %d abandoned mid-transfer; "
                           "its segment stays reserved (%d so far)",
                           uuid, self.leaked)

    def staged_count(self) -> int:
        with self._mu:
            return len(self._staged)

    # -- consumer -----------------------------------------------------
    def _open(self, tr: Dict[str, Any]
              ) -> Tuple[ctypes.c_void_p, ctypes.c_void_p]:
        key = (int(tr["pid"]), str(tr["handle"]))
        with self._mu:
            hit = self._opened.get(key)
        if hit is not None:
            return hit
        ptr, event = ctypes.c_void_p(), ctypes.c_void_p()
        mh = bytes.fromhex(str(tr["handle"]))
        eh = bytes.fromhex(str(tr["event"]))
        if len(mh) != self._hbytes or len(eh) != self._hbytes:
            raise ValueError("bad handle size in the ticket")
        _check("cudaIpcOpenMemHandle", self._lib.kv_ipc_open(
            self.device.index, mh, ctypes.byref(ptr)))
        rc = self._lib.kv_ipc_open_event(eh, ctypes.byref(event))
        if rc != 0:
            self._lib.kv_ipc_close(ptr, None)
            _check("cudaIpcOpenEventHandle", rc)
        with self._mu:
            self._opened[key] = (ptr, event)
        return ptr, event

    def pull(self, tr: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ticket's block as fresh tensors on this device; see
        ``pull_block`` for the exceptions."""
        k, v = self._pull(tr, ("offset", "v_offset"))
        return k, v

    def pull_one(self, tr: Dict[str, Any]) -> torch.Tensor:
        """A ``stage_one`` ticket's tensor, fresh on this device."""
        (t,) = self._pull(tr, ("offset",))
        return t

    def _pull(self, tr: Dict[str, Any],
              offsets: Tuple[str, ...]) -> List[torch.Tensor]:
        if int(tr.get("pid", -1)) == os.getpid():
            raise WireUnsupported(
                "a process cannot open its own CUDA IPC handle")
        try:
            ptr, event = self._open(tr)
        except Exception as e:  # noqa: BLE001 — nothing was copied yet
            raise WireNoPull(f"open of {tr.get('addr')} failed: {e}")
        _check("stream wait", self._lib.kv_ipc_wait(event, _stream()))
        out = _copy_out(self._lib, ptr, tr, self.device, offsets)
        # The producer reuses the segment once the peer answers.
        torch.cuda.current_stream(self.device).synchronize()
        return out


def _copy_out(lib, base: ctypes.c_void_p, tr: Dict[str, Any],
              device: torch.device,
              offsets: Tuple[str, ...]) -> List[torch.Tensor]:
    shape = tuple(int(s) for s in tr["shape"])
    dtype = _DTYPES[str(tr["dtype"])]
    nb = int(tr["nbytes"])
    out = []
    for key in offsets:
        t = torch.empty(shape, dtype=dtype, device=device)
        if t.numel() * t.element_size() != nb:
            raise ValueError("ticket shape and byte count disagree")
        _check("pull copy", lib.kv_ipc_copy(
            ctypes.c_void_p(t.data_ptr()),
            ctypes.c_void_p(base.value + int(tr[key])), nb, _stream()))
        out.append(t)
    return out


def get_device_wire() -> Optional[DeviceWire]:
    """This process's wire, or None without a GPU, with
    ``XLLM_KV_DEVICE_WIRE=0``, or when its library did not build or
    load. The first call builds and loads it."""
    global _wire, _unsupported
    if os.environ.get("XLLM_KV_DEVICE_WIRE", "auto") in ("0", "off"):
        return None
    with _lock:
        if _wire is None and not _unsupported:
            if not torch.cuda.is_available():
                _unsupported = True
                return None
            try:
                _wire = DeviceWire()
            except Exception as e:  # noqa: BLE001 — no wire: the shuttle
                logger.info("kv device wire unavailable (%s); host "
                            "shuttle", e)
                _unsupported = True
        return _wire


def wire_stats() -> Dict[str, int]:
    """This process's staging bytes reserved, stages refused for lack of
    room and segments leaked; zeros while no wire was made (a scrape
    does not make one)."""
    wire = _wire
    if wire is None:
        return {"reserved_bytes": 0, "busy": 0, "leaked": 0}
    with wire._mu:
        return {"reserved_bytes": wire.reserved_bytes(),
                "busy": wire.busy, "leaked": wire.leaked}


def peek_device_wire() -> Optional[DeviceWire]:
    """This process's wire if one was made, without making one."""
    return _wire


def _wire_for(tr: Dict[str, Any]) -> DeviceWire:
    wire = get_device_wire()
    if wire is None:
        raise WireUnsupported("no device wire in this process")
    if "handle" not in tr:
        # Another wire's ticket (the JAX package's transfer server).
        raise WireUnsupported("not a CUDA IPC ticket")
    for key in ("pid", "event", "shape", "dtype", "nbytes"):
        if key not in tr:
            raise WireNoPull(f"bad transfer ticket: no {key!r}")
    return wire


def pull_block(tr: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode side's pull of a staged (k, v) block. The exception
    tells the producer what to do with its segment: ``WireUnsupported``
    (never offer this peer again), ``WireNoPull`` (untouched, free it),
    anything else (a copy may have started)."""
    return _wire_for(tr).pull(tr)


def pull_one(tr: Dict[str, Any]) -> torch.Tensor:
    """The requester's pull of a ``stage_one`` ticket (the EPD
    embeddings), with ``pull_block``'s exceptions."""
    return _wire_for(tr).pull_one(tr)
