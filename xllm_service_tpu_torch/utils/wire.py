"""Versioned wire contract of the worker's JSON messages.

A copy of the JAX package's ``utils/wire.py`` over this package's own
dataclasses, so a worker of either package speaks to the same service:

- ``wire_messages()``: the registry of the dataclasses whose JSON
  crosses the worker-service boundary (registration record, heartbeat,
  generation pushes).
- ``describe()``: the schema derived from them (field name -> type),
  the form ``tests/wire_contract_v1.json`` pins.
- ``stamp()`` / ``check_version()``: envelope version negotiation.
  Producers stamp top-level messages with ``"v"``; consumers accept any
  version and log once when a peer is newer.
- ``validate()``: a payload's structure against its schema.

Compatibility rules: unknown fields are ignored on decode, every field
has a default, and a renamed or retyped field is a breaking change that
bumps ``WIRE_VERSION``.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import typing
from typing import Any, Dict, List

logger = logging.getLogger(__name__)

WIRE_VERSION = 1


def wire_messages() -> Dict[str, type]:
    # Imported lazily to keep utils.wire import-cycle-free.
    from xllm_service_tpu_torch.service.instance_types import (
        Heartbeat, InstanceMetaInfo, LatencyMetrics, LoadMetrics)
    from xllm_service_tpu_torch.utils.types import (
        LogProb, RequestOutput, SamplingParams, SequenceOutput, Status,
        Usage)
    return {
        "Status": Status,
        "Usage": Usage,
        "LogProb": LogProb,
        "SequenceOutput": SequenceOutput,
        "RequestOutput": RequestOutput,
        "SamplingParams": SamplingParams,
        "InstanceMetaInfo": InstanceMetaInfo,
        "LoadMetrics": LoadMetrics,
        "LatencyMetrics": LatencyMetrics,
        "Heartbeat": Heartbeat,
    }


def _type_str(tp: Any) -> str:
    """Normalize a type annotation to a stable, comparable string."""
    if isinstance(tp, str):
        return tp.replace(" ", "")
    origin = typing.get_origin(tp)
    if origin is not None:
        args = ",".join(_type_str(a) for a in typing.get_args(tp))
        name = getattr(origin, "__name__", str(origin))
        return f"{name}[{args}]"
    if isinstance(tp, type):
        if issubclass(tp, enum.Enum):
            return f"enum:{tp.__name__}"
        return tp.__name__
    if tp is Any:
        # str(typing.Any) depends on the Python version; pin one spelling.
        return "Any"
    return str(tp).replace(" ", "")


def describe() -> Dict[str, Any]:
    """The wire contract of ``wire_messages()`` as a JSON-able dict."""
    messages: Dict[str, Any] = {}
    for name, cls in sorted(wire_messages().items()):
        hints = typing.get_type_hints(cls)
        messages[name] = {
            f.name: _type_str(hints.get(f.name, f.type))
            for f in dataclasses.fields(cls)}
    return {"wire_version": WIRE_VERSION, "messages": messages}


# -- envelope versioning ----------------------------------------------------

def stamp(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp a top-level wire envelope with the producer's version."""
    payload["v"] = WIRE_VERSION
    return payload


_warned: set = set()


def check_version(payload: Dict[str, Any], what: str) -> int:
    """Peer-version check on ingestion: returns the peer's version
    (0 = unstamped). Logs once per message kind when the peer is newer;
    decoding still proceeds under the compatibility rules."""
    try:
        v = int(payload.get("v") or 0)
    except (TypeError, ValueError):   # garbage stamp from a foreign peer
        v = 0
    if v > WIRE_VERSION and what not in _warned:
        _warned.add(what)
        logger.warning("peer speaks wire v%d > ours v%d on %s — unknown "
                       "fields will be ignored", v, WIRE_VERSION, what)
    return v


# -- structural validation --------------------------------------------------

_JSON_OK = {
    "str": str, "int": int, "float": (int, float), "bool": bool,
}


def validate(name: str, payload: Dict[str, Any]) -> List[str]:
    """Check ``payload`` against message ``name``'s schema. Returns a list
    of problems (empty = conformant). Unknown payload fields are not
    problems; wrong types and non-dict payloads are."""
    cls = wire_messages().get(name)
    if cls is None:
        return [f"unknown wire message {name!r}"]
    if not isinstance(payload, dict):
        return [f"{name}: payload is {type(payload).__name__}, not object"]
    problems: List[str] = []
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name not in payload:
            continue                      # defaults cover absence
        val = payload[f.name]
        ts = _type_str(hints.get(f.name, f.type))
        base = ts.split("[")[0]
        if val is None:
            if not ts.startswith("Optional") and "None" not in ts:
                problems.append(f"{name}.{f.name}: null but {ts}")
        elif base in _JSON_OK:
            if not isinstance(val, _JSON_OK[base]) \
                    or (base != "bool" and isinstance(val, bool)):
                problems.append(
                    f"{name}.{f.name}: {type(val).__name__} != {ts}")
        elif base in ("list", "List"):
            if not isinstance(val, list):
                problems.append(
                    f"{name}.{f.name}: {type(val).__name__} != {ts}")
        elif base in ("dict", "Dict"):
            if not isinstance(val, dict):
                problems.append(
                    f"{name}.{f.name}: {type(val).__name__} != {ts}")
        elif base.startswith("enum:"):
            # str enums serialize as strings, IntEnums as ints.
            if not isinstance(val, (str, int)):
                problems.append(
                    f"{name}.{f.name}: enum value must be string or int")
    return problems
