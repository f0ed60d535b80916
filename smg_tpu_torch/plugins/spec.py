"""Plugin middleware contract: the port's copy of ``smg_tpu/plugins/spec.py``.

Behavioral match for the reference's WASM component interface
(``crates/wasm/src/interface/spec.wit`` — world ``smg``): plugins export
``on-request`` / ``on-response`` hooks returning one of three actions —
``continue``, ``reject(status)``, or ``modify(headers/body/status)``.  The
extension language here is Python (loaded modules, not WASM components —
this framework's runtime is Python, so in-process modules are the idiomatic
extension point), but the contract, ordering, and fault isolation semantics
mirror the reference host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union


@dataclass
class PluginRequest:
    """Mirror of spec.wit ``request``."""

    method: str
    path: str
    query: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    request_id: str = ""
    now_epoch_ms: int = 0


@dataclass
class PluginResponse:
    """Mirror of spec.wit ``response``."""

    status: int
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""


@dataclass
class Continue:
    """Pass through unchanged."""


@dataclass
class Reject:
    """Short-circuit with a status code (spec.wit ``reject(u16)``)."""

    status: int
    message: str = ""


@dataclass
class Modify:
    """Adjust the request/response in flight (spec.wit ``modify-action``)."""

    status: int | None = None
    headers_set: dict[str, str] = field(default_factory=dict)
    headers_add: dict[str, str] = field(default_factory=dict)
    headers_remove: list[str] = field(default_factory=list)
    body_replace: bytes | None = None


Action = Union[Continue, Reject, Modify]
