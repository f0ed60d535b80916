"""OpenTelemetry trace export — OTLP/HTTP+JSON, no SDK dependency.

Reference: ``model_gateway/src/observability/otel_trace.rs`` — spans around
request handling exported to an OTLP collector, correlated with request ids,
W3C ``traceparent`` propagation in and out.  The reference uses the OTel
Rust SDK over OTLP/gRPC; this environment has no otel library, so spans are
built directly in the OTLP JSON encoding (a standard collector transport:
``POST {endpoint}/v1/traces``) and shipped by a batching background task.

Enabled by ``--otel-endpoint`` (off by default — zero overhead when off).

The port's copy of ``smg_tpu/gateway/tracing.py``, unchanged but for its imports
and the exporter's scope name.
"""

from __future__ import annotations

import asyncio
import contextvars
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.tracing")


def _hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    name: str
    trace_id: str  # 32 hex chars
    span_id: str = field(default_factory=lambda: _hex(8))
    parent_span_id: str = ""
    kind: int = 2  # SPAN_KIND_SERVER
    start_ns: int = field(default_factory=time.time_ns)
    end_ns: int = 0
    attributes: dict = field(default_factory=dict)
    status_code: int = 0  # 0 unset, 1 ok, 2 error

    def end(self, error: bool = False) -> None:
        self.end_ns = time.time_ns()
        self.status_code = 2 if error else 1

    def set(self, key: str, value) -> None:
        self.attributes[key] = value

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_otlp(self) -> dict:
        def attr_value(v):
            if isinstance(v, bool):
                return {"boolValue": v}
            if isinstance(v, int):
                return {"intValue": str(v)}
            if isinstance(v, float):
                return {"doubleValue": v}
            return {"stringValue": str(v)}

        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_span_id} if self.parent_span_id else {}),
            "name": self.name,
            "kind": self.kind,
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns or time.time_ns()),
            "attributes": [
                {"key": k, "value": attr_value(v)}
                for k, v in self.attributes.items()
            ],
            "status": {"code": self.status_code},
        }


_HEX_DIGITS = frozenset("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX_DIGITS for c in s)


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """W3C traceparent -> (trace_id, parent_span_id), or None if absent or
    malformed (a malformed header starts a fresh trace, per spec).

    Field lengths alone are not enough: ``00-zz..-..-01`` would propagate a
    garbage trace id into every exported span, so every field must be actual
    (case-normalized) hex and the ids non-zero."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4 or len(parts[0]) != 2 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    if len(parts[3]) != 2 or not all(_is_hex(p) for p in parts):
        return None
    if parts[0] == "ff":  # forbidden version value, per spec
        return None
    if parts[1] == "0" * 32 or parts[2] == "0" * 16:
        return None
    return parts[1], parts[2]


class OtelTracer:
    """Span factory + batching OTLP/HTTP exporter."""

    def __init__(self, endpoint: str, service_name: str = "smg-tpu",
                 flush_interval: float = 2.0, max_batch: int = 512,
                 max_buffer: int = 8192):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.flush_interval = flush_interval
        self.max_batch = max_batch
        self.max_buffer = max_buffer
        self._buffer: list[Span] = []
        self._task: asyncio.Task | None = None
        self._session = None
        self.exported = 0
        self.dropped = 0

    def start_span(self, name: str, traceparent: str | None = None,
                   parent: Span | None = None, kind: int = 2) -> Span:
        if parent is not None:
            return Span(name=name, trace_id=parent.trace_id,
                        parent_span_id=parent.span_id, kind=kind)
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            return Span(name=name, trace_id=ctx[0], parent_span_id=ctx[1],
                        kind=kind)
        return Span(name=name, trace_id=_hex(16), kind=kind)

    def record(self, span: Span) -> None:
        """Queue a finished span; drops (and counts) past the buffer cap so
        a dead collector can't grow memory without bound."""
        if span.end_ns == 0:
            span.end()
        if len(self._buffer) >= self.max_buffer:
            self.dropped += 1
            return
        self._buffer.append(span)

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._pump())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # drain everything, not just one max_batch slice — shutdown must not
        # silently discard buffered spans
        while self._buffer:
            before = len(self._buffer)
            await self.flush()
            if len(self._buffer) >= before:  # collector down: counted as dropped
                break
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def _pump(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval)
            try:
                await self.flush()
            except Exception:
                logger.exception("otel flush failed")

    async def flush(self) -> None:
        if not self._buffer:
            return
        import aiohttp

        batch, self._buffer = self._buffer[:self.max_batch], self._buffer[self.max_batch:]
        payload = {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": "smg_tpu_torch.gateway"},
                    "spans": [s.to_otlp() for s in batch],
                }],
            }]
        }
        if self._session is None:
            self._session = aiohttp.ClientSession()
        try:
            async with self._session.post(
                self.endpoint + "/v1/traces", json=payload,
                timeout=aiohttp.ClientTimeout(total=10),
            ) as resp:
                if resp.status >= 400:
                    logger.warning("otel collector returned %d", resp.status)
                    self.dropped += len(batch)
                else:
                    self.exported += len(batch)
        except Exception as e:
            # collector down: spans in this batch are dropped, later spans
            # keep buffering — export must never wedge request handling
            logger.warning("otel export failed: %s", e)
            self.dropped += len(batch)


# ---- engine-stage child spans (queue → tokenize → prefill → decode →
# detokenize).  The otel middleware parks the request's SERVER span and the
# tracer in contextvars; pipeline stages anywhere down-stack (admission,
# router dispatch, detokenize) open INTERNAL children of it without threading
# tracer references through every constructor.  Contextvars propagate through
# the request's task tree, so stages land under the right trace even with
# many requests in flight. ----

SPAN_KIND_INTERNAL = 1

current_span: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "otel_current_span", default=None
)
current_tracer: contextvars.ContextVar["OtelTracer | None"] = contextvars.ContextVar(
    "otel_current_tracer", default=None
)


def ambient_traceparent() -> str | None:
    """W3C traceparent of the ambient request span (worker-hop metadata),
    or None when no trace is active.  The ONE place propagation headers are
    built — regular and PD dispatch legs must not diverge."""
    span = current_span.get()
    return span.traceparent if span is not None else None


def ambient_trace_id() -> str | None:
    """Trace id of the ambient request span (in-proc engine link)."""
    span = current_span.get()
    return span.trace_id if span is not None else None


def start_stage(name: str, **attrs) -> Span | None:
    """Open a child span of the ambient request span; None when tracing is
    off (zero overhead — no tracer, no span objects)."""
    tracer = current_tracer.get()
    parent = current_span.get()
    if tracer is None or parent is None:
        return None
    span = tracer.start_span(name, parent=parent, kind=SPAN_KIND_INTERNAL)
    for k, v in attrs.items():
        span.set(k, v)
    return span


def end_stage(span: Span | None, error: bool = False, **attrs) -> None:
    """Finish + record a stage span (no-op for None)."""
    if span is None:
        return
    for k, v in attrs.items():
        span.set(k, v)
    span.end(error=error)
    tracer = current_tracer.get()
    if tracer is not None:
        tracer.record(span)


@contextmanager
def stage(name: str, **attrs):
    """``with stage("engine.tokenize"): ...`` — ambient child span around a
    pipeline stage; exceptions mark the span errored and re-raise."""
    span = start_stage(name, **attrs)
    try:
        yield span
    except BaseException:
        end_stage(span, error=True)
        raise
    end_stage(span)
