"""KV handoff connectors for PD (prefill/decode) disaggregation — the port's
copy of ``smg_tpu/engine/kv_connector.py``.

- ``host``   — gather the pages and copy them to host memory (CPU tensors):
  the portable seam, serialisable over gRPC as raw bytes.
- ``device`` — keep the gathered pages as tensors on the exporting engine's
  card; the decode engine scatters them into its cache with a device-to-
  device copy and no host staging.  Both engines live in one process on
  one card; the import refuses a payload on another device.

The reference's third connector, ``transfer`` (``jax.experimental.transfer``
pulls across hosts), has no counterpart: ``get_connector("transfer")``
raises.  ``--kv-connector auto`` picks ``device`` whenever both legs
advertise support, else ``host``.
"""

from __future__ import annotations

import torch


class HostKvConnector:
    """Host-mediated payload (CPU tensors; bytes on the gRPC wire)."""

    name = "host"

    def export(self, runner, pages: list[int]):
        return runner.export_pages(pages)

    def import_(self, runner, pages: list[int], k, v) -> None:
        runner.import_pages(pages, k, v)


class DeviceKvConnector:
    """Device-to-device handoff on one card (no host staging)."""

    name = "device"

    def export(self, runner, pages: list[int]):
        return runner.export_pages_device(pages)

    def import_(self, runner, pages: list[int], k, v) -> None:
        runner.import_pages_device(pages, k, v)


_CONNECTORS = {c.name: c for c in (HostKvConnector(), DeviceKvConnector())}


def get_connector(name: str):
    try:
        return _CONNECTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown kv connector {name!r}; have {sorted(_CONNECTORS)}"
        ) from None


def resolve_for_payload(k):
    """Connector that lands a given KV payload: a CUDA tensor goes by
    ``device``, anything else (a CPU tensor, bytes rebuilt on the host) by
    ``host``."""
    on_card = isinstance(k, torch.Tensor) and k.device.type == "cuda"
    return _CONNECTORS["device" if on_card else "host"]


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A device payload copied to host memory (for a decode worker that
    takes only host bytes), after its export's ``ready`` event."""
    ready = getattr(t, "ready", None)
    if ready is not None:
        torch.cuda.current_stream(t.device).wait_event(ready)
    return t.cpu()
