"""KV handoff connectors for PD (prefill/decode) disaggregation — the port's
copy of ``smg_tpu/engine/kv_connector.py``.

- ``host``   — gather the pages and copy them to host memory (CPU tensors):
  the portable seam, serialisable over gRPC as raw bytes.
- ``device`` — keep the gathered pages as tensors on the exporting engine's
  card; the decode engine scatters them into its cache with a device-to-
  device copy and no host staging.  Both engines live in one process on
  one card; the import refuses a payload on another device.
- ``transfer`` — the gathered pages stay on the exporting engine's device
  as an offer of its ``TransferManager`` (``engine/kv_transfer.py``); only
  a pull descriptor crosses the gRPC control channel, and the decode worker
  pulls the bulk bytes device to device (CUDA IPC between the processes of
  one host).

``--kv-connector auto`` picks ``device`` whenever both legs keep KV on the
card, else ``transfer`` when every leg supports it and runs on one host,
else ``host``.
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


class TransferKvConnector:
    """Device pull between worker processes (``engine/kv_transfer.py``):
    export gathers pages on the device and OFFERS them under a uuid on the
    engine's pull server; only the (address, uuid, shape, dtype) descriptor
    crosses the gRPC control channel, and the decode worker pulls the bulk
    bytes device to device."""

    name = "transfer"

    def export(self, runner, pages: list[int]):
        k, v = runner.export_pages_device(pages)
        mgr = runner.kv_transfer
        uuid = mgr.offer([k, v])
        descriptor = {
            "transfer_address": mgr.address,
            "transfer_uuid": uuid,
            "kv_shape": tuple(k.shape),
            "kv_dtype": str(k.dtype).removeprefix("torch."),
        }
        return descriptor, descriptor  # (k-slot, v-slot): metadata only

    def import_(self, runner, pages: list[int], k, v) -> None:
        """``k`` is the descriptor dict from ``export``."""
        desc = k
        shape, dtype = tuple(desc["kv_shape"]), desc["kv_dtype"]
        kk, vv = runner.kv_transfer.pull(
            desc["transfer_address"], int(desc["transfer_uuid"]),
            [(shape, dtype), (shape, dtype)],
        )
        runner.import_pages_device(pages, kk, vv)


_CONNECTORS = {
    c.name: c
    for c in (HostKvConnector(), DeviceKvConnector(), TransferKvConnector())
}


def get_connector(name: str):
    try:
        return _CONNECTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown kv connector {name!r}; have {sorted(_CONNECTORS)}"
        ) from None


def resolve_for_payload(k):
    """Connector that lands a given KV payload: a pull descriptor goes by
    ``transfer``, a CUDA tensor by ``device``, anything else (a CPU tensor,
    bytes rebuilt on the host) by ``host``."""
    if isinstance(k, dict) and "transfer_address" in k:
        return _CONNECTORS["transfer"]
    on_card = isinstance(k, torch.Tensor) and k.device.type == "cuda"
    return _CONNECTORS["device" if on_card else "host"]


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A device payload copied to host memory (for a decode worker that
    takes only host bytes), after its export's ``ready`` event."""
    ready = getattr(t, "ready", None)
    if ready is not None:
        torch.cuda.current_stream(t.device).wait_event(ready)
    return t.cpu()
