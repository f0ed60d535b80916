"""Probe the port's ``transfer`` KV route between two processes of one host.

    python3 scripts/probe_kv_transfer.py [--device cuda|cpu] [--mb 46]

A spawned process offers a seeded tensor pair on its ``TransferManager``
(``smg_tpu_torch/engine/kv_transfer.py``) and sends back (address, uuid);
this process pulls the pair, compares it bitwise with the same seeded
tensors made here, pulls a second time (which must fail: an offer is
one-shot) and prints one JSON line: the pull's wall time, the payload's
bytes, and any error text (for example a host that refuses
``cudaIpcOpenMemHandle``).  Exits 0 when the pull matched.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _payload(device: str, mb: float):
    import torch

    g = torch.Generator(device="cpu").manual_seed(0)
    n = int(mb * 2**20 / 4 / 2)
    return [torch.randn(n, generator=g).to(device) for _ in range(2)]


def _offerer(device: str, mb: float, conn) -> None:
    from smg_tpu_torch.engine.kv_transfer import TransferManager

    mgr = TransferManager(device)
    tensors = _payload(device, mb)
    uuid = mgr.offer(tensors)
    conn.send((mgr.address, uuid))
    conn.recv()  # hold the offer until the puller is finished
    conn.send(mgr.held())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mb", type=float, default=46.0)
    args = ap.parse_args()
    import torch

    from smg_tpu_torch.engine.kv_transfer import TransferManager

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_offerer, args=(args.device, args.mb, child), daemon=True)
    proc.start()
    out = {"device": args.device, "ok": False}
    try:
        if not parent.poll(120):
            raise TimeoutError("the offering process sent no address in 120 s")
        address, uuid = parent.recv()
        want = _payload(args.device, args.mb)
        mgr = TransferManager(args.device)
        spec = [(tuple(t.shape), "float32") for t in want]
        t0 = time.perf_counter()
        got = mgr.pull(address, uuid, spec)
        out["pull_ms"] = (time.perf_counter() - t0) * 1e3
        out["bytes"] = sum(t.numel() * t.element_size() for t in got)
        out["bitwise_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
        out["on"] = str(got[0].device)
        try:
            mgr.pull(address, uuid, spec)
            out["second_pull"] = "succeeded"
        except Exception as e:  # noqa: BLE001 — the expected refusal
            out["second_pull"] = f"{type(e).__name__}: {e}"
        parent.send("done")
        out["offers_left"] = parent.recv() if parent.poll(30) else None
        out["ok"] = bool(out["bitwise_equal"] and out["second_pull"] != "succeeded"
                         and out["offers_left"] == [])
    except Exception as e:  # noqa: BLE001 — reported, not hidden
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
