"""CLI entry point of the port: ``python -m smg_tpu_torch.cli serve``.

The port's copy of the ``serve`` subcommand of ``smg_tpu/cli.py``: one
PyTorch engine in process behind the gateway.  Engines run on the card;
``--device cpu`` is the only way onto the CPU.  ``launch``, ``worker``,
gRPC, auth, rate limiting, priority, mesh, discovery, storage, MCP, plugins
and tracing are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="smg-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="start a PyTorch engine + the gateway")

    g = serve.add_argument_group("Gateway")
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--port", type=int, default=30000)
    g.add_argument("--policy", default="cache_aware",
                   help="routing policy (cache_aware, round_robin, random, "
                        "least_load, power_of_two, manual, bucket, passthrough)")
    g.add_argument("--log-level", default="INFO")
    g.add_argument("--log-json", action="store_true",
                   help="structured JSON log lines")
    g.add_argument("--engine-drain-timeout-secs", type=float, default=10.0,
                   dest="engine_drain_timeout_secs",
                   help="SIGTERM drain budget for in-proc engines: queued "
                        "requests get terminal aborts, running lanes "
                        "finish within this bound before exit")

    e = serve.add_argument_group("Engine")
    e.add_argument("--model-preset", required=True,
                   help="named preset (tiny, tiny-gemma2, llama3.2-1b, llama3-8b, "
                        "llama3-70b); weights are random, made from a seed")
    e.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda by default; the CPU "
                        "only when asked for)")
    e.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    e.add_argument("--kv-dtype", default=None, dest="kv_dtype",
                   choices=["bfloat16", "float32"],
                   help="KV cache dtype (default: --dtype)")
    e.add_argument("--page-size", type=int, default=16)
    e.add_argument("--max-batch-size", type=int, default=64)
    e.add_argument("--max-seq-len", type=int, default=8192)
    e.add_argument("--max-prefill-tokens", type=int, default=4096,
                   help="per-step prefill token budget (chunked prefill)")
    e.add_argument("--decode-horizon", type=int, default=1,
                   help="decode columns per device round trip (megastep)")
    e.add_argument("--adaptive-horizon", default="off", choices=["on", "off"])
    e.add_argument("--decode-horizon-max", type=int, default=0)
    e.add_argument("--overlap-schedule", default="on", choices=["on", "off"])
    e.add_argument("--max-queued-requests", type=int, default=0)
    e.add_argument("--max-queued-tokens", type=int, default=0)
    e.add_argument("--step-watchdog-secs", type=float, default=0.0,
                   help="mark the engine unhealthy when no step completes "
                        "for this long with work pending (0 = off)")
    e.add_argument("--flight-ring-size", type=int, default=256)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from smg_tpu_torch.utils.logging import configure

    configure(level=args.log_level, json_logs=args.log_json or None)
    from smg_tpu_torch.gateway.launch import run_command

    return run_command(args)


if __name__ == "__main__":
    sys.exit(main())
