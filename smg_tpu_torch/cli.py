"""CLI entry point of the port: ``python -m smg_tpu_torch.cli
launch|serve|worker``.

The port's copy of ``smg_tpu/cli.py``.  ``launch`` runs the gateway alone,
in front of workers it registers by URL (``--worker``, ``--prefill-worker``,
``--decode-worker``: ``http(s)://`` for an OpenAI-wire worker such as the
port's ``serve``, bare ``host:port`` for the gRPC ``worker``) or finds with
``--service-discovery``; ``serve`` runs one PyTorch engine in process
behind the gateway and takes the same worker flags; ``worker`` runs a bare
engine behind the gRPC scheduler protocol (``--grpc-port``), with serve's
engine flags.  Engines run on the card; ``--device cpu`` is the only way
onto the CPU.  Every command line is validated (``config/validation.py``)
before anything binds a port or touches a device.  The flags carry the
reference's names, dests, defaults and types (``--kv-connector`` offers
``auto|host|device``, as the reference's does: ``transfer`` is reached through
``auto``).  ``--storage`` picks the Responses API's conversation
storage and ``--mcp-config-path`` names its gateway-level MCP servers;
``--policy`` takes every policy of the reference, ``--prefix-token-count``
sizes ``prefix_hash``'s key and ``--dp-aware``/``--no-dp-aware`` pick the
router's DP-rank stage.  ``--provider-config`` names a JSON file of
third-party provider backends (OpenAI, xAI, Anthropic, Gemini, Bedrock)
that take their models' chat, ``/v1/messages`` and ``/v1/responses``
requests before any worker does.  ``--plugins`` loads middleware plugins
(a file path or a dotted module, repeatable) whose hooks see every request
and response; a hook that fails lets the request through unless
``--plugin-fail-closed``.  ``--mesh-port`` (with ``--mesh-seed`` and the
three ``--mesh-tls-*`` files for mutual TLS) joins the gateway to an HA mesh
of peer gateways that gossip their workers and cache-aware prefix trees.
``--tp``/``--tensor-parallel-size``, ``--pp``, ``--sp``, ``--ep`` and
``--mesh-shape`` (``serve`` and ``worker``) shard the engine over rank
processes (``parallel/``), one per device of ``--device``: a comma-separated
list (``cuda:0,cuda:0`` puts two ranks on one card), ``cpu``, or by default
``cuda:0 .. cuda:N-1``; ``dp`` inside one engine is refused until its
``ROADMAP.md`` item lands.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="smg-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    launch = sub.add_parser("launch", help="start the routing gateway")
    _add_gateway_args(launch)
    serve = sub.add_parser("serve", help="start a PyTorch engine + the gateway")
    _add_gateway_args(serve)
    _add_engine_args(serve)
    worker = sub.add_parser("worker", help="start a bare PyTorch engine worker (gRPC)")
    _add_engine_args(worker)
    worker.add_argument("--grpc-port", type=int, default=30001)
    return p


def _add_gateway_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("Gateway")
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--port", type=int, default=30000)
    g.add_argument("--worker", action="append", default=[], dest="workers",
                   help="worker URL (repeatable): http(s):// for an OpenAI-wire "
                        "worker, bare host:port for a gRPC worker")
    g.add_argument("--prefill-worker", action="append", default=[], dest="prefill_workers",
                   help="prefill-role worker URL (PD disaggregation; repeatable)")
    g.add_argument("--decode-worker", action="append", default=[], dest="decode_workers",
                   help="decode-role worker URL (PD disaggregation; repeatable)")
    g.add_argument("--policy", default="cache_aware",
                   help="routing policy (cache_aware, round_robin, random, "
                        "least_load, power_of_two, prefix_hash, consistent_hashing, "
                        "manual, bucket, passthrough)")
    g.add_argument("--max-concurrent-requests", type=int, default=256)
    g.add_argument("--storage", default=None,
                   help="conversation storage backend: memory (default), "
                        "sqlite:PATH, redis://..., postgres://...")
    g.add_argument("--otel-endpoint", default=None, dest="otel_endpoint",
                   help="OTLP/HTTP collector base URL (e.g. "
                        "http://127.0.0.1:4318); enables trace export")
    g.add_argument("--otel-service-name", default="smg-tpu",
                   dest="otel_service_name")
    g.add_argument("--mm-transport", default="auto", dest="mm_transport",
                   choices=["inline", "shm", "auto"],
                   help="pixel transport to gRPC encode workers: inline bytes, "
                        "same-host shared memory, or auto (shm for loopback "
                        "workers above the size threshold)")
    g.add_argument("--mm-shm-min-bytes", type=int, default=1 << 20,
                   dest="mm_shm_min_bytes")
    g.add_argument("--kv-connector", default="auto", choices=["auto", "host", "device"],
                   help="PD KV handoff: on the card (device) or host bytes; auto "
                        "takes device when both legs keep KV on the card, else "
                        "transfer (a same-host pull) when both legs support it")
    g.add_argument("--provider-config", default=None,
                   help="JSON file of third-party provider backends: a list of "
                        '{"name", "kind" (openai, xai, anthropic, gemini, bedrock), '
                        '"base_url", "api_key" or "api_key_env", "models", '
                        '"model_map", "timeout_s"}')
    g.add_argument("--gateway-tokenizer-path", default=None, dest="gateway_tokenizer_path",
                   help="tokenizer for gateway-side text processing (launch mode; "
                        "default: the first worker's tokenizer bundle)")
    g.add_argument("--mesh-port", type=int, default=None,
                   help="enable HA mesh gossip on this port (binds 0.0.0.0)")
    g.add_argument("--mesh-tls-cert", default=None, dest="mesh_tls_cert",
                   help="node certificate for mesh mTLS")
    g.add_argument("--mesh-tls-key", default=None, dest="mesh_tls_key")
    g.add_argument("--mesh-tls-ca", default=None, dest="mesh_tls_ca",
                   help="CA bundle peers must be signed by")
    g.add_argument("--mesh-seed", action="append", default=[], dest="mesh_seeds",
                   help="mesh seed peer host:port (repeatable)")
    g.add_argument("--plugins", action="append", default=[],
                   help="middleware plugin: /path/plug.py or dotted module "
                        "(repeatable; reference: the WASM component host)")
    g.add_argument("--plugin-fail-closed", action="store_true",
                   help="reject requests when a plugin hook faults "
                        "(default: fail-open, log and continue)")
    g.add_argument("--log-level", default="INFO")
    g.add_argument("--log-json", action="store_true",
                   help="structured JSON log lines")
    g.add_argument("--prometheus-port", type=int, default=None,
                   help="a metrics-only listener (/metrics) on this port")
    g.add_argument("--prometheus-host", default="0.0.0.0")
    g.add_argument("--health-check-port", type=int, default=None,
                   dest="health_check_port",
                   help="dedicated probe listener (liveness/readiness/health "
                        "served on their own port so a saturated gateway "
                        "cannot starve the probes)")
    g.add_argument("--tls-cert-path", default=None, dest="tls_cert_path",
                   help="serve HTTPS with this certificate")
    g.add_argument("--tls-key-path", default=None, dest="tls_key_path")
    g.add_argument("--max-payload-size", type=int, default=256 * 2**20,
                   dest="max_payload_size",
                   help="request body cap in bytes (reference default 256MB)")
    g.add_argument("--request-timeout-secs", type=float, default=1800.0,
                   dest="request_timeout_secs")
    g.add_argument("--cors-allowed-origins", action="append", default=[],
                   dest="cors_allowed_origins",
                   help="origin allowed for CORS (repeatable; unset = off)")
    g.add_argument("--request-id-headers", action="append", default=[],
                   dest="request_id_headers",
                   help="extra header names accepted as the request id")
    g.add_argument("--harmony", default=None, choices=["on", "off", "auto"],
                   help="harmony (gpt-oss) pipeline: auto-detect by model "
                        "name (default), or force on/off")
    g.add_argument("--reasoning-parser", default=None, dest="reasoning_parser",
                   help="force a reasoning parser family (default: by model)")
    g.add_argument("--tool-call-parser", default=None, dest="tool_call_parser",
                   help="force a tool-call parser dialect (default: by model)")
    g.add_argument("--mcp-config-path", default=None, dest="mcp_config_path",
                   help="JSON file of MCP servers: "
                        '[{"name": ..., "url": ..., "headers": {...}}]')
    g.add_argument("--slo-spec", default=None, dest="slo_spec",
                   help="JSON file of declarative SLO specs (a list of "
                        "objects or {'slos': [...]}; fields: name, "
                        "ttft_p95_s, itl_p95_s, e2e_p95_s, "
                        "goodput_ratio_floor, deadline_miss_budget, "
                        "fast/slow_window_s, fast/slow_burn, min_requests, "
                        "hysteresis).  Verdicts at GET /debug/slo/verdicts")

    pol = p.add_argument_group("Routing policy")
    pol.add_argument("--cache-threshold", type=float, default=0.5,
                     help="cache-aware: min prefix-match ratio for affinity")
    pol.add_argument("--balance-abs-threshold", type=int, default=32,
                     help="cache-aware: absolute load-imbalance trigger")
    pol.add_argument("--balance-rel-threshold", type=float, default=1.5,
                     help="cache-aware: relative load-imbalance trigger")
    pol.add_argument("--max-tree-size", type=int, default=2**20,
                     help="cache-aware: approximation tree node budget")
    pol.add_argument("--block-size", type=int, default=16,
                     help="KV block size for event-driven cache-aware routing")
    pol.add_argument("--prefix-token-count", type=int, default=256,
                     help="prefix_hash: tokens hashed for placement")
    pol.add_argument("--dp-aware", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="pin requests to DP engine replicas by min-token "
                          "load (default on; --no-dp-aware lets the worker "
                          "balance locally)")
    pol.add_argument("--enable-igw", action="store_true",
                     help="compat flag: multi-model (IGW) routing is always "
                          "on in this gateway — accepted for reference CLI "
                          "parity")

    rl = p.add_argument_group("Reliability")
    rl.add_argument("--retry-max-retries", type=int, default=3)
    rl.add_argument("--retry-initial-backoff-ms", type=int, default=100)
    rl.add_argument("--retry-max-backoff-ms", type=int, default=2000)
    rl.add_argument("--disable-retries", action="store_true")
    rl.add_argument("--cb-failure-threshold", type=int, default=5,
                    help="consecutive failures before the circuit opens")
    rl.add_argument("--cb-success-threshold", type=int, default=2,
                    help="half-open successes before the circuit closes")
    rl.add_argument("--cb-timeout-duration-secs", type=float, default=30.0,
                    help="open-state cooldown before half-open probes")
    rl.add_argument("--disable-circuit-breaker", action="store_true")
    rl.add_argument("--health-check-interval-secs", type=float, default=10.0)
    rl.add_argument("--health-check-timeout-secs", type=float, default=5.0)
    rl.add_argument("--health-failure-threshold", type=int, default=3)
    rl.add_argument("--health-success-threshold", type=int, default=2)
    rl.add_argument("--disable-health-check", action="store_true")
    rl.add_argument("--worker-startup-timeout-secs", type=float, default=75.0,
                    help="budget for startup worker registration workflows")
    rl.add_argument("--worker-stream-idle-timeout-secs", type=float,
                    default=None, dest="worker_stream_idle_timeout_secs",
                    help="per-chunk idle bound on gRPC worker generate "
                         "streams: no token for N secs counts as a worker "
                         "failure (retry/breaker engage); 0 disables "
                         "(default: 120, the client's built-in)")
    rl.add_argument("--engine-drain-timeout-secs", type=float, default=10.0,
                    dest="engine_drain_timeout_secs",
                    help="SIGTERM drain budget for in-proc engines: queued "
                         "requests get terminal aborts, running lanes "
                         "finish within this bound before exit")

    sched = p.add_argument_group("Scheduling / limits")
    sched.add_argument("--priority-scheduler-enabled", action="store_true")
    sched.add_argument("--priority-slots", type=int, default=256,
                       help="execution slots the priority scheduler manages")
    sched.add_argument("--rate-limit-tokens-per-second", type=float, default=0.0,
                       help="per-tenant sustained request rate (0 = off)")
    sched.add_argument("--rate-limit-burst", type=float, default=256.0,
                       help="per-tenant burst capacity")

    auth = p.add_argument_group("Auth")
    auth.add_argument("--api-key", action="append", default=[], dest="api_keys",
                      help="accepted API key, optionally KEY:TENANT[:ROLE] "
                           "(repeatable; any key enables auth)")
    auth.add_argument("--jwt-secret", default=None, dest="jwt_secret",
                      help="HS256 bearer verification secret")
    auth.add_argument("--jwt-jwks-uri", default=None, dest="jwt_jwks_uri",
                      help="JWKS endpoint for RS256/OIDC bearer verification")
    auth.add_argument("--jwt-issuer", default=None, dest="jwt_issuer")
    auth.add_argument("--jwt-audience", default=None, dest="jwt_audience")
    auth.add_argument("--trust-tenant-header", action="store_true",
                      help="accept X-Tenant-Id (or --tenant-header-name) "
                           "from clients without auth")
    auth.add_argument("--tenant-header-name", default="X-Tenant-Id",
                      dest="tenant_header_name")

    disc = p.add_argument_group("Service discovery")
    disc.add_argument("--service-discovery", action="store_true",
                      help="watch Kubernetes pods and (de)register workers")
    disc.add_argument("--service-discovery-namespace", default=None,
                      dest="service_discovery_namespace")
    disc.add_argument("--selector", action="append", default=[], dest="selectors",
                      help="pod label selector key=value (repeatable)")
    disc.add_argument("--prefill-selector", action="append", default=[],
                      dest="prefill_selectors")
    disc.add_argument("--decode-selector", action="append", default=[],
                      dest="decode_selectors")
    disc.add_argument("--service-discovery-port", type=int, default=30001,
                      dest="service_discovery_port",
                      help="worker port discovered pods serve on")


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    e = p.add_argument_group("Engine")
    e.add_argument("--model-path", default=None,
                   help="HF-format model dir (config.json, *.safetensors, "
                        "tokenizer.json)")
    e.add_argument("--model-preset", default=None,
                   help="named preset (tiny, tiny-gemma2, llama3.2-1b, llama3-8b, "
                        "llama3-70b); weights are random, made from a seed")
    e.add_argument("--tokenizer-path", default=None,
                   help="tokenizer dir (default: --model-path)")
    e.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda by default; the CPU "
                        "only when asked for); under a rank mesh a "
                        "comma-separated device per rank")
    e.add_argument("--tp", "--tensor-parallel-size", type=int, default=1, dest="tp",
                   help="tensor parallel size: heads, ffn and vocab sharded over "
                        "one rank process per device")
    e.add_argument("--pp", type=int, default=1,
                   help="pipeline parallel size: the layer stack and its KV split "
                        "into stages, a rank process each")
    e.add_argument("--sp", type=int, default=1,
                   help="sequence parallel size: a cold prefill chunk ring-attends "
                        "over the sp rank processes")
    e.add_argument("--ep", type=int, default=1,
                   help="expert parallel size (MoE): the experts split over rank "
                        "processes")
    e.add_argument("--mesh-shape", default=None, dest="mesh_shape",
                   help="full mesh topology as axis=N pairs, e.g. 'tp=4' (axes: "
                        "dp/tp/sp/ep/pp; unnamed axes stay 1).  Conflicts with a "
                        "differing per-axis flag are a startup error")
    e.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="weight and compute dtype (a bf16 checkpoint is widened "
                        "as it loads)")
    e.add_argument("--kv-dtype", default=None, dest="kv_dtype",
                   choices=["bfloat16", "float32"],
                   help="KV cache dtype (default: --dtype)")
    e.add_argument("--page-size", type=int, default=16)
    e.add_argument("--max-batch-size", type=int, default=64)
    e.add_argument("--max-seq-len", type=int, default=8192)
    e.add_argument("--max-prefill-tokens", type=int, default=4096,
                   help="per-step prefill token budget (chunked prefill)")
    e.add_argument("--prefill-mix-policy", default="stall-free",
                   dest="prefill_mix_policy", choices=["stall-free", "throughput"],
                   help="prefill scheduling: 'stall-free' meters prefill to "
                        "the per-step budget (resumable chunks; decode runs "
                        "every step), 'throughput' drains the waiting queue "
                        "per step (long prompts stall decode)")
    e.add_argument("--decode-horizon", type=int, default=1,
                   help="decode columns per device round trip (megastep)")
    e.add_argument("--adaptive-horizon", default="off", choices=["on", "off"])
    e.add_argument("--decode-horizon-max", type=int, default=0)
    e.add_argument("--overlap-schedule", default="on", choices=["on", "off"])
    e.add_argument("--speculative", action="store_true",
                   help="speculative decoding: per-request n-gram prompt-lookup "
                        "drafts (or a draft model via --draft-model-path or "
                        "--draft-model-preset) "
                        "verified as one fused batched device block per step; "
                        "greedy output stays token-identical, sampling uses "
                        "distribution-preserving rejection sampling")
    e.add_argument("--speculative-tier", default="auto",
                   choices=["auto", "ngram", "draft"], dest="speculative_tier",
                   help="drafting tier: 'auto' = draft model when configured "
                        "else n-gram lookup; 'ngram' pins the prompt-lookup "
                        "tier; 'draft' requires a draft model")
    e.add_argument("--spec-max-draft-tokens", "--spec-max-draft", type=int,
                   default=8, dest="spec_max_draft",
                   help="max drafted tokens verified per device block (the "
                        "verify block is one wider)")
    e.add_argument("--draft-model-path", default=None, dest="draft_model_path",
                   help="HF-format dir of a draft model (its weights are loaded)")
    e.add_argument("--draft-model-preset", default=None, dest="draft_model_preset",
                   help="named preset for the draft model (random weights "
                        "from the draft seed)")
    e.add_argument("--max-queued-requests", type=int, default=0)
    e.add_argument("--max-queued-tokens", type=int, default=0)
    e.add_argument("--step-watchdog-secs", type=float, default=0.0,
                   help="mark the engine unhealthy when no step completes "
                        "for this long with work pending (0 = off)")
    e.add_argument("--metrics-window-secs", type=float, default=30.0,
                   dest="metrics_window_secs",
                   help="rolling-stats horizon for engine step telemetry "
                        "(p50/p95 step time, tokens/s via /scheduler)")
    e.add_argument("--device-metrics-interval-secs", type=float, default=10.0,
                   dest="device_metrics_interval_secs",
                   help="cadence of the device-memory gauges "
                        "(0 disables device sampling)")
    e.add_argument("--flight-recorder", default="on", choices=["on", "off"],
                   dest="flight_recorder",
                   help="engine flight recorder: bounded per-step ring + "
                        "per-request timelines, auto-dumped on quarantine, "
                        "watchdog, health flip and drain, fetchable via "
                        "GET /debug/flight/{worker}; 'off' only to measure "
                        "its cost")
    e.add_argument("--flight-ring-size", type=int, default=256)
    e.add_argument("--flight-dump-dir", default=None, dest="flight_dump_dir",
                   help="directory for reason-tagged flight-dump JSON files "
                        "(default: keep the last dumps in memory only)")
    e.add_argument("--flight-dump-min-interval-secs", type=float, default=5.0,
                   dest="flight_dump_min_interval_secs",
                   help="per-reason rate limit between automatic flight dumps")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from smg_tpu_torch.utils.logging import configure

    configure(level=getattr(args, "log_level", "INFO"),
              json_logs=getattr(args, "log_json", False) or None)
    # validate before any port binds or device is touched (reference:
    # ConfigValidator at startup); the gateway-only rules pass over a
    # worker's absent fields
    from smg_tpu_torch.config.validation import raise_on_errors, validate_cli_args
    from smg_tpu_torch.utils import get_logger

    raise_on_errors(validate_cli_args(args), logger=get_logger("config"))
    from smg_tpu_torch.gateway.launch import run_command

    return run_command(args)


if __name__ == "__main__":
    sys.exit(main())
