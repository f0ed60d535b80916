"""Config validation — the port's copy of ``smg_tpu/config/validation.py``:
reject a bad deployment at startup, not at the first request.

Reference behavior: ``ConfigValidator``
(``model_gateway/src/config/validation.rs``, validate_mode/policy/server/
retry/circuit-breaker/compatibility): every ``launch``, ``serve`` and
``worker`` command line passes a cross-field check before anything binds a
port or touches a device.  The issues, severities and messages are the
reference's, ``validate_engine_config``'s included (parallel axes against
the model, cache and scheduler coherence, speculative tiers, dtypes; its
``dtype`` is the model's, where the reference's engine config has a field of
its own).  The ``--mesh-shape`` rule parses through the port's
``ParallelConfig.from_spec``.

Two severities: ``error`` (raise ``ConfigError`` before startup) and
``warn`` (log and continue: legal but probably not what you want).
"""

from __future__ import annotations

from dataclasses import dataclass

from smg_tpu_torch.engine.config import ParallelConfig


class ConfigError(ValueError):
    """Invalid configuration; ``.issues`` carries every finding."""

    def __init__(self, issues: "list[ValidationIssue]"):
        self.issues = issues
        msgs = "; ".join(str(i) for i in issues)
        super().__init__(f"invalid configuration: {msgs}")


@dataclass(frozen=True)
class ValidationIssue:
    severity: str  # "error" | "warn"
    field: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.field}: {self.message}"


def _err(field: str, message: str) -> ValidationIssue:
    return ValidationIssue("error", field, message)


def _warn(field: str, message: str) -> ValidationIssue:
    return ValidationIssue("warn", field, message)


def validate_engine_config(cfg) -> list[ValidationIssue]:
    """Validate an ``EngineConfig`` (model x parallel x cache x scheduler)."""
    issues: list[ValidationIssue] = []
    model = cfg.model
    par = cfg.parallel
    cache = cfg.cache
    sched = cfg.scheduler

    # ---- parallel x model divisibility
    if model is not None:
        if par.tp > 1:
            if model.num_heads % par.tp != 0:
                issues.append(_err(
                    "parallel.tp",
                    f"tp={par.tp} does not divide num_heads={model.num_heads}",
                ))
            kv_lanes = model.num_kv_heads * model.head_dim
            if kv_lanes % par.tp != 0:
                issues.append(_err(
                    "parallel.tp",
                    f"tp={par.tp} does not divide kv lanes "
                    f"(num_kv_heads*head_dim={kv_lanes})",
                ))
            if model.intermediate_size % par.tp != 0:
                issues.append(_err(
                    "parallel.tp",
                    f"tp={par.tp} does not divide intermediate_size="
                    f"{model.intermediate_size}",
                ))
        if (model.attn_logit_softcap or model.sliding_window) and par.sp > 1:
            issues.append(_err(
                "parallel.sp",
                "ring attention implements neither the Gemma-2 attention "
                "softcap nor sliding windows; sp must be 1 for such models",
            ))
        if model.sliding_window and model.sliding_window_pattern > 0 and par.pp > 1:
            issues.append(_err(
                "parallel.pp",
                "pipeline stages scan LOCAL layer indices, which would "
                "invert the global/sliding alternation on later stages; "
                "pp must be 1 for window-alternating models (every-layer "
                "windows, pattern=0, are pp-safe)",
            ))
        if par.pp > 1 and model.num_layers % par.pp != 0:
            issues.append(_err(
                "parallel.pp",
                f"pp={par.pp} does not divide num_layers={model.num_layers}",
            ))
        if par.ep > 1:
            if model.num_experts == 0:
                issues.append(_err(
                    "parallel.ep", f"ep={par.ep} on a dense (non-MoE) model"
                ))
            elif model.num_experts % par.ep != 0:
                issues.append(_err(
                    "parallel.ep",
                    f"ep={par.ep} does not divide num_experts={model.num_experts}",
                ))
    if par.sp > 1:
        bad = [b for b in sched.prefill_token_buckets if b % par.sp != 0]
        if bad:
            issues.append(_warn(
                "scheduler.prefill_token_buckets",
                f"buckets {bad} not divisible by sp={par.sp}: those prefills "
                f"fall back to the dense (non-ring) path",
            ))

    # ---- cache / scheduler coherence
    if not cache.auto_size:
        min_pages = sched.watermark_pages + 2  # garbage page + one working page
        if cache.num_pages < min_pages:
            issues.append(_err(
                "cache.num_pages",
                f"{cache.num_pages} pages cannot cover watermark_pages="
                f"{sched.watermark_pages} plus the reserved garbage page",
            ))
        seq_pages = -(-sched.max_seq_len // cache.page_size)
        if cache.num_pages - 1 < seq_pages:
            issues.append(_err(
                "cache.num_pages",
                f"a single max_seq_len={sched.max_seq_len} sequence needs "
                f"{seq_pages} pages but the pool has {cache.num_pages - 1}",
            ))
    if sched.max_seq_len % cache.page_size != 0:
        issues.append(_warn(
            "scheduler.max_seq_len",
            f"not a multiple of page_size={cache.page_size}; the tail page "
            f"of a full sequence is padded",
        ))
    if sched.decode_horizon > 1 and sched.decode_horizon > sched.max_seq_len:
        issues.append(_err(
            "scheduler.decode_horizon",
            f"horizon {sched.decode_horizon} exceeds max_seq_len",
        ))
    if cache.dtype not in ("bfloat16", "float32", "float16"):
        issues.append(_err("cache.dtype", f"unsupported KV dtype {cache.dtype!r}"))

    # ---- speculative decoding tiers
    if sched.speculative_tier == "draft" and cfg.draft_model is None:
        issues.append(_err(
            "scheduler.speculative_tier",
            "tier 'draft' requires a configured draft model "
            "(EngineConfig.draft_model / --draft-model-path)",
        ))
    if sched.speculative and par.pp > 1:
        issues.append(_warn(
            "scheduler.speculative",
            "the fused verify block does not compose with pipeline "
            "parallelism; pp engines decode non-speculatively",
        ))

    # ---- dtype coherence (the reference's message, TPU included)
    if model is not None and model.dtype == "bfloat16" and cache.dtype == "float32":
        issues.append(_warn(
            "cache.dtype",
            "float32 KV with bfloat16 compute doubles KV bandwidth for no "
            "accuracy gain on TPU",
        ))
    return issues


def validate_gateway_config(
    policy: str | None = None,
    workers: list[str] | None = None,
    prefill_workers: list[str] | None = None,
    decode_workers: list[str] | None = None,
    max_concurrent_requests: int | None = None,
    kv_connector: str | None = None,
    mesh_port: int | None = None,
) -> list[ValidationIssue]:
    """Validate gateway/launch arguments (reference: validate_mode +
    validate_policy + validate_server_settings + validate_compatibility)."""
    from smg_tpu_torch.policies.base import _POLICIES

    issues: list[ValidationIssue] = []
    if policy is not None and policy not in _POLICIES:
        issues.append(_err(
            "policy", f"unknown policy {policy!r}; known: {sorted(_POLICIES)}"
        ))
    # PD mode needs BOTH legs (validate_mode: PrefillDecode requires both)
    pd_p = bool(prefill_workers)
    pd_d = bool(decode_workers)
    if pd_p != pd_d:
        missing = "decode" if pd_p else "prefill"
        issues.append(_err(
            "prefill_workers/decode_workers",
            f"PD disaggregation requires both roles; no {missing} workers given",
        ))
    if pd_p and pd_d and workers:
        issues.append(_warn(
            "workers",
            "regular workers are ignored for models that have PD pools",
        ))
    for url in (workers or []) + (prefill_workers or []) + (decode_workers or []):
        if not url or url.isspace():
            issues.append(_err("workers", "empty worker URL"))
        elif "://" in url and not url.startswith(("http://", "https://")):
            issues.append(_err(
                "workers",
                f"unsupported scheme in {url!r} (http(s):// = OpenAI-wire "
                f"proxy, bare host:port = gRPC)",
            ))
    if max_concurrent_requests is not None and max_concurrent_requests < 1:
        issues.append(_err(
            "max_concurrent_requests", "must be >= 1"
        ))
    if kv_connector is not None and kv_connector not in ("auto", "host", "device"):
        issues.append(_err(
            "kv_connector", f"unknown connector {kv_connector!r}"
        ))
    if mesh_port is not None and not (0 < mesh_port < 65536):
        issues.append(_err("mesh_port", f"port {mesh_port} out of range"))
    return issues


def validate_cli_args(args) -> list[ValidationIssue]:
    """Cross-field validation over the full launch/serve flag namespace
    (reference: ``config/validation.rs`` ConfigValidator — ~140 flags pass
    a coherence check before anything binds a port or touches a device)."""
    g = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    issues = validate_gateway_config(
        policy=g("policy"),
        workers=g("workers", []),
        prefill_workers=g("prefill_workers", []),
        decode_workers=g("decode_workers", []),
        max_concurrent_requests=g("max_concurrent_requests"),
        kv_connector=g("kv_connector"),
        mesh_port=g("mesh_port"),
    )

    # ---- server / TLS
    if bool(g("tls_cert_path")) != bool(g("tls_key_path")):
        issues.append(_err(
            "tls_cert_path/tls_key_path",
            "TLS needs BOTH the certificate and the key",
        ))
    if g("health_check_port") is not None and g("health_check_port") == g("port"):
        issues.append(_err(
            "health_check_port",
            "the dedicated probe port must differ from the main port",
        ))
    if g("max_payload_size") is not None and g("max_payload_size") < 1024:
        issues.append(_err("max_payload_size", "must be >= 1KiB"))
    if g("request_timeout_secs") is not None and g("request_timeout_secs") <= 0:
        issues.append(_err("request_timeout_secs", "must be positive"))

    # ---- retries / circuit breaker / health
    if g("retry_initial_backoff_ms") is not None and g("retry_max_backoff_ms") is not None:
        if g("retry_initial_backoff_ms") > g("retry_max_backoff_ms"):
            issues.append(_err(
                "retry_initial_backoff_ms",
                f"initial backoff {g('retry_initial_backoff_ms')}ms exceeds "
                f"max {g('retry_max_backoff_ms')}ms",
            ))
    if g("retry_max_retries") is not None and g("retry_max_retries") < 0:
        issues.append(_err("retry_max_retries", "must be >= 0"))
    for fld in ("cb_failure_threshold", "cb_success_threshold",
                "health_failure_threshold", "health_success_threshold"):
        if g(fld) is not None and g(fld) < 1:
            issues.append(_err(fld, "must be >= 1"))
    if (g("health_check_timeout_secs") is not None
            and g("health_check_interval_secs") is not None
            and g("health_check_timeout_secs") >= g("health_check_interval_secs")):
        issues.append(_warn(
            "health_check_timeout_secs",
            "probe timeout >= probe interval: checks can pile up",
        ))
    if g("disable_retries") and g("disable_circuit_breaker"):
        issues.append(_warn(
            "disable_retries/disable_circuit_breaker",
            "no retries AND no breaker: every transient worker hiccup "
            "surfaces to clients immediately",
        ))

    # ---- policy knobs
    if g("cache_threshold") is not None and not (0.0 <= g("cache_threshold") <= 1.0):
        issues.append(_err("cache_threshold", "must be in [0, 1]"))
    if g("balance_rel_threshold") is not None and g("balance_rel_threshold") < 1.0:
        issues.append(_err(
            "balance_rel_threshold", "relative imbalance factor must be >= 1"
        ))
    if g("block_size") is not None and (
        g("block_size") < 1 or g("block_size") & (g("block_size") - 1)
    ):
        issues.append(_warn(
            "block_size", "not a power of two: radix pages won't tile KV pages"
        ))
    pol = g("policy")
    if pol not in (None, "cache_aware") and g("cache_threshold") not in (None, 0.5):
        issues.append(_warn(
            "cache_threshold", f"ignored by policy {pol!r} (cache_aware only)"
        ))

    # ---- scheduling / limits
    if g("priority_slots") is not None and g("priority_slots") < 1:
        issues.append(_err("priority_slots", "must be >= 1"))
    rl_rate = g("rate_limit_tokens_per_second")
    if rl_rate is not None and rl_rate < 0:
        issues.append(_err("rate_limit_tokens_per_second", "must be >= 0"))
    if (rl_rate or 0) > 0 and (g("rate_limit_burst") or 0) < rl_rate:
        issues.append(_warn(
            "rate_limit_burst",
            "burst below the sustained rate throttles steady traffic",
        ))

    # ---- auth
    for spec in g("api_keys", []) or []:
        if not spec or spec.startswith(":"):
            issues.append(_err("api_key", f"malformed key spec {spec!r}"))
    if (g("jwt_issuer") or g("jwt_audience")) and not g("jwt_jwks_uri"):
        issues.append(_warn(
            "jwt_issuer/jwt_audience",
            "issuer/audience claims are only checked on the JWKS (RS256) "
            "path; set --jwt-jwks-uri",
        ))
    if g("trust_tenant_header") and not (
        g("api_keys") or g("jwt_secret") or g("jwt_jwks_uri")
    ):
        issues.append(_warn(
            "trust_tenant_header",
            "without auth the tenant header is already trusted; flag is "
            "redundant",
        ))

    # ---- harmony / parsers
    if g("harmony") == "on" and (g("reasoning_parser") or g("tool_call_parser")):
        issues.append(_warn(
            "harmony",
            "the harmony pipeline performs its own channel demux; "
            "--reasoning-parser/--tool-call-parser are ignored for it",
        ))

    # ---- service discovery
    if not g("service_discovery") and (
        g("selectors") or g("prefill_selectors") or g("decode_selectors")
    ):
        issues.append(_warn(
            "selector", "selectors given but --service-discovery is off"
        ))

    # ---- speculative draft (serve mode)
    if (g("draft_model_path") or g("draft_model_preset")) and not g("speculative"):
        issues.append(_err(
            "draft_model_path",
            "a draft model needs --speculative to take effect",
        ))
    if g("spec_max_draft") is not None and g("spec_max_draft") < 1:
        issues.append(_err("spec_max_draft", "must be >= 1"))
    if g("speculative_tier") == "draft" and not (
        g("draft_model_path") or g("draft_model_preset")
    ):
        issues.append(_err(
            "speculative_tier",
            "tier 'draft' needs --draft-model-path or --draft-model-preset",
        ))
    if (
        g("speculative_tier") not in (None, "auto")
        and not g("speculative")
        # an installed draft model enables spec mode by itself (the
        # scheduler treats draft-is-configured as speculative), so the tier
        # pin IS live there — e.g. --draft-model-path with tier "ngram"
        and not (g("draft_model_path") or g("draft_model_preset"))
    ):
        issues.append(_warn(
            "speculative_tier",
            "--speculative-tier has no effect without --speculative "
            "(or a configured draft model)",
        ))

    # ---- megastep decode horizon (serve/worker mode)
    if g("decode_horizon") is not None and g("decode_horizon") < 1:
        issues.append(_err("decode_horizon", "must be >= 1"))
    if (
        g("decode_horizon_max")
        and g("decode_horizon") is not None
        and g("decode_horizon_max") < g("decode_horizon")
    ):
        issues.append(_err(
            "decode_horizon_max",
            f"compiled horizon cap {g('decode_horizon_max')} is below "
            f"--decode-horizon {g('decode_horizon')}",
        ))
    if (
        g("adaptive_horizon") == "on"
        and (g("decode_horizon") or 1) <= 1
        and not g("decode_horizon_max")
    ):
        issues.append(_warn(
            "adaptive_horizon",
            "adaptive horizon with cap 1 (neither --decode-horizon nor "
            "--decode-horizon-max above 1) never fuses steps",
        ))

    # ---- parallel mesh shape (serve/worker mode)
    if g("mesh_shape"):
        try:
            shaped = ParallelConfig.from_spec(g("mesh_shape")).axis_sizes()
        except ValueError as e:
            shaped = None
            issues.append(_err("mesh_shape", str(e)))
        if shaped is not None:
            # a per-axis flag that disagrees with an axis the spec NAMES is
            # a conflict, not a merge; axes the spec leaves out merge from
            # the flags at launch (from_spec base=), so they are not checked
            named = {
                part.partition("=")[0].strip()
                for part in g("mesh_shape").split(",") if part.strip()
            }
            for axis, size in shaped.items():
                flag = g(axis, 1) or 1
                if axis in named and flag != 1 and size != flag:
                    issues.append(_err(
                        "mesh_shape",
                        f"--mesh-shape sets {axis}={size} but --{axis}={flag}; "
                        f"drop one",
                    ))

    # ---- mesh TLS coherence
    tls_parts = [g("mesh_tls_cert"), g("mesh_tls_key"), g("mesh_tls_ca")]
    if any(tls_parts) and not all(tls_parts):
        issues.append(_err(
            "mesh_tls_cert/mesh_tls_key/mesh_tls_ca",
            "mesh mTLS needs cert + key + CA together (partial TLS would "
            "silently downgrade gossip to plaintext)",
        ))
    return issues


def raise_on_errors(issues: list[ValidationIssue], logger=None) -> None:
    """Log warnings; raise ConfigError if any error-severity issues exist."""
    errors = [i for i in issues if i.severity == "error"]
    if logger is not None:
        for i in issues:
            if i.severity == "warn":
                logger.warning("config: %s", i)
    if errors:
        raise ConfigError(errors)
