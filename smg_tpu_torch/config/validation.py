"""Config validation — the port's copy of ``smg_tpu/config/validation.py``:
reject a bad deployment at startup, not at the first request.

Reference behavior: ``ConfigValidator``
(``model_gateway/src/config/validation.rs``, validate_mode/policy/server/
retry/circuit-breaker/compatibility): every ``launch``, ``serve`` and
``worker`` command line passes a cross-field check before anything binds a
port or touches a device.  The issues, severities and messages are the
reference's.  ``validate_engine_config`` is not ported: its rules read the
reference engine's mesh axes and compile buckets, which the port's engine
does not have.  The ``--mesh-shape`` rule stays (the port refuses the flag,
the rule reads a namespace that holds it), over a copy of the reference's
spec parser.

Two severities: ``error`` (raise ``ConfigError`` before startup) and
``warn`` (log and continue: legal but probably not what you want).
"""

from __future__ import annotations

from dataclasses import dataclass


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
            shaped = _mesh_axis_sizes(g("mesh_shape"))
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


def _mesh_axis_sizes(spec: str) -> dict[str, int]:
    """Axis sizes of a ``--mesh-shape`` string ("tp=4", "dp=2,tp=4") over
    all-ones: the reference's ``ParallelConfig.from_spec``, with its errors
    (an unknown axis, a malformed entry, an axis named twice, a size below
    1)."""
    sizes = dict.fromkeys(("dp", "tp", "sp", "ep", "pp"), 1)
    seen: set[str] = set()
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        axis, sep, val = part.partition("=")
        axis = axis.strip()
        if not sep or axis not in sizes:
            raise ValueError(
                f"mesh-shape entry {part!r}: expected axis=N with axis "
                f"in {sorted(sizes)}"
            )
        if axis in seen:
            raise ValueError(f"mesh-shape names {axis!r} twice")
        seen.add(axis)
        try:
            n = int(val)
        except ValueError:
            raise ValueError(f"mesh-shape entry {part!r}: size must be an int") from None
        if n < 1:
            raise ValueError(f"mesh-shape entry {part!r}: size must be >= 1")
        sizes[axis] = n
    return sizes


def raise_on_errors(issues: list[ValidationIssue], logger=None) -> None:
    """Log warnings; raise ConfigError if any error-severity issues exist."""
    errors = [i for i in issues if i.severity == "error"]
    if logger is not None:
        for i in issues:
            if i.severity == "warn":
                logger.warning("config: %s", i)
    if errors:
        raise ConfigError(errors)
