"""Startup validation of the port's command lines (``validation.py``)."""

from smg_tpu_torch.config.validation import (
    ConfigError,
    ValidationIssue,
    raise_on_errors,
    validate_cli_args,
    validate_gateway_config,
)

__all__ = [
    "ConfigError",
    "ValidationIssue",
    "raise_on_errors",
    "validate_cli_args",
    "validate_gateway_config",
]
