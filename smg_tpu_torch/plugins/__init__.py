"""Middleware plugins: the contract (``spec``) and the host that runs them."""

from smg_tpu_torch.plugins.spec import (
    Action,
    Continue,
    Modify,
    PluginRequest,
    PluginResponse,
    Reject,
)
from smg_tpu_torch.plugins.host import PluginHost

__all__ = [
    "Action",
    "Continue",
    "Modify",
    "PluginHost",
    "PluginRequest",
    "PluginResponse",
    "Reject",
]
