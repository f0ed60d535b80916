"""Streaming reasoning + tool-call parsers.

Reference: ``crates/reasoning_parser`` (11 parser families) and
``crates/tool_parser`` (19 model dialects) — SURVEY.md §2.2.  Behavior parity,
not code parity: each parser consumes an incremental text stream and splits it
into visible content / reasoning content / structured tool calls.

The port's copy of ``smg_tpu/parsers/__init__.py``, unchanged but for its imports.
"""

from smg_tpu_torch.parsers.reasoning import ReasoningParser, get_reasoning_parser
from smg_tpu_torch.parsers.tools import ToolCallParser, get_tool_parser

__all__ = [
    "ReasoningParser",
    "get_reasoning_parser",
    "ToolCallParser",
    "get_tool_parser",
]
