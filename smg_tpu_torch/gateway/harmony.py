"""Harmony (gpt-oss) serving pipeline: channel-structured prompt building
and streaming channel demux.

Reference: ``model_gateway/src/routers/grpc/harmony/`` — ``builder.rs``
(Chat/Responses -> harmony-encoded prompt: system message with reasoning
effort + channel config, developer message with ``# Instructions`` and the
TypeScript-namespace tool block, channel-tagged history), ``streaming.rs``
(token stream -> analysis/commentary/final channel deltas with incremental
tool-call argument streaming), and ``detector.rs`` (model-name detection).
The pipeline entry mirrors ``routers/grpc/pipeline.rs:1073-1191``: harmony
models bypass the HF chat template entirely — the gateway renders the
harmony frame format itself and always demuxes channels on the way out so
raw channel markup never reaches a client.

Format (openai-harmony spec):

    <|start|>system<|message|>...<|end|>
    <|start|>developer<|message|># Instructions\\n...\\n# Tools\\n...<|end|>
    <|start|>user<|message|>Hi<|end|>
    <|start|>assistant<|channel|>analysis<|message|>...thinking...<|end|>
    <|start|>assistant<|channel|>commentary to=functions.NAME <|constrain|>json
        <|message|>{args}<|call|>
    <|start|>functions.NAME to=assistant<|channel|>commentary<|message|>{out}<|end|>
    <|start|>assistant<|channel|>final<|message|>...answer...<|return|>

The port's copy of ``smg_tpu/gateway/harmony.py``, unchanged but for its imports.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from smg_tpu_torch.parsers.harmony import (
    _ALL_MARKERS,
    _earliest,
    _partial_marker_holdback,
)

#: generation stops: end-of-response and end-of-tool-call (the reference
#: injects the encoding's stop token ids; text-level stops are the
#: tokenizer-agnostic equivalent)
HARMONY_STOPS = ["<|return|>", "<|call|>"]

_IDENTITY = "You are ChatGPT, a large language model trained by OpenAI."
_CUTOFF = "2024-06"


def is_harmony_model(model: str | None) -> bool:
    """Reference ``detector.rs``: gpt-oss models speak harmony."""
    if not model:
        return False
    m = model.lower()
    return "gpt-oss" in m or "gpt_oss" in m or "gptoss" in m


def _text_of(content) -> str:
    """Flatten OpenAI content (plain string OR content-parts list) to text."""
    if isinstance(content, list):
        return "".join(
            str(p.get("text") or "") for p in content
            if isinstance(p, dict) and p.get("type") in ("text", "input_text", None)
        )
    return str(content or "")


# ---- builder (reference: builder.rs) ----


def _ts_type(schema: dict | None) -> str:
    """JSON schema -> TypeScript-ish type for the functions namespace."""
    if not isinstance(schema, dict):
        return "any"
    if "enum" in schema:
        return " | ".join(json.dumps(v) for v in schema["enum"])
    t = schema.get("type")
    if t == "string":
        return "string"
    if t in ("number", "integer"):
        return "number"
    if t == "boolean":
        return "boolean"
    if t == "array":
        return _ts_type(schema.get("items")) + "[]"
    if t == "object":
        props = schema.get("properties") or {}
        if not props:
            return "object"
        required = set(schema.get("required") or [])
        lines = ["{"]
        for name, sub in props.items():
            if isinstance(sub, dict) and sub.get("description"):
                lines.append(f"// {sub['description']}")
            opt = "" if name in required else "?"
            lines.append(f"{name}{opt}: {_ts_type(sub)},")
        lines.append("}")
        return "\n".join(lines)
    return "any"


def render_tool_namespace(tools: list[dict]) -> str:
    """``namespace functions { ... }`` block for the developer message."""
    lines = ["## functions", "", "namespace functions {", ""]
    for t in tools:
        fn = t.get("function", t)
        desc = fn.get("description")
        if desc:
            lines.append(f"// {desc}")
        params = fn.get("parameters")
        if params and params.get("properties"):
            lines.append(f"type {fn.get('name')} = (_: {_ts_type(params)}) => any;")
        else:
            lines.append(f"type {fn.get('name')} = () => any;")
        lines.append("")
    lines.append("} // namespace functions")
    return "\n".join(lines)


def build_system_message(
    reasoning_effort: str = "medium",
    has_tools: bool = False,
    current_date: str | None = None,
) -> str:
    """Harmony system preamble: identity, cutoff/date, reasoning effort, and
    the channel contract (commentary only advertised when tools exist —
    reference ``build_system_message`` drops it otherwise)."""
    if current_date is None:
        import datetime

        current_date = datetime.date.today().isoformat()
    channels = "analysis, commentary, final" if has_tools else "analysis, final"
    parts = [
        _IDENTITY,
        f"Knowledge cutoff: {_CUTOFF}",
        f"Current date: {current_date}",
        "",
        f"Reasoning: {reasoning_effort}",
        "",
        f"# Valid channels: {channels}. "
        "Channel must be included for every message.",
    ]
    if has_tools:
        parts.append(
            "Calls to these tools must go to the commentary channel: 'functions'."
        )
    return "\n".join(parts)


def build_developer_message(
    tools: list[dict] | None, instructions: str | None
) -> str | None:
    """``# Instructions`` (user-supplied system prompt) + ``# Tools``."""
    sections = []
    if instructions:
        sections.append("# Instructions\n\n" + instructions)
    if tools:
        sections.append("# Tools\n\n" + render_tool_namespace(tools))
    return "\n\n".join(sections) if sections else None


def render_harmony_prompt(
    messages: list[dict],
    tools: list[dict] | None = None,
    reasoning_effort: str = "medium",
    current_date: str | None = None,
) -> str:
    """Chat messages -> harmony-encoded prompt text ending in the assistant
    generation header.

    Mapping (reference ``construct_input_messages_with_harmony``):
    system-role content becomes the DEVELOPER message's instructions (the
    harmony system message is the fixed channel contract); assistant turns
    re-render on the final channel with prior-turn analysis dropped;
    assistant tool calls re-render as commentary frames and tool results as
    ``functions.NAME to=assistant`` commentary frames.
    """
    instructions = "\n\n".join(
        _text_of(m.get("content")) for m in messages if m.get("role") == "system"
    ) or None
    out = [
        "<|start|>system<|message|>"
        + build_system_message(reasoning_effort, bool(tools), current_date)
        + "<|end|>"
    ]
    dev = build_developer_message(tools, instructions)
    if dev is not None:
        out.append("<|start|>developer<|message|>" + dev + "<|end|>")
    call_names: dict[str, str] = {}  # tool_call_id -> function name
    for m in messages:
        role = m.get("role")
        content = m.get("content")
        if role == "system":
            continue  # folded into the developer message
        if role == "assistant":
            for tc in m.get("tool_calls") or []:
                fn = tc.get("function", {})
                name = fn.get("name", "")
                call_names[tc.get("id", "")] = name
                out.append(
                    "<|start|>assistant<|channel|>commentary"
                    f" to=functions.{name} <|constrain|>json<|message|>"
                    + (fn.get("arguments") or "{}")
                    + "<|call|>"
                )
            if content:
                out.append(
                    "<|start|>assistant<|channel|>final<|message|>"
                    + _text_of(content) + "<|end|>"
                )
            continue
        if role == "tool":
            name = call_names.get(m.get("tool_call_id") or "", "tool")
            out.append(
                f"<|start|>functions.{name} to=assistant<|channel|>commentary"
                "<|message|>" + _text_of(content) + "<|end|>"
            )
            continue
        # user / developer / anything else: plain frame
        out.append(f"<|start|>{role}<|message|>" + _text_of(content) + "<|end|>")
    out.append("<|start|>assistant")
    return "".join(out)


# ---- streaming demux (reference: streaming.rs) ----


@dataclass
class HarmonyToolDelta:
    """Incremental tool-call update (OpenAI streaming shape)."""

    index: int
    id: str | None = None  # set on the opening delta only
    name: str | None = None  # set on the opening delta only
    arguments: str | None = None  # argument text fragment


@dataclass
class HarmonyDelta:
    analysis: str = ""  # reasoning_content delta
    final: str = ""  # user-visible content delta
    tool_deltas: list[HarmonyToolDelta] = field(default_factory=list)


class HarmonyStreamingProcessor:
    """Streaming channel demux: detokenized text in, per-channel deltas out.

    Unlike the generic reasoning->tool parser chain, tool-call ARGUMENTS
    stream incrementally (reference ``streaming.rs`` emits FunctionDelta
    fragments as the json body arrives), and plain commentary (user-facing
    preambles before a tool call) routes to ``final`` — user-visible per the
    harmony spec."""

    def __init__(self):
        self._buf = ""
        self._route = "final"  # final | analysis | tool
        self._in_header = False
        self._header_prefix = ""
        self._n_calls = 0
        self._open_call = False

    # route decision for one frame header
    def _enter_route(self, header: str, out: HarmonyDelta) -> str:
        if "to=functions." in header:
            raw = header.split("to=functions.", 1)[1].split("<|")[0].strip()
            name = raw.split()[0] if raw.split() else ""
            if name:
                out.tool_deltas.append(
                    HarmonyToolDelta(
                        index=self._n_calls,
                        id=f"call_{self._n_calls}",
                        name=name,
                        arguments="",
                    )
                )
                self._open_call = True
                return "tool"
            # nameless functions recipient (malformed): body flows as user
            # -visible text — same net behavior as parsers/harmony.py's
            # HarmonyToolParser for the degenerate frame
            return "final"
        if "analysis" in header:
            return "analysis"
        return "final"  # final and plain commentary are both user-visible

    def _emit(self, piece: str, out: HarmonyDelta) -> None:
        if not piece:
            return
        if self._route == "analysis":
            out.analysis += piece
        elif self._route == "tool":
            out.tool_deltas.append(
                HarmonyToolDelta(index=self._n_calls, arguments=piece)
            )
        else:
            out.final += piece

    def _close_call(self) -> None:
        if self._open_call:
            self._n_calls += 1
            self._open_call = False

    def feed(self, text: str) -> HarmonyDelta:
        out = HarmonyDelta()
        self._buf += text
        while self._buf:
            if self._in_header:
                i = self._buf.find("<|message|>")
                if i == -1:
                    if len(self._buf) > 4096:  # runaway header: bail out
                        self._in_header = False
                        self._route = "final"
                        continue
                    return out
                header = self._buf[:i]
                self._buf = self._buf[i + len("<|message|>"):]
                self._in_header = False
                self._route = self._enter_route(header, out)
                continue
            idx, marker = _earliest(
                self._buf, ("<|channel|>", "<|start|>", "<|end|>", "<|return|>",
                            "<|call|>")
            )
            if idx == -1:
                hold = _partial_marker_holdback(self._buf, _ALL_MARKERS)
                self._emit(self._buf[: len(self._buf) - hold], out)
                self._buf = self._buf[len(self._buf) - hold:]
                return out
            self._emit(self._buf[:idx], out)
            self._buf = self._buf[idx + len(marker):]
            if marker in ("<|channel|>", "<|start|>"):
                self._in_header = True
            else:  # frame terminator
                if self._route == "tool":
                    self._close_call()
                self._route = "final"
        return out

    def flush(self) -> HarmonyDelta:
        """End of stream: emit whatever is held back.  An open tool body is
        closed (the engine's stop-string handling eats ``<|call|>`` before
        the demux sees it); an unterminated header is dropped."""
        out = HarmonyDelta()
        if not self._in_header:
            self._emit(self._buf, out)
        if self._route == "tool":
            self._close_call()
        self._buf = ""
        self._in_header = False
        self._route = "final"
        return out

    def parse_full(self, text: str):
        """Whole-response parse -> (content, reasoning, calls) where calls
        are (id, name, arguments-json) triples assembled from the deltas."""
        d = self.feed(text)
        df = self.flush()
        deltas = d.tool_deltas + df.tool_deltas
        calls: list[dict] = []
        for td in deltas:
            while len(calls) <= td.index:
                calls.append({"id": None, "name": None, "arguments": ""})
            c = calls[td.index]
            if td.id is not None:
                c["id"] = td.id
            if td.name is not None:
                c["name"] = td.name
            if td.arguments:
                c["arguments"] += td.arguments
        calls = [c for c in calls if c["name"]]
        for c in calls:
            c["arguments"] = c["arguments"].strip() or "{}"
        return d.final + df.final, d.analysis + df.analysis, calls
