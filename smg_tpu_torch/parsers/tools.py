"""Streaming tool-call parsers for model-specific dialects.

Reference: ``crates/tool_parser/src/parsers/`` — 19 dialects with an
incremental partial-JSON core and a factory keyed by model name (SURVEY.md
§2.2).  This implements the shared streaming machine plus the major dialect
families: json, qwen (<tool_call> XML-ish), mistral ([TOOL_CALLS]), llama3
(<|python_tag|> / raw json), deepseek-v3, kimi_k2, glm4_moe (<arg_key>/
<arg_value>), pythonic (llama-4 style), step3, passthrough.

Streaming contract: ``feed(text) -> ToolDelta`` where normal text streams out
immediately (with marker holdback) and each completed tool call is emitted as
one delta carrying full arguments; ``flush()`` finalizes.  ``parse_full`` is
the non-streaming convenience used by the non-stream chat path.

The port's copy of ``smg_tpu/parsers/tools.py``, unchanged but for its imports.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field

from smg_tpu_torch.parsers.partial_json import parse_partial


@dataclass
class ParsedToolCall:
    name: str
    arguments: str  # JSON-encoded string (OpenAI wire format)
    id: str = field(default_factory=lambda: f"call_{uuid.uuid4().hex[:24]}")
    index: int = 0


@dataclass
class ToolDelta:
    normal_text: str = ""
    calls: list[ParsedToolCall] = field(default_factory=list)


def _json_args(obj) -> str:
    return json.dumps(obj if obj is not None else {}, ensure_ascii=False)


class ToolCallParser:
    """Base streaming machine: scan for a start marker, buffer the call body
    until the parser extracts complete call(s), emit."""

    name = "base"
    start_markers: tuple[str, ...] = ()

    def __init__(self):
        self._buf = ""
        self._in_call = False
        self._n_emitted = 0

    # dialect hooks ------------------------------------------------------
    def _find_start(self, buf: str) -> int:
        idxs = [buf.find(m) for m in self.start_markers]
        idxs = [i for i in idxs if i != -1]
        return min(idxs) if idxs else -1

    def _try_extract(self, buf: str) -> tuple[list[ParsedToolCall], str, bool]:
        """Try to parse completed calls from a buffer that starts at a start
        marker.  Returns (calls, remaining_buffer, done_with_call_block).
        ``done`` with no calls and an unconsumed buffer means "this marker is
        plain text" — the machine emits one char and rescans."""
        raise NotImplementedError

    # streaming ----------------------------------------------------------
    def feed(self, text: str) -> ToolDelta:
        out = ToolDelta()
        self._buf += text
        while True:
            if not self._in_call:
                idx = self._find_start(self._buf)
                if idx == -1:
                    hold = max((len(m) for m in self.start_markers), default=1) - 1
                    emit_len = len(self._buf)
                    for k in range(min(hold, len(self._buf)), 0, -1):
                        tail = self._buf[-k:]
                        if any(m.startswith(tail) for m in self.start_markers):
                            emit_len = len(self._buf) - k
                            break
                    out.normal_text += self._buf[:emit_len]
                    self._buf = self._buf[emit_len:]
                    return out
                out.normal_text += self._buf[:idx]
                self._buf = self._buf[idx:]
                self._in_call = True
            calls, rest, done = self._try_extract(self._buf)
            for c in calls:
                c.index = self._n_emitted
                self._n_emitted += 1
            out.calls.extend(calls)
            if not done:
                return out  # wait for more text
            if not calls and rest == self._buf:
                # false start: the marker char is plain text — emit it and rescan
                out.normal_text += self._buf[0]
                rest = self._buf[1:]
            self._buf = rest
            self._in_call = False

    def flush(self) -> ToolDelta:
        out = ToolDelta()
        if self._in_call:
            calls, rest, _ = self._try_extract(self._buf)
            if calls:
                for c in calls:
                    c.index = self._n_emitted
                    self._n_emitted += 1
                out.calls.extend(calls)
            else:
                out.normal_text += self._buf
        else:
            out.normal_text += self._buf
        self._buf = ""
        self._in_call = False
        return out

    def parse_full(self, text: str) -> tuple[str, list[ParsedToolCall]]:
        d1 = self.feed(text)
        d2 = self.flush()
        return (d1.normal_text + d2.normal_text).strip(), d1.calls + d2.calls


class PassthroughToolParser(ToolCallParser):
    name = "passthrough"

    def feed(self, text: str) -> ToolDelta:
        return ToolDelta(normal_text=text)

    def flush(self) -> ToolDelta:
        return ToolDelta()


class JsonToolParser(ToolCallParser):
    """Raw JSON calls: ``{"name": ..., "arguments"|"parameters": ...}`` or an
    array of them (reference: parsers/json.rs)."""

    name = "json"
    start_markers = ("{", "[")

    def _obj_to_call(self, obj) -> ParsedToolCall | None:
        if isinstance(obj, dict) and "name" in obj:
            args = obj.get("arguments", obj.get("parameters", {}))
            return ParsedToolCall(name=obj["name"], arguments=_json_args(args))
        return None

    def _try_extract(self, buf):
        try:
            obj, end = json.JSONDecoder().raw_decode(buf)
        except json.JSONDecodeError:
            val = parse_partial(buf)
            ok = val is not None and (
                (isinstance(val, dict) and "name" in val)
                or (isinstance(val, list) and all(isinstance(x, dict) for x in val))
            )
            if ok:
                return [], buf, False  # plausible prefix: keep buffering
            return [], buf, True  # not a tool call: treat as text (flush path)
        objs = obj if isinstance(obj, list) else [obj]
        calls = [c for c in (self._obj_to_call(o) for o in objs) if c]
        if not calls:
            return [], buf, True
        return calls, buf[end:], True

    def flush(self) -> ToolDelta:
        out = ToolDelta()
        if self._in_call:
            try:
                obj, end = json.JSONDecoder().raw_decode(self._buf)
                objs = obj if isinstance(obj, list) else [obj]
                calls = [c for c in (self._obj_to_call(o) for o in objs) if c]
                if calls:
                    for c in calls:
                        c.index = self._n_emitted
                        self._n_emitted += 1
                    out.calls.extend(calls)
                    self._buf = self._buf[end:]
            except json.JSONDecodeError:
                pass
            out.normal_text += self._buf
        else:
            out.normal_text += self._buf
        self._buf = ""
        self._in_call = False
        return out


class TagBlockToolParser(ToolCallParser):
    """Calls wrapped in open/close tags with a JSON body.
    Covers qwen (<tool_call>), step3/minimax variants by parameterization."""

    name = "qwen"
    open_tag = "<tool_call>"
    close_tag = "</tool_call>"

    @property
    def start_markers(self):
        return (self.open_tag,)

    def _try_extract(self, buf):
        end = buf.find(self.close_tag)
        if end == -1:
            return [], buf, False
        body = buf[len(self.open_tag): end].strip()
        rest = buf[end + len(self.close_tag):]
        obj = parse_partial(body)
        calls = []
        if isinstance(obj, dict) and "name" in obj:
            args = obj.get("arguments", obj.get("parameters", {}))
            calls.append(ParsedToolCall(name=obj["name"], arguments=_json_args(args)))
        return calls, rest, True


class MistralToolParser(ToolCallParser):
    """``[TOOL_CALLS] [{...}, ...]`` (reference: parsers/mistral.rs)."""

    name = "mistral"
    start_markers = ("[TOOL_CALLS]",)

    def _try_extract(self, buf):
        body = buf[len("[TOOL_CALLS]"):].lstrip()
        try:
            obj, end = json.JSONDecoder().raw_decode(body)
        except json.JSONDecodeError:
            return [], buf, False
        objs = obj if isinstance(obj, list) else [obj]
        calls = [
            ParsedToolCall(
                name=o["name"], arguments=_json_args(o.get("arguments", o.get("parameters")))
            )
            for o in objs
            if isinstance(o, dict) and "name" in o
        ]
        return calls, body[end:], True


class Llama3ToolParser(JsonToolParser):
    """Llama 3.x: raw JSON (possibly after <|python_tag|>), semicolon-chained
    (reference: parsers/llama.rs)."""

    name = "llama"
    start_markers = ("<|python_tag|>", "{")

    def _try_extract(self, buf):
        if buf.startswith("<|python_tag|>"):
            buf = buf[len("<|python_tag|>"):]
        calls: list[ParsedToolCall] = []
        rest = buf
        while True:
            rest_stripped = rest.lstrip(" ;\n")
            try:
                obj, end = json.JSONDecoder().raw_decode(rest_stripped)
            except json.JSONDecodeError:
                break
            call = self._obj_to_call(obj)
            if call is None:
                break
            calls.append(call)
            rest = rest_stripped[end:]
            if not rest.lstrip().startswith(";"):
                break
        if calls:
            return calls, rest, True
        val = parse_partial(buf)
        if val is not None and isinstance(val, dict) and ("name" in val or not val):
            return [], buf, False
        return [], buf, True


class DeepseekV3ToolParser(ToolCallParser):
    """DeepSeek-V3/R1 dialect (reference: parsers/deepseek.rs):
    ``<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function<｜tool▁sep｜>NAME\\n
    ```json\\n{...}\\n```<｜tool▁call▁end｜>...<｜tool▁calls▁end｜>``"""

    name = "deepseek"
    start_markers = ("<｜tool▁calls▁begin｜>",)
    _call_re = re.compile(
        r"<｜tool▁call▁begin｜>function<｜tool▁sep｜>([^\n]+)\n```json\n(.*?)\n```<｜tool▁call▁end｜>",
        re.S,
    )

    def _try_extract(self, buf):
        end = buf.find("<｜tool▁calls▁end｜>")
        if end == -1:
            return [], buf, False
        block = buf[:end]
        rest = buf[end + len("<｜tool▁calls▁end｜>"):]
        calls = []
        for m in self._call_re.finditer(block):
            args = parse_partial(m.group(2))
            calls.append(
                ParsedToolCall(name=m.group(1).strip(), arguments=_json_args(args))
            )
        return calls, rest, True


class KimiK2ToolParser(ToolCallParser):
    """Kimi-K2 (reference: parsers/kimik2.rs):
    ``<|tool_calls_section_begin|><|tool_call_begin|>functions.NAME:IDX
    <|tool_call_argument_begin|>{json}<|tool_call_end|>...``"""

    name = "kimik2"
    start_markers = ("<|tool_calls_section_begin|>",)
    _call_re = re.compile(
        r"<\|tool_call_begin\|>\s*functions\.([\w.-]+):(\d+)\s*"
        r"<\|tool_call_argument_begin\|>(.*?)<\|tool_call_end\|>",
        re.S,
    )

    def _try_extract(self, buf):
        end = buf.find("<|tool_calls_section_end|>")
        if end == -1:
            return [], buf, False
        block = buf[:end]
        rest = buf[end + len("<|tool_calls_section_end|>"):]
        calls = []
        for m in self._call_re.finditer(block):
            args = parse_partial(m.group(3).strip())
            calls.append(ParsedToolCall(name=m.group(1), arguments=_json_args(args)))
        return calls, rest, True


class Glm4MoeToolParser(ToolCallParser):
    """GLM-4.5 (reference: parsers/glm4_moe.rs): ``<tool_call>NAME\\n
    <arg_key>K</arg_key>\\n<arg_value>V</arg_value>...</tool_call>``"""

    name = "glm4_moe"
    start_markers = ("<tool_call>",)
    _kv_re = re.compile(r"<arg_key>(.*?)</arg_key>\s*<arg_value>(.*?)</arg_value>", re.S)

    def _try_extract(self, buf):
        end = buf.find("</tool_call>")
        if end == -1:
            return [], buf, False
        body = buf[len("<tool_call>"): end].strip()
        rest = buf[end + len("</tool_call>"):]
        lines = body.split("\n", 1)
        fn_name = lines[0].strip()
        args = {}
        for m in self._kv_re.finditer(body):
            val = m.group(2).strip()
            try:
                args[m.group(1).strip()] = json.loads(val)
            except json.JSONDecodeError:
                args[m.group(1).strip()] = val
        if not fn_name:
            return [], rest, True
        return [ParsedToolCall(name=fn_name, arguments=_json_args(args))], rest, True


class PythonicToolParser(ToolCallParser):
    """Llama-4 pythonic dialect (reference: parsers/pythonic.rs):
    ``[get_weather(city="Paris"), search(q="x")]``"""

    name = "pythonic"
    start_markers = ("[",)
    _looks_like = re.compile(r"^\[\s*[\w.]+\s*\(")

    def _try_extract(self, buf):
        if not self._looks_like.match(buf):
            return [], buf, True  # plain text starting with '['
        # find the matching close bracket at depth 0 outside strings
        depth = 0
        in_str: str | None = None
        for i, ch in enumerate(buf):
            if in_str:
                if ch == in_str and buf[i - 1] != "\\":
                    in_str = None
                continue
            if ch in "'\"":
                in_str = ch
            elif ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
                if depth == 0:
                    block, rest = buf[: i + 1], buf[i + 1:]
                    return self._parse_block(block), rest, True
        return [], buf, False

    def _parse_block(self, block: str) -> list[ParsedToolCall]:
        try:
            tree = ast.parse(block, mode="eval")
        except SyntaxError:
            return []
        if not isinstance(tree.body, ast.List):
            return []
        calls = []
        for node in tree.body.elts:
            if not isinstance(node, ast.Call):
                continue
            name = ast.unparse(node.func)
            args = {}
            for kw in node.keywords:
                try:
                    args[kw.arg] = ast.literal_eval(kw.value)
                except (ValueError, SyntaxError):
                    args[kw.arg] = ast.unparse(kw.value)
            calls.append(ParsedToolCall(name=name, arguments=_json_args(args)))
        return calls


class MinimaxM2ToolParser(ToolCallParser):
    """MiniMax-M2 XML-invoke dialect:
    ``<minimax:tool_call><invoke name="f"><parameter name="k">v</parameter>
    </invoke></minimax:tool_call>`` (reference: parsers/minimax_m2.rs)."""

    name = "minimax_m2"
    start_markers = ("<minimax:tool_call>",)
    _invoke_re = re.compile(r'<invoke name="([^"]+)">(.*?)</invoke>', re.S)
    _param_re = re.compile(r'<parameter name="([^"]+)">(.*?)</parameter>', re.S)

    def _try_extract(self, buf):
        end = buf.find("</minimax:tool_call>")
        if end == -1:
            return [], buf, False
        block = buf[len("<minimax:tool_call>"): end]
        rest = buf[end + len("</minimax:tool_call>"):]
        calls = []
        for m in self._invoke_re.finditer(block):
            args = {}
            for pm in self._param_re.finditer(m.group(2)):
                val = pm.group(2).strip()
                try:
                    args[pm.group(1)] = json.loads(val)
                except json.JSONDecodeError:
                    args[pm.group(1)] = val
            calls.append(ParsedToolCall(name=m.group(1), arguments=_json_args(args)))
        return calls, rest, True


class CohereToolParser(ToolCallParser):
    """Cohere Command dialect: ``<|START_ACTION|>{"tool_name": ...,
    "parameters": {...}}<|END_ACTION|>`` — single object or array
    (reference: parsers/cohere.rs; tool_name->name, parameters->arguments)."""

    name = "cohere"
    start_markers = ("<|START_ACTION|>",)

    def _try_extract(self, buf):
        end = buf.find("<|END_ACTION|>")
        if end == -1:
            return [], buf, False
        body = buf[len("<|START_ACTION|>"): end].strip()
        rest = buf[end + len("<|END_ACTION|>"):]
        obj = parse_partial(body)
        objs = obj if isinstance(obj, list) else [obj] if obj else []
        calls = [
            ParsedToolCall(
                name=o.get("tool_name", o.get("name", "")),
                arguments=_json_args(o.get("parameters", o.get("arguments", {}))),
            )
            for o in objs
            if isinstance(o, dict) and (o.get("tool_name") or o.get("name"))
        ]
        return calls, rest, True


class SarashinaToolParser(ToolCallParser):
    """Sarashina dialect: python-literal list of dicts, optionally after a
    ``<|tool_calls|>`` marker: ``[{'name': 'f', 'arguments': {...}}]``
    (reference: parsers/sarashina.rs; the marker is a special token usually
    stripped in detokenization, so the bare list is also recognized)."""

    name = "sarashina"
    start_markers = ("<|tool_calls|>", "[")

    def _try_extract(self, buf):
        body = buf
        if body.startswith("<|tool_calls|>"):
            body = body[len("<|tool_calls|>"):].lstrip()
            if not body:
                return [], buf, False
        if not body.startswith("["):
            return [], buf, True
        # find balanced close bracket outside strings
        depth = 0
        in_str: str | None = None
        for i, ch in enumerate(body):
            if in_str:
                if ch == in_str and body[i - 1] != "\\":
                    in_str = None
                continue
            if ch in "'\"":
                in_str = ch
            elif ch in "[{(":
                depth += 1
            elif ch in ")}]":
                depth -= 1
                if depth == 0:
                    block, rest = body[: i + 1], body[i + 1:]
                    try:
                        objs = ast.literal_eval(block)
                    except (ValueError, SyntaxError):
                        return [], buf, True
                    if not isinstance(objs, list):
                        return [], buf, True
                    calls = [
                        ParsedToolCall(
                            name=o.get("name", ""), arguments=_json_args(o.get("arguments", {}))
                        )
                        for o in objs
                        if isinstance(o, dict) and o.get("name")
                    ]
                    if not calls:
                        return [], buf, True
                    return calls, rest, True
        return [], buf, False


class Step3ToolParser(TagBlockToolParser):
    """Step-3 dialect: steptml invoke blocks (reference: parsers/step3.rs);
    simplified to the tag-block JSON form used by its chat template."""

    name = "step3"
    open_tag = "<step_tool_call>"
    close_tag = "</step_tool_call>"


class DeepSeek31ToolParser(ToolCallParser):
    """DeepSeek-V3.1 dialect (reference: parsers/deepseek31.rs): like the V3
    block format but with no ``function`` type prefix and raw JSON args —
    ``<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>NAME<｜tool▁sep｜>{json}
    <｜tool▁call▁end｜>…<｜tool▁calls▁end｜>``.  Non-object JSON args wrap as
    ``{"value": …}``."""

    name = "deepseek31"
    _EOS = "<｜end▁of▁sentence｜>"
    start_markers = ("<｜tool▁calls▁begin｜>", _EOS)
    _call_re = re.compile(
        r"<｜tool▁call▁begin｜>(.*?)<｜tool▁sep｜>(.*?)<｜tool▁call▁end｜>", re.S
    )

    def _try_extract(self, buf):
        if buf.startswith(self._EOS):  # stray EOS sentinel: consume silently
            return [], buf[len(self._EOS):], True
        end = buf.find("<｜tool▁calls▁end｜>")
        if end == -1:
            return [], buf, False
        block = buf[:end]
        rest = buf[end + len("<｜tool▁calls▁end｜>"):].replace(self._EOS, "")
        calls = []
        for m in self._call_re.finditer(block):
            raw = m.group(2).replace(self._EOS, "").strip()
            try:
                val = json.loads(raw)
            except ValueError:
                val = parse_partial(raw)
            if not isinstance(val, dict):
                val = {"value": val}
            calls.append(
                ParsedToolCall(name=m.group(1).strip(), arguments=_json_args(val))
            )
        return calls, rest, True


class DeepseekDsmlToolParser(ToolCallParser):
    """DeepSeek DSML dialect (reference: parsers/deepseek_dsml.rs):
    ``<｜DSML｜invoke name="func"> <｜DSML｜parameter name="k" string="true">v
    </｜DSML｜parameter> … </｜DSML｜invoke>`` — parameters typed by the
    ``string`` attribute (false => parse value as JSON), or a direct JSON
    object body."""

    name = "deepseek_dsml"
    start_markers = ("<｜DSML｜invoke",)
    _invoke_re = re.compile(
        r'<｜DSML｜invoke\s+name="([^"]+)"\s*>(.*?)</｜DSML｜invoke>', re.S
    )
    _param_re = re.compile(
        r'<｜DSML｜parameter\s+name="([^"]+)"(?:\s+string="(true|false)")?\s*>'
        r"(.*?)</｜DSML｜parameter>",
        re.S,
    )
    _EOS = "<｜end▁of▁sentence｜>"

    def _try_extract(self, buf):
        m = self._invoke_re.match(buf)
        if m is None:
            if "</｜DSML｜invoke>" in buf:
                # closed but unparseable invoke: drop the frame as protocol data
                end = buf.find("</｜DSML｜invoke>") + len("</｜DSML｜invoke>")
                return [], buf[end:], True
            return [], buf, False
        body = m.group(2).replace(self._EOS, "")
        rest = buf[m.end():]
        stripped = body.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            try:
                args = json.loads(stripped)
            except ValueError:
                args = parse_partial(stripped) or {}
        else:
            args = {}
            for pm in self._param_re.finditer(body):
                key, is_string, value = pm.group(1), pm.group(2), pm.group(3)
                if (is_string or "true") == "true":
                    args[key] = value
                else:
                    try:
                        args[key] = json.loads(value.strip())
                    except ValueError:
                        args[key] = value
        return [ParsedToolCall(name=m.group(1), arguments=_json_args(args))], rest, True


def _xml_unescape(s: str) -> str:
    import html

    return html.unescape(s)


class QwenXmlToolParser(ToolCallParser):
    """Qwen3-Coder XML dialect (reference: parsers/qwen_xml.rs):
    ``<tool_call>\\n<function=NAME>\\n<parameter=KEY>\\nVALUE\\n</parameter>
    …\\n</function>\\n</tool_call>`` with XML-entity unescaping and
    best-effort value typing (JSON literals parse, everything else strings)."""

    name = "qwen_xml"
    start_markers = ("<tool_call>",)
    _fn_re = re.compile(r"<function=([^>]+)>")
    _param_re = re.compile(r"<parameter=([^>]+)>(.*?)</parameter>", re.S)
    _JSONISH = re.compile(r"^(?:-?\d|\{|\[|true\b|false\b|null\b)")

    def _coerce(self, value: str):
        v = _xml_unescape(value.strip("\n"))
        s = v.strip()
        if self._JSONISH.match(s):
            try:
                return json.loads(s)
            except ValueError:
                pass
        return v

    def _try_extract(self, buf):
        end = buf.find("</tool_call>")
        if end == -1:
            return [], buf, False
        body = buf[len("<tool_call>"): end]
        rest = buf[end + len("</tool_call>"):]
        fm = self._fn_re.search(body)
        if fm is None or not fm.group(1).strip():
            return [], rest, True  # malformed frame: drop as protocol data
        args = {
            pm.group(1).strip(): self._coerce(pm.group(2))
            for pm in self._param_re.finditer(body)
        }
        return (
            [ParsedToolCall(name=fm.group(1).strip(), arguments=_json_args(args))],
            rest,
            True,
        )


class InklingToolParser(ToolCallParser):
    """Inkling typed-message dialect (reference: parsers/inkling.rs):
    ``<|content_invoke_tool_json|>{json}<|end_message|>`` frames carry calls;
    text-mode invocations are protocol data and are discarded; other control
    tokens are stripped from normal text."""

    name = "inkling"
    _JSON_START = "<|content_invoke_tool_json|>"
    _TEXT_START = "<|content_invoke_tool_text|>"
    _END = "<|end_message|>"
    _END_SAMPLING = "<|content_model_end_sampling|>"
    # control tokens consumed silently from the normal-text stream
    _CONTROL = ("<|message_model|>", "<|content_text|>", "<|content_thinking|>",
                _END, _END_SAMPLING)
    start_markers = (_JSON_START, _TEXT_START) + _CONTROL

    def _try_extract(self, buf):
        for tok in self._CONTROL:
            if buf.startswith(tok):
                return [], buf[len(tok):], True
        if buf.startswith(self._TEXT_START):
            # text-mode tool frames can't map to OpenAI calls: drop the frame
            end = buf.find(self._END)
            if end == -1:
                return [], buf, False
            return [], buf[end + len(self._END):], True
        payload = buf[len(self._JSON_START):].lstrip()
        try:
            obj, jend = json.JSONDecoder().raw_decode(payload)
        except json.JSONDecodeError:
            if self._END in payload:  # malformed but closed frame: suppress it
                end = buf.find(self._END)
                return [], buf[end + len(self._END):], True
            return [], buf, False
        rest = payload[jend:]
        stripped = rest.lstrip()
        for tok in (self._END, self._END_SAMPLING):
            if stripped.startswith(tok):
                rest = stripped[len(tok):]
                break
        calls = []
        if isinstance(obj, dict) and obj.get("name"):
            args = obj.get("arguments", obj.get("parameters", {}))
            calls.append(ParsedToolCall(name=obj["name"], arguments=_json_args(args)))
        return calls, rest, True


_PARSERS: dict[str, type[ToolCallParser]] = {
    p.name: p
    for p in (
        JsonToolParser,
        TagBlockToolParser,
        MistralToolParser,
        Llama3ToolParser,
        DeepseekV3ToolParser,
        DeepSeek31ToolParser,
        DeepseekDsmlToolParser,
        KimiK2ToolParser,
        Glm4MoeToolParser,
        PythonicToolParser,
        MinimaxM2ToolParser,
        CohereToolParser,
        SarashinaToolParser,
        Step3ToolParser,
        QwenXmlToolParser,
        InklingToolParser,
        PassthroughToolParser,
    )
}

_MODEL_MAP = [
    ("qwen3-coder", "qwen_xml"),
    ("qwen", "qwen"),
    ("mistral", "mistral"),
    ("mixtral", "mistral"),
    ("llama-4", "pythonic"),
    ("llama4", "pythonic"),
    ("llama", "llama"),
    ("deepseek-v3.1", "deepseek31"),
    ("deepseek-3.1", "deepseek31"),
    ("dsml", "deepseek_dsml"),
    ("deepseek", "deepseek"),
    ("inkling", "inkling"),
    ("gpt-oss", "harmony"),
    ("kimi-k2", "kimik2"),
    ("kimi", "kimik2"),
    ("glm-4", "glm4_moe"),
    ("glm4", "glm4_moe"),
    ("step-3", "step3"),
    ("step3", "step3"),
    ("minimax", "minimax_m2"),
    ("command-a", "cohere"),
    ("cohere", "cohere"),
    ("sarashina", "sarashina"),
]


def _make(parser_name: str) -> ToolCallParser:
    if parser_name == "harmony":  # lazy: harmony.py imports from this module
        from smg_tpu_torch.parsers.harmony import HarmonyToolParser

        return HarmonyToolParser()
    return _PARSERS[parser_name]()


def get_tool_parser(name_or_model: str | None) -> ToolCallParser:
    if not name_or_model:
        return JsonToolParser()
    key = name_or_model.lower()
    if key in _PARSERS or key == "harmony":
        return _make(key)
    for sub, parser_name in _MODEL_MAP:
        if sub in key:
            return _make(parser_name)
    return JsonToolParser()
