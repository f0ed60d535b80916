"""The port's parsers, harmony pipeline and chat path against the JAX
package's.

- Every tool-call dialect in ``smg_tpu.parsers.tools._PARSERS`` (and
  harmony), every reasoning family in ``smg_tpu.parsers.reasoning._FAMILIES``
  (and passthrough and harmony), and the gateway's harmony demux, over the
  reference's own cases: every string literal in ``tests/test_parsers.py``
  and ``tests/test_harmony_pipeline.py``.  Each text is fed whole, one
  character at a time and in three seeded chunkings; the delta sequences
  must be identical (tool-call ids, random by construction, removed).
- The model-name factories pick the same parser for every name in the
  reference's tables.
- Chat with ``tools``, with reasoning and on a harmony model, streamed and
  not, through the port's ``build_app`` and the reference's over one
  scripted worker stream: bodies and SSE frames identical once ids and
  timestamps are removed.
"""

import ast
import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from smg_tpu.gateway import harmony as jharmony
from smg_tpu.gateway import server as jserver
from smg_tpu.gateway import worker_client as jwc
from smg_tpu.gateway.workers import Worker as JaxWorker
from smg_tpu.parsers import partial_json as jpartial
from smg_tpu.parsers import reasoning as jreasoning
from smg_tpu.parsers import tools as jtools
from smg_tpu_torch.gateway import harmony as tharmony
from smg_tpu_torch.gateway import server as tserver
from smg_tpu_torch.gateway import worker_client as twc
from smg_tpu_torch.gateway.workers import Worker
from smg_tpu_torch.parsers import partial_json as tpartial
from smg_tpu_torch.parsers import reasoning as treasoning
from smg_tpu_torch.parsers import tools as ttools

TESTS = Path(__file__).resolve().parent


def _literals(name: str) -> list[str]:
    """Every string literal of a reference test file (implicit concatenations
    arrive joined), in source order, without duplicates."""
    tree = ast.parse((TESTS / name).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and len(node.value) >= 2 and node.value not in out:
            out.append(node.value)
    return out


CASES = _literals("test_parsers.py") + [
    t for t in _literals("test_harmony_pipeline.py")
    if t not in _literals("test_parsers.py")]


def _chunkings(text: str, seed: int) -> list[list[str]]:
    rng = np.random.default_rng(seed)
    out = [[text], list(text)]
    for _ in range(3):
        cuts = sorted(rng.choice(np.arange(1, max(len(text), 2)),
                                 size=min(len(text) - 1, int(rng.integers(1, 9))),
                                 replace=False).tolist()) if len(text) > 1 else []
        bounds = [0, *cuts, len(text)]
        out.append([text[a:b] for a, b in zip(bounds, bounds[1:])])
    return out


def _calls(calls) -> list:
    return [(c.name, c.arguments, c.index) for c in calls]


def _tool_stream(parser, pieces) -> list:
    seq = []
    for piece in pieces:
        d = parser.feed(piece)
        seq.append((d.normal_text, _calls(d.calls)))
    d = parser.flush()
    seq.append((d.normal_text, _calls(d.calls)))
    return seq


def _reasoning_stream(parser, pieces) -> list:
    seq = [(d.content, d.reasoning) for d in map(parser.feed, pieces)]
    d = parser.flush()
    return seq + [(d.content, d.reasoning)]


def test_cases_come_from_the_reference_tests():
    assert len(CASES) > 100
    assert any("<tool_call>" in t for t in CASES) and any("<|channel|>" in t for t in CASES)


@pytest.mark.parametrize("name", sorted(set(jtools._PARSERS) | {"harmony"}))
def test_tool_parser_matches_reference(name):
    assert sorted(jtools._PARSERS) == sorted(ttools._PARSERS)
    for i, text in enumerate(CASES):
        want_full = jtools.get_tool_parser(name).parse_full(text)
        got_full = ttools.get_tool_parser(name).parse_full(text)
        assert (got_full[0], _calls(got_full[1])) == (want_full[0], _calls(want_full[1])), text
        for pieces in _chunkings(text, seed=i):
            want = _tool_stream(jtools.get_tool_parser(name), pieces)
            got = _tool_stream(ttools.get_tool_parser(name), pieces)
            assert got == want, (name, pieces)


@pytest.mark.parametrize("name", sorted(jreasoning._FAMILIES) + ["passthrough", "harmony"])
def test_reasoning_parser_matches_reference(name):
    assert jreasoning._FAMILIES == treasoning._FAMILIES
    for i, text in enumerate(CASES):
        assert treasoning.get_reasoning_parser(name).parse_full(text) == \
            jreasoning.get_reasoning_parser(name).parse_full(text), text
        for pieces in _chunkings(text, seed=i):
            assert _reasoning_stream(treasoning.get_reasoning_parser(name), pieces) == \
                _reasoning_stream(jreasoning.get_reasoning_parser(name), pieces), (name, pieces)


MODEL_NAMES = sorted({sub for sub, _ in jtools._MODEL_MAP} | {sub for sub, _ in jreasoning._MODEL_MAP}
                     | {"gpt-oss-120b", "llama3-8b", "some-unknown-model", "", "passthrough"})


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_factories_pick_the_same_parser(model):
    assert jtools._MODEL_MAP == ttools._MODEL_MAP
    assert jreasoning._MODEL_MAP == treasoning._MODEL_MAP
    for m in (model, model.upper(), f"org/{model}-instruct"):
        assert type(ttools.get_tool_parser(m)).__name__ == type(jtools.get_tool_parser(m)).__name__
        assert ttools.get_tool_parser(m).name == jtools.get_tool_parser(m).name
        tr, jr = treasoning.get_reasoning_parser(m), jreasoning.get_reasoning_parser(m)
        assert (type(tr).__name__, tr.name) == (type(jr).__name__, jr.name)


def test_partial_json_matches_reference():
    # every prefix of each case's JSON-looking tail: what a streaming tool
    # parser hands the partial-JSON core
    tails = {t[min(i for i in (t.find("{"), t.find("[")) if i >= 0):]
             for t in CASES if "{" in t or "[" in t}
    for text in tails:
        for end in range(len(text) + 1):
            prefix = text[:end]
            assert tpartial.complete_json(prefix) == jpartial.complete_json(prefix)
            assert tpartial.parse_partial(prefix) == jpartial.parse_partial(prefix)


def _harmony_stream(hp, pieces) -> list:
    seq = []
    for d in [*map(hp.feed, pieces), hp.flush()]:
        seq.append((d.analysis, d.final, [(t.index, t.id, t.name, t.arguments)
                                          for t in d.tool_deltas]))
    return seq


def test_harmony_demux_matches_reference():
    for i, text in enumerate(CASES):
        assert tharmony.HarmonyStreamingProcessor().parse_full(text) == \
            jharmony.HarmonyStreamingProcessor().parse_full(text), text
        for pieces in _chunkings(text, seed=i):
            assert _harmony_stream(tharmony.HarmonyStreamingProcessor(), pieces) == \
                _harmony_stream(jharmony.HarmonyStreamingProcessor(), pieces), pieces


WEATHER_TOOL = {
    "type": "function",
    "function": {
        "name": "get_weather", "description": "Get the weather",
        "parameters": {"type": "object", "required": ["city"], "properties": {
            "city": {"type": "string", "description": "The city"},
            "unit": {"type": "string", "enum": ["c", "f"]}}},
    },
}


def test_harmony_prompt_matches_reference():
    assert tharmony.HARMONY_STOPS == jharmony.HARMONY_STOPS
    histories = [
        [{"role": "user", "content": "hi"}],
        [{"role": "system", "content": "Be terse."},
         {"role": "user", "content": "weather in Paris?"},
         {"role": "assistant", "content": None, "tool_calls": [{
             "id": "call_0", "type": "function",
             "function": {"name": "get_weather", "arguments": '{"city": "Paris"}'}}]},
         {"role": "tool", "tool_call_id": "call_0", "content": "18C sunny"}],
        [{"role": "developer", "content": "dev"},
         {"role": "user", "content": [{"type": "text", "text": "hello "},
                                      {"type": "text", "text": "world"}]}],
    ]
    for messages in histories:
        for tools in (None, [WEATHER_TOOL]):
            for effort in ("low", "medium", "high"):
                kw = dict(tools=tools, reasoning_effort=effort, current_date="2026-07-30")
                assert tharmony.render_harmony_prompt(messages, **kw) == \
                    jharmony.render_harmony_prompt(messages, **kw)
    for name in ("gpt-oss-120b", "openai/GPT-OSS-20b", "gpt_oss_tiny", "llama-3-8b", None):
        assert tharmony.is_harmony_model(name) == jharmony.is_harmony_model(name)


# ---- the chat path through both gateways over one scripted stream ----


class CharTokenizer:
    """Text as code points; the chat template writes roles, contents and the
    tools' JSON, so a change in what the gateway renders shows in the
    prompt ids."""

    eos_token_id = 0

    def encode(self, text: str, add_special_tokens: bool = False):
        return [ord(c) for c in text]

    def decode(self, ids, skip_special_tokens: bool = True):
        return "".join(chr(i) for i in ids)

    def apply_chat_template(self, messages, add_generation_prompt=True, tools=None, **_):
        text = "".join(f"<{m['role']}>{m.get('content')}" for m in messages)
        return text + (json.dumps(tools) if tools else "") + "<assistant>"


def scripted_worker(wc):
    """A worker of ``wc``'s package that streams ``script`` as code points,
    ``chunk`` tokens a chunk, and records the prompt and sampling it got."""

    class Scripted(wc.WorkerClient):
        def __init__(self):
            self.script, self.chunk, self.seen = "", 3, []

        async def generate(self, req):
            self.seen.append((list(req.input_ids), req.sampling.stop,
                              req.sampling.skip_special_tokens))
            ids = [ord(c) for c in self.script]
            for i in range(0, len(ids), self.chunk):
                last = i + self.chunk >= len(ids)
                yield wc.WorkerStreamChunk(
                    rid=req.rid, token_ids=ids[i:i + self.chunk],
                    finished=last, finish_reason="length" if last else None,
                    prompt_tokens=len(req.input_ids),
                    output_tokens=min(i + self.chunk, len(ids)))

        async def abort(self, rid):
            return True

        async def health(self):
            return True

    return Scripted()


class Pair:
    """The reference's and the port's gateway on one private loop, each
    over a scripted worker for ``model``."""

    def __init__(self, model: str, **router_kw):
        from smg_tpu.gateway.router import RouterConfig as JaxRouterConfig
        from smg_tpu_torch.gateway.router import RouterConfig

        self.loop = asyncio.new_event_loop()
        self.workers, self.clients = [], []
        for server, wc, worker_cls, rc in ((jserver, jwc, JaxWorker, JaxRouterConfig),
                                           (tserver, twc, Worker, RouterConfig)):
            ctx = server.AppContext(policy="round_robin", router_config=rc(**router_kw))
            ctx.tokenizers.register(model, CharTokenizer(), default=True)
            w = scripted_worker(wc)
            ctx.registry.add(worker_cls(worker_id="w0", client=w, model_id=model))
            self.workers.append(w)
            self.clients.append(self.loop.run_until_complete(self._start(server, ctx)))

    @staticmethod
    async def _start(server, ctx):
        tc = TestClient(TestServer(server.build_app(ctx)))
        await tc.start_server()
        return tc

    def post(self, script: str, body: dict) -> list:
        out = []
        for w, tc in zip(self.workers, self.clients):
            w.script = script
            resp = self.loop.run_until_complete(tc.post("/v1/chat/completions", json=body))
            out.append((resp.status, self.loop.run_until_complete(resp.text())))
        return out

    def close(self):
        for tc in self.clients:
            self.loop.run_until_complete(tc.close())
        self.loop.close()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _body(status_text, stream: bool):
    status, text = status_text
    if not stream:
        return status, _strip(json.loads(text))
    frames = [b[len("data: "):] for b in text.split("\n\n") if b.startswith("data: ")]
    return status, [f if f == "[DONE]" else _strip(json.loads(f)) for f in frames]


TOOL_SCRIPT = ('Let me look. <tool_call>\n{"name": "get_weather", "arguments": '
               '{"city": "Paris", "unit": "c"}}\n</tool_call>')
THINK_SCRIPT = "<think>the user wants a number</think>It is 4."
HARMONY_SCRIPT = (
    "<|channel|>analysis<|message|>need the weather<|end|>"
    "<|start|>assistant<|channel|>commentary to=functions.get_weather "
    '<|constrain|>json<|message|>{"city": "Paris"}<|call|>'
    "TEXT PAST THE CALL STOP")
HARMONY_FINAL = ("<|channel|>analysis<|message|>thinking...<|end|>"
                 "<|start|>assistant<|channel|>final<|message|>Hello there!<|return|>tail")


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
@pytest.mark.parametrize("case", ["tools", "tools_no_call", "reasoning", "reasoning_off",
                                  "tools_and_reasoning", "harmony_tool", "harmony_final"])
def test_chat_through_both_gateways(case, stream):
    model, script, kw, body = "qwen3-8b", TOOL_SCRIPT, {}, {}
    if case == "tools":
        body = {"tools": [WEATHER_TOOL]}
    elif case == "tools_no_call":
        script, body = "just prose, no call", {"tools": [WEATHER_TOOL]}
    elif case == "reasoning":
        script = THINK_SCRIPT
    elif case == "reasoning_off":
        script, body = THINK_SCRIPT, {"separate_reasoning": False}
    elif case == "tools_and_reasoning":
        script = "<think>call the tool</think>" + TOOL_SCRIPT
        body, kw = {"tools": [WEATHER_TOOL]}, {"reasoning_parser": "qwen3",
                                              "tool_parser": "qwen"}
        model = "llama3-8b"
    elif case == "harmony_tool":
        model, script, body = "gpt-oss-20b", HARMONY_SCRIPT, {"tools": [WEATHER_TOOL]}
    else:
        model, script = "gpt-oss-20b", HARMONY_FINAL
    pair = Pair(model, **kw)
    try:
        req = {"model": model, "messages": [{"role": "system", "content": "Be terse."},
                                            {"role": "user", "content": "weather in Paris?"}],
               "max_tokens": 64, "stream": stream, **body}
        if stream:
            req["stream_options"] = {"include_usage": True}
        want, got = (_body(r, stream) for r in pair.post(script, req))
        assert got == want
        assert got[0] == 200
        # the same prompt ids, stops and special-token handling reached
        # both workers
        assert pair.workers[1].seen == pair.workers[0].seen
    finally:
        pair.close()
    text = json.dumps(got[1])
    if case in ("tools", "tools_and_reasoning", "harmony_tool"):
        assert '"tool_calls"' in text and "get_weather" in text
    if case in ("reasoning", "tools_and_reasoning", "harmony_final"):
        assert "reasoning_content" in text
