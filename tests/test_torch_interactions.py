"""The Interactions and audio transcription APIs on the port against the
reference, on the CPU.

- ``protocols/interactions.py`` and ``protocols/transcription.py``: the
  request models' validation, ``InteractionsRequest.to_messages`` over
  seeded inputs (string and content-list input, a system instruction, prior
  turns with and without their system message), ``interaction_metadata``,
  ``text_output`` and ``output_text`` equal the reference's.
- ``/v1/interactions`` through both apps (``test_torch_messages.Pair``: a
  tiny JAX ``Engine`` behind the reference's app, a tiny port ``Engine``
  with the same weights behind the port's) at temperature 0: a stored turn,
  a turn chained by ``previous_interaction_id``, a streamed turn, get and
  delete, the 404s (an unknown previous id, a deleted or unstored
  interaction, a ``/v1/responses`` object) and the 400s; bodies and
  ``content_delta``/``interaction_complete`` frames identical once ids and
  times are canonicalised, each turn's text the direct chat's on the same
  messages.
- ``/v1/audio/transcriptions`` through both apps to one fake ASR worker
  registered on each: the multipart form forwarded (two
  ``timestamp_granularities[]`` parts stay two), the ``json`` and ``text``
  formats, the 501 without an audio worker, the 400s and the worker's
  error; bodies and what the worker received equal.

The reference's six cases (``tests/test_transcription_interactions.py``)
are among these, each run on both apps.
"""

import json

import aiohttp
import numpy as np
import pytest

from smg_tpu.gateway.http_worker import HttpWorkerClient as JaxHttpWorker
from smg_tpu.protocols import interactions as jint
from smg_tpu.protocols import transcription as jtr
from smg_tpu_torch.gateway.http_worker import HttpWorkerClient
from smg_tpu_torch.protocols import interactions as tint
from smg_tpu_torch.protocols import transcription as ttr
from test_torch_gateway import MODEL
from test_torch_messages import SIDES, Pair
from test_torch_realtime import TRANSCRIPT, AsrServer, _canon

ASR_MODEL = "whisper-x"


# ---- the protocol modules ----

def _random_interaction(rng) -> dict:
    def content():
        r = rng.random()
        if r < 0.3:
            return {"role": rng.choice(["user", "model"]), "parts": f"w{rng.integers(99)}"}
        parts = [{"type": "text", "text": f"w{rng.integers(99)}"} if rng.random() < 0.7
                 else f"x{rng.integers(9)}" for _ in range(int(rng.integers(0, 4)))]
        key = "parts" if r < 0.7 else "content"
        return {"role": "user", key: parts} if rng.random() < 0.8 else {key: parts}

    body = {"input": (f"w{rng.integers(99)}" if rng.random() < 0.4
                      else [content() for _ in range(int(rng.integers(1, 4)))])}
    body["model" if rng.random() < 0.7 else "agent"] = "m"
    if rng.random() < 0.5:
        body["system_instruction"] = "w3"
    if rng.random() < 0.5:
        body["generation_config"] = {"temperature": 0.5, "max_output_tokens": 7,
                                     "stop_sequences": ["S"]}
    return body


@pytest.mark.parametrize("seed", range(6))
def test_interactions_protocol_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    body = _random_interaction(rng)
    prior = [[], [{"role": "user", "content": "w1"}, {"role": "assistant", "content": "w2"}],
             [{"role": "system", "content": "w0"}, {"role": "user", "content": "w1"}]][seed % 3]
    want_req = jint.InteractionsRequest.model_validate(body)
    got_req = tint.InteractionsRequest.model_validate(body)
    assert got_req.model_dump() == want_req.model_dump()
    want, got = want_req.to_messages(prior), got_req.to_messages(prior)
    assert got == want
    assert tint.interaction_metadata(got_req, got, "w9") == jint.interaction_metadata(
        want_req, want, "w9")
    outs = [tint.text_output("w9 "), tint.text_output("w8")]
    assert outs == [jint.text_output("w9 "), jint.text_output("w8")]
    assert tint.output_text(outs) == jint.output_text(outs) == "w9 w8"
    got_i = tint.Interaction(id="i", usage=tint.InteractionsUsage(total_tokens=3), outputs=outs)
    want_i = jint.Interaction(id="i", usage=jint.InteractionsUsage(total_tokens=3), outputs=outs)
    assert got_i.model_dump() == want_i.model_dump()
    assert tint.Interaction.new_id().startswith("interaction_")


@pytest.mark.parametrize("body", [{"input": "w5"}, {"model": "", "agent": None, "input": "w5"},
                                  {"model": "m"}, {"model": "m", "input": 5}],
                         ids=["no_model", "empty_model", "no_input", "bad_input"])
def test_invalid_interactions_requests_are_refused_as_the_reference(body):
    errors = []
    for mod in (jint, tint):
        with pytest.raises(Exception) as e:
            mod.InteractionsRequest.model_validate(body)
        errors.append([(x["type"], x["loc"], x["msg"]) for x in e.value.errors()])
    assert errors[1] == errors[0]


def test_transcription_protocol_is_the_reference():
    body = {"model": ASR_MODEL, "language": "en", "temperature": "0.2",
            "timestamp_granularities": ["word", "segment"]}
    assert ttr.TranscriptionRequest.model_validate(body).model_dump() == \
        jtr.TranscriptionRequest.model_validate(body).model_dump()
    assert ttr.TranscriptionResponse(text="t").model_dump() == \
        jtr.TranscriptionResponse(text="t").model_dump()


# ---- both apps ----

@pytest.fixture(scope="module")
def pair():
    """``test_torch_messages.Pair`` with one fake ASR worker registered on
    each app as a proxy worker for ``ASR_MODEL``."""
    p = Pair()
    asr = AsrServer()
    p.run(asr.server.start_server())
    for side, ctx, client in zip(SIDES, p.ctxs, (JaxHttpWorker, HttpWorkerClient)):
        ctx.registry.add(side["Worker"](worker_id="asr0", client=client(asr.url),
                                        model_id=ASR_MODEL))
    p.asr = asr
    yield p
    p.run(asr.server.close())
    p.close()


def _both(pair, method: str, path: str, body=None, form=None) -> list:
    """The request on each app: (status, content type, canonical body) each;
    ``form`` a list of multipart (name, value) parts, the audio last."""
    async def one(tc):
        data = None
        if form is not None:
            data = aiohttp.FormData()
            for name, value in form:
                if isinstance(value, bytes):
                    data.add_field(name, value, filename="a.wav", content_type="audio/wav")
                else:
                    data.add_field(name, value)
        r = await tc.request(method, path, json=body, data=data)
        text = await r.text()
        if r.content_type == "application/json":
            text = json.loads(text)
        elif r.content_type == "text/event-stream":
            text = [f[6:] if f[6:] == "[DONE]" else json.loads(f[6:])
                    for f in text.strip().split("\n\n")]
        return r.status, r.content_type, text

    got = [pair.run(one(tc)) for tc in pair.clients]
    assert _canon(got[1], {}) == _canon(got[0], {}), (path, body)
    return got


def _chat(pair, messages: list, max_tokens: int) -> str:
    want = None
    for st, _ctype, body in _both(pair, "POST", "/v1/chat/completions", {
            "model": MODEL, "messages": messages, "temperature": 0, "max_tokens": max_tokens}):
        assert st == 200
        want = body["choices"][0]["message"]["content"]
    return want


def _gen(n: int) -> dict:
    return {"temperature": 0, "max_output_tokens": n}


def test_interactions_roundtrip_and_chaining(pair):
    """The reference's roundtrip and streaming cases on both apps: a stored
    turn, a chained turn, a streamed chained turn, get, delete and the 404s;
    every id an app made is used on that app."""
    results = [pair.run(_interaction_script(tc)) for tc in pair.clients]
    assert _canon(results[1], {}) == _canon(results[0], {})
    out = results[1]
    b1, b2, stream, got, deleted, gone, again, unknown, resp_get, resp_del, unstored = out
    msgs1 = [{"role": "system", "content": "w9"}, {"role": "user", "content": "w5 w6"}]
    text1 = tint.output_text(b1[2]["outputs"])
    assert b1[0] == 200 and text1 == _chat(pair, msgs1, 5)
    assert b1[2]["usage"]["total_output_tokens"] == 5
    msgs2 = msgs1 + [{"role": "assistant", "content": text1}, {"role": "user", "content": "w7"}]
    text2 = tint.output_text(b2[2]["outputs"])
    assert b2[0] == 200 and text2 == _chat(pair, msgs2, 4)
    assert b2[2]["previous_interaction_id"] == b1[2]["id"]
    assert b2[2]["usage"]["total_input_tokens"] > b1[2]["usage"]["total_input_tokens"]
    # the streamed turn chains to the second: its deltas join to the text
    # of the same turn unstreamed (the direct chat on the same messages)
    st, ctype, frames = stream
    deltas = [f["delta"]["text"] for f in frames[:-1] if f["type"] == "content_delta"]
    final = [f for f in frames[:-1] if f["type"] == "interaction_complete"]
    msgs3 = msgs2 + [{"role": "assistant", "content": text2}, {"role": "user", "content": "w8"}]
    assert (st, ctype, frames[-1]) == (200, "text/event-stream", "[DONE]")
    assert "".join(deltas) == tint.output_text(final[0]["interaction"]["outputs"]) == \
        _chat(pair, msgs3, 4)
    assert final[0]["interaction"]["usage"]["total_output_tokens"] == 4
    assert got[0] == 200 and got[2]["id"] == b1[2]["id"] and got[2]["outputs"] == b1[2]["outputs"]
    assert got[2]["usage"] == b1[2]["usage"] and "created" not in got[2]
    assert deleted[:2] == (200, "application/json") and deleted[2] == {"deleted": b1[2]["id"]}
    assert gone[0] == again[0] == unknown[0] == resp_get[0] == resp_del[0] == unstored[0] == 404


async def _interaction_script(tc) -> list:
    async def call(method, path, body=None):
        r = await tc.request(method, path, json=body)
        if r.content_type == "text/event-stream":
            raw = await r.text()
            return r.status, r.content_type, [
                f[6:] if f[6:] == "[DONE]" else json.loads(f[6:])
                for f in raw.strip().split("\n\n")]
        return r.status, r.content_type, await r.json()

    b1 = await call("POST", "/v1/interactions", {
        "model": MODEL, "input": "w5 w6", "system_instruction": "w9",
        "generation_config": _gen(5)})
    b2 = await call("POST", "/v1/interactions", {
        "model": MODEL, "input": [{"role": "user", "parts": [{"type": "text", "text": "w7"}]}],
        "previous_interaction_id": b1[2]["id"], "system_instruction": "w9",
        "generation_config": _gen(4)})
    stream = await call("POST", "/v1/interactions", {
        "model": MODEL, "input": "w8", "previous_interaction_id": b2[2]["id"], "stream": True,
        "generation_config": _gen(4)})
    got = await call("GET", f"/v1/interactions/{b1[2]['id']}")
    deleted = await call("DELETE", f"/v1/interactions/{b1[2]['id']}")
    gone = await call("GET", f"/v1/interactions/{b1[2]['id']}")
    again = await call("DELETE", f"/v1/interactions/{b1[2]['id']}")
    unknown = await call("POST", "/v1/interactions", {
        "model": MODEL, "input": "w5", "previous_interaction_id": "interaction_nosuch"})
    # a Responses-API object is not an interaction, for get and delete alike
    resp = await call("POST", "/v1/responses", {"model": MODEL, "input": "w5",
                                                "max_output_tokens": 2, "temperature": 0})
    resp_get = await call("GET", f"/v1/interactions/{resp[2]['id']}")
    resp_del = await call("DELETE", f"/v1/interactions/{resp[2]['id']}")
    assert (await call("GET", f"/v1/responses/{resp[2]['id']}"))[0] == 200
    unstored = await call("POST", "/v1/interactions", {
        "model": MODEL, "input": "w5", "store": False, "generation_config": _gen(2)})
    unstored = await call("GET", f"/v1/interactions/{unstored[2]['id']}")
    return [b1, b2, stream, got, deleted, gone, again, unknown, resp_get, resp_del, unstored]


@pytest.mark.parametrize("body", [{"input": "w5"}, {"model": MODEL}, "not json"],
                         ids=["no_model_or_agent", "no_input", "not_json"])
def test_interactions_validation(pair, body):
    if isinstance(body, str):
        async def raw(tc):
            r = await tc.post("/v1/interactions", data=body)
            return r.status, (await r.json())["error"]["type"]

        got = [pair.run(raw(tc)) for tc in pair.clients]
        assert got[1] == got[0] == (400, "invalid_request_error")
        return
    got = _both(pair, "POST", "/v1/interactions", body)
    assert got[1][0] == 400 and got[1][2]["error"]["message"].startswith("invalid request")


# ---- transcriptions ----

TRANSCRIBE = {
    # the reference's two cases, then the granularities, a verbose format
    "json": ([("model", ASR_MODEL), ("language", "en")], 200),
    "text": ([("model", ASR_MODEL), ("response_format", "text")], 200),
    "granularities": ([("model", ASR_MODEL), ("response_format", "verbose_json"),
                       ("timestamp_granularities[]", "word"),
                       ("timestamp_granularities[]", "segment")], 200),
    # the reference's 501, then the 400s and the worker's own failure
    "no_audio_worker": ([("model", MODEL)], 501),
    "no_file": ([("model", ASR_MODEL)], 400),
    "worker_error": ([("model", ASR_MODEL), ("language", "fail")], 502),
}


@pytest.mark.parametrize("case", sorted(TRANSCRIBE))
def test_transcriptions_are_the_reference(pair, case):
    fields, status = TRANSCRIBE[case]
    audio = np.random.default_rng(3).bytes(3200)
    form = fields + ([] if case == "no_file" else [("file", audio)])
    n_before = len(pair.asr.forms)
    got = _both(pair, "POST", "/v1/audio/transcriptions", form=form)
    st, ctype, body = got[1]
    assert st == status, body
    sent = pair.asr.forms[n_before:]
    if status != 200:
        assert len(sent) == 2 * (status == 502)
        assert body["error"]["type"] == {501: "not_implemented", 400: "invalid_request_error",
                                         502: "worker_error"}[status]
        return
    assert sent[1] == sent[0] and sent[1][1] == audio
    want_fields = {"filename": "a.wav"}
    for name, value in fields:
        want_fields.setdefault(name, []).append(value)
    assert sent[1][0] == want_fields
    if case == "text":
        assert (ctype, body) == ("text/plain", TRANSCRIPT)
    else:
        assert ctype == "application/json" and body["text"] == TRANSCRIPT
        assert body["language"] == ("en" if case == "json" else None)


def test_transcription_needs_multipart(pair):
    got = _both(pair, "POST", "/v1/audio/transcriptions", {"model": ASR_MODEL})
    assert got[1][0] == 400 and "multipart" in got[1][2]["error"]["message"]
