"""Audio transcription protocol: OpenAI-compatible
``/v1/audio/transcriptions`` (reference: ``crates/protocols/src/
transcription.rs``).

The port's copy of ``smg_tpu/protocols/transcription.py``.  The wire format
is multipart/form-data: the model carries the text fields, the audio bytes
travel beside it."""

from __future__ import annotations

from pydantic import BaseModel


class TranscriptionRequest(BaseModel):
    model: str = ""
    language: str | None = None
    prompt: str | None = None
    response_format: str | None = None  # json | text | srt | verbose_json | vtt
    temperature: float | None = None
    timestamp_granularities: list[str] | None = None
    stream: bool | None = None


class TranscriptionResponse(BaseModel):
    text: str
    language: str | None = None
    duration: float | None = None
    segments: list[dict] | None = None
