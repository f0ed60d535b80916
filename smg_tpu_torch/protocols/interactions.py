"""Interactions API protocol (reference: ``crates/protocols/src/
interactions.rs``, the Gemini-style stateful interaction surface,
``server.rs:238-311``).

The port's copy of ``smg_tpu/protocols/interactions.py``: model or agent
selection, string or content-list input, a system instruction, the
generation config, ``store`` and ``previous_interaction_id`` chaining, and
what a stored interaction keeps (``interaction_metadata``)."""

from __future__ import annotations

import time
import uuid
from typing import Any

from pydantic import BaseModel, model_validator


class GenerationConfig(BaseModel):
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    max_output_tokens: int | None = None
    stop_sequences: list[str] | None = None


class InteractionsRequest(BaseModel):
    model: str | None = None
    agent: str | None = None
    input: str | list[dict]
    system_instruction: str | None = None
    tools: list[dict] | None = None
    stream: bool = False
    store: bool = True
    generation_config: GenerationConfig | None = None
    previous_interaction_id: str | None = None

    @model_validator(mode="after")
    def _model_or_agent(self):
        if not self.model and not self.agent:
            raise ValueError("one of 'model' or 'agent' is required")
        return self

    def to_messages(self, prior: list[dict] | None = None) -> list[dict]:
        """Normalize to internal chat messages (prior turns first).

        Chained turns: if the prior history already opens with a system
        message (persisted from the first turn), it stands — re-sending
        ``system_instruction`` must not accumulate duplicates."""
        messages: list[dict] = []
        prior = prior or []
        if self.system_instruction and not any(
            m.get("role") == "system" for m in prior
        ):
            messages.append({"role": "system", "content": self.system_instruction})
        messages.extend(prior)
        if isinstance(self.input, str):
            messages.append({"role": "user", "content": self.input})
        else:
            for content in self.input:
                role = content.get("role", "user")
                parts = content.get("parts") or content.get("content") or []
                if isinstance(parts, str):
                    messages.append({"role": role, "content": parts})
                    continue
                texts = [
                    p.get("text", "") if isinstance(p, dict) else str(p)
                    for p in parts
                ]
                messages.append({"role": role, "content": " ".join(t for t in texts if t)})
        return messages


class InteractionsUsage(BaseModel):
    total_input_tokens: int = 0
    total_output_tokens: int = 0
    total_tokens: int = 0


class Interaction(BaseModel):
    object: str = "interaction"
    id: str = ""
    model: str | None = None
    agent: str | None = None
    status: str = "completed"  # in_progress | completed | failed
    created: str | None = None
    role: str = "model"
    outputs: list[dict] = []
    usage: InteractionsUsage | None = None
    previous_interaction_id: str | None = None

    @staticmethod
    def new_id() -> str:
        return f"interaction_{uuid.uuid4().hex[:24]}"

    @staticmethod
    def now_iso() -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def text_output(text: str) -> dict:
    """Gemini-style content block."""
    return {"type": "message", "role": "model",
            "parts": [{"type": "text", "text": text}]}


def output_text(outputs: list[dict]) -> str:
    parts: list[str] = []
    for out in outputs or []:
        for p in out.get("parts", []):
            if isinstance(p, dict) and p.get("text"):
                parts.append(p["text"])
    return "".join(parts)


def interaction_metadata(req: InteractionsRequest, messages: list[dict],
                         text: str) -> dict[str, Any]:
    """What gets persisted for previous_interaction_id chaining."""
    return {
        "kind": "interaction",
        "messages": messages + [{"role": "assistant", "content": text}],
    }
