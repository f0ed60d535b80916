"""Rerank + classify protocol types — the port's copy of
``smg_tpu/protocols/rerank.py``.

Reference: ``/v1/rerank`` (``model_gateway/src/server.rs:188-221``) and
``/v1/classify`` (``server.rs:287-300``) with their request/response types in
``crates/protocols``.  The in-tree engine serves both through its embedding
path: rerank scores query-document cosine similarity; classify is zero-shot
over caller-supplied labels (softmax over label-embedding similarities).
"""

from __future__ import annotations

import time
from typing import Any

from pydantic import BaseModel, ConfigDict, Field

from smg_tpu_torch.protocols.openai import UsageInfo, _gen_id


class RerankRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    model: str = ""
    query: str
    documents: list[str]
    top_n: int | None = None  # None = all documents
    return_documents: bool = True


class RerankResult(BaseModel):
    index: int  # position in the request's documents list
    relevance_score: float
    document: str | None = None


class RerankResponse(BaseModel):
    id: str = Field(default_factory=lambda: _gen_id("rerank"))
    object: str = "rerank"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    results: list[RerankResult] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class ClassifyRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    model: str = ""
    input: str | list[str]
    labels: list[str]


class ClassifyData(BaseModel):
    index: int
    label: str  # argmax label
    scores: dict[str, float]  # label -> probability (softmax over labels)


class ClassifyResponse(BaseModel):
    id: str = Field(default_factory=lambda: _gen_id("classify"))
    object: str = "classify"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    data: list[ClassifyData] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)
