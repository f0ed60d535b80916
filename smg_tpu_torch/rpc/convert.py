"""Dataclass <-> proto conversions with explicit defaults on every field
(proto3 zero-value pitfall — see scheduler.proto header): the port's copy of
``smg_tpu/rpc/convert.py``, plus the KV payload's bytes on the wire.

A KV payload travels as its raw bytes, its shape and a dtype name, as the
reference sends a numpy array (``k.tobytes()``, ``str(k.dtype)``): bf16 is
``"bfloat16"`` in 2-byte words, the name and the bytes ``ml_dtypes`` gives
the reference, and comes back as a CPU tensor."""

from __future__ import annotations

import warnings

import torch

from smg_tpu_torch.protocols.events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    KvEventBatch,
)
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.rpc import scheduler_pb2 as pb

KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}


def kv_to_wire(t: torch.Tensor) -> tuple[bytes, list[int], str]:
    """(bytes, shape, dtype name) of a host KV payload."""
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name not in KV_DTYPES:
        raise ValueError(f"KV payload dtype {t.dtype} has no wire name")
    return t.view(torch.uint8).numpy().tobytes(), list(t.shape), name


def kv_from_wire(data: bytes, shape, dtype: str) -> torch.Tensor:
    """A CPU tensor over ``data`` (read-only bytes: the tensor is only read,
    by the import's copy into the cache)."""
    if dtype not in KV_DTYPES:
        raise ValueError(f"unknown KV dtype {dtype!r}; have {sorted(KV_DTYPES)}")
    shape = tuple(int(n) for n in shape)
    if not data:
        return torch.empty(shape, dtype=KV_DTYPES[dtype])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "buffer is not writable"
        flat = torch.frombuffer(data, dtype=torch.uint8)
    return flat.view(KV_DTYPES[dtype]).reshape(shape)


def sampling_to_proto(sp: SamplingParams) -> pb.SamplingParamsProto:
    msg = pb.SamplingParamsProto(
        max_new_tokens=sp.max_new_tokens,
        temperature=sp.temperature,
        top_p=sp.top_p,
        top_k=sp.top_k,
        min_p=sp.min_p,
        frequency_penalty=sp.frequency_penalty,
        presence_penalty=sp.presence_penalty,
        repetition_penalty=sp.repetition_penalty,
        stop_token_ids=sp.stop_token_ids,
        ignore_eos=sp.ignore_eos,
        n=sp.n,
        logprobs=sp.logprobs,
        top_logprobs=sp.top_logprobs,
        stop=sp.stop,
    )
    if sp.seed is not None:
        msg.seed = sp.seed
    if sp.json_schema is not None:
        msg.json_schema = sp.json_schema
    if sp.regex is not None:
        msg.regex = sp.regex
    if sp.ebnf is not None:
        msg.ebnf = sp.ebnf
    if sp.lora_adapter is not None:
        msg.lora_adapter = sp.lora_adapter
    return msg


def sampling_from_proto(msg: pb.SamplingParamsProto) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=msg.max_new_tokens,
        temperature=msg.temperature,
        top_p=msg.top_p,
        top_k=msg.top_k,
        min_p=msg.min_p,
        frequency_penalty=msg.frequency_penalty,
        presence_penalty=msg.presence_penalty,
        repetition_penalty=msg.repetition_penalty,
        stop_token_ids=list(msg.stop_token_ids),
        ignore_eos=msg.ignore_eos,
        seed=msg.seed if msg.HasField("seed") else None,
        n=msg.n or 1,
        logprobs=msg.logprobs,
        top_logprobs=msg.top_logprobs,
        stop=list(msg.stop),
        json_schema=msg.json_schema if msg.HasField("json_schema") else None,
        regex=msg.regex if msg.HasField("regex") else None,
        ebnf=msg.ebnf if msg.HasField("ebnf") else None,
        lora_adapter=msg.lora_adapter if msg.HasField("lora_adapter") else None,
    )


def mm_embeds_to_proto(mm: "tuple | None") -> pb.MmEmbedsProto | None:
    """(embeds [M, E] f32, positions [M][, grids]) -> MmEmbedsProto (None
    passes through).  Rows > 0 signals presence on the wire (proto3 has no
    has-field for messages constructed empty).  ``grids`` — optional
    per-image merged (gh, gw) — feed M-RoPE on the worker."""
    if mm is None:
        return None
    import numpy as np

    embeds, positions, *rest = mm
    grids = rest[0] if rest else None
    embeds = np.ascontiguousarray(np.asarray(embeds, np.float32))
    if embeds.ndim != 2:
        raise ValueError(f"mm embeds must be [rows, cols], got {embeds.shape}")
    msg = pb.MmEmbedsProto(
        embeds=embeds.tobytes(),
        rows=embeds.shape[0],
        cols=embeds.shape[1],
        positions=[int(p) for p in positions],
    )
    if grids:
        msg.grid_hs.extend(int(g[0]) for g in grids)
        msg.grid_ws.extend(int(g[1]) for g in grids)
    return msg


def mm_embeds_from_proto(msg: pb.MmEmbedsProto) -> "tuple | None":
    """MmEmbedsProto -> (embeds [M, E] f32, positions [M][, grids]) or None
    when the field was absent/empty (rows == 0)."""
    if msg is None or msg.rows == 0:
        return None
    import numpy as np

    embeds = np.frombuffer(msg.embeds, dtype=np.float32).reshape(
        msg.rows, msg.cols
    )
    positions = np.asarray(list(msg.positions), np.int64)
    if msg.grid_hs:
        grids = list(zip(msg.grid_hs, msg.grid_ws))
        return embeds, positions, grids
    return embeds, positions


def kv_batch_to_proto(batch: KvEventBatch) -> pb.KvEventBatchProto:
    msg = pb.KvEventBatchProto(
        sequence_number=batch.sequence_number, dp_rank=batch.dp_rank
    )
    for ev in batch.events:
        evp = msg.events.add()
        if isinstance(ev, BlockStored):
            evp.stored.block_hashes.extend(ev.block_hashes)
            evp.stored.token_ids.extend(ev.token_ids)
            evp.stored.block_size = ev.block_size
            if ev.parent_block_hash is not None:
                evp.stored.parent_block_hash = ev.parent_block_hash
        elif isinstance(ev, BlockRemoved):
            evp.removed.block_hashes.extend(ev.block_hashes)
        elif isinstance(ev, AllBlocksCleared):
            evp.all_cleared = True
    return msg


def kv_batch_from_proto(msg: pb.KvEventBatchProto) -> KvEventBatch:
    events = []
    for evp in msg.events:
        which = evp.WhichOneof("event")
        if which == "stored":
            events.append(
                BlockStored(
                    block_hashes=list(evp.stored.block_hashes),
                    token_ids=list(evp.stored.token_ids),
                    parent_block_hash=(
                        evp.stored.parent_block_hash
                        if evp.stored.HasField("parent_block_hash")
                        else None
                    ),
                    block_size=evp.stored.block_size,
                )
            )
        elif which == "removed":
            events.append(BlockRemoved(block_hashes=list(evp.removed.block_hashes)))
        elif which == "all_cleared":
            events.append(AllBlocksCleared())
    return KvEventBatch(
        sequence_number=msg.sequence_number, events=events, dp_rank=msg.dp_rank
    )
