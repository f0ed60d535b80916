"""Tensor-parallel sharding of the Llama-family weights — the reference's
``ShardingRules`` table (``smg_tpu/parallel/sharding.py``) as plain torch
slicing.

The reference maps logical axes to the ``tp`` mesh axis and lets GSPMD
place the pieces: ``q_heads``, ``kv_heads``, ``ffn`` and ``vocab`` shard
over ``tp``; an axis that ``tp`` does not divide is replicated
(``_divisible_axes``).  Here each rank process holds its own slice, and the
model adds the collectives (``models/llama.py``, Megatron-style):

- ``wq``, ``wk``, ``wv`` and ``w_gate``/``w_up`` by columns (the rank's
  query heads, KV heads and FFN columns), ``wo`` and ``w_down`` by rows,
  whose partial products the model sums with an all-reduce;
- ``embed`` by vocab rows (a masked lookup, then an all-reduce) and
  ``lm_head`` by vocab columns (the logits all-gathered);
- norms replicated.

KV heads: when ``tp`` divides ``num_kv_heads`` each rank keeps
``num_kv_heads / tp`` of them; otherwise, when ``tp`` is a multiple of
``num_kv_heads``, rank r keeps the one KV head its query heads group onto,
``r * num_kv_heads // tp``, so ranks replicate KV heads (the reference's
fallback for 2 KV heads at tp=4).  The vocab is replicated when ``tp`` does
not divide it.

Weights keep the port's folded layout (``wq [L, E, H*D]``, ...), and every
slice here acts on the last two axes, so it serves a stacked ``[L, ...]``
tensor and one layer's ``[...]`` alike: ``init_params(..., shard=)`` draws
each layer whole and keeps the rank's slice, so a tp engine and a
single-device one hold the same model from the same seed."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from smg_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShardPlan:
    """What rank ``rank`` of ``tp`` keeps: half-open ranges of query heads,
    KV heads, FFN columns and vocab rows (``vocab`` None: replicated)."""

    tp: int
    rank: int
    heads: tuple[int, int]
    kv_heads: tuple[int, int]
    ffn: tuple[int, int]
    vocab: tuple[int, int] | None


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ValueError when ``cfg`` cannot be split over ``tp`` ranks: the
    query heads and the FFN must divide, and the KV heads must either divide
    or group whole onto ranks (``tp`` a multiple of ``num_kv_heads``)."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    if H % tp or cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide num_heads={H} and "
                         f"intermediate_size={cfg.intermediate_size}")
    if K % tp and tp % K:
        raise ValueError(f"tp={tp} neither divides num_kv_heads={K} nor is a "
                         f"multiple of it: a rank's query heads would span KV groups")


def shard_plan(cfg: ModelConfig, tp: int, rank: int) -> ShardPlan:
    check_tp(cfg, tp)
    H, K, F, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    h, f = H // tp, F // tp
    if K % tp == 0:
        k = K // tp
        kv = (rank * k, rank * k + k)
    else:  # tp a multiple of K: the rank's heads all group onto one KV head
        g = rank * K // tp
        kv = (g, g + 1)
    vocab = (rank * V // tp, (rank + 1) * V // tp) if V % tp == 0 else None
    return ShardPlan(tp, rank, (rank * h, rank * h + h), kv, (rank * f, rank * f + f), vocab)


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The model config one rank computes with: its query heads, KV heads
    and FFN width (the vocabulary stays whole: logits are gathered)."""
    plan = shard_plan(cfg, tp, 0)
    return dataclasses.replace(
        cfg, num_heads=plan.heads[1] - plan.heads[0],
        num_kv_heads=plan.kv_heads[1] - plan.kv_heads[0],
        intermediate_size=plan.ffn[1] - plan.ffn[0])


def _cols(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return t[..., a:b]


def _rows(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return t[..., a:b, :]


def shard_tensor(name: str, t: torch.Tensor, plan: ShardPlan, head_dim: int) -> torch.Tensor:
    """Rank ``plan.rank``'s slice of weight ``name`` (a stacked ``[L, ...]``
    tensor or one layer of it, or ``embed``/``lm_head``), as a tensor of its
    own (the whole one can be freed).  Replicated weights come back as they
    are."""
    D = head_dim
    if name == "wq":
        part = _cols(t, plan.heads[0] * D, plan.heads[1] * D)
    elif name in ("wk", "wv"):
        part = _cols(t, plan.kv_heads[0] * D, plan.kv_heads[1] * D)
    elif name == "wo":
        part = _rows(t, plan.heads[0] * D, plan.heads[1] * D)
    elif name in ("w_gate", "w_up"):
        part = _cols(t, *plan.ffn)
    elif name == "w_down":
        part = _rows(t, *plan.ffn)
    elif name == "embed" and plan.vocab is not None:
        part = _rows(t, *plan.vocab)
    elif name == "lm_head" and plan.vocab is not None:
        part = _cols(t, *plan.vocab)
    else:
        return t
    return part.clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, cfg: ModelConfig, tp: int, rank: int
                 ) -> tuple[ModelConfig, dict]:
    """``(rank_cfg, rank_params)``: rank ``rank``'s slices of the port's
    parameter dict (``models/llama.py::init_params`` layout) and the config
    its model computes with."""
    if cfg.num_experts:
        raise NotImplementedError("the expert layer under tp > 1 is ROADMAP.md Queue A item 9i")
    plan = shard_plan(cfg, tp, rank)
    out = {k: shard_tensor(k, v, plan, cfg.head_dim) for k, v in params.items()
           if k != "layers"}
    out["layers"] = {k: shard_tensor(k, v, plan, cfg.head_dim)
                     for k, v in params["layers"].items()}
    return rank_config(cfg, tp), out


def param_sharder(cfg: ModelConfig, tp: int, rank: int):
    """``shard`` callback of ``init_params``: weight name, one drawn layer
    (or ``embed``/``lm_head``) -> the rank's slice."""
    plan = shard_plan(cfg, tp, rank)
    return lambda name, t: shard_tensor(name, t, plan, cfg.head_dim)
