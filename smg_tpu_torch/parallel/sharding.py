"""Sharding of the Llama-family weights over a rank mesh — the
reference's ``ShardingRules`` table (``smg_tpu/parallel/sharding.py``) and
its serving pipeline's layer split (``smg_tpu/parallel/pp_serving.py``) as
plain torch slicing.

The reference maps logical axes to mesh axes and lets GSPMD place the
pieces: ``q_heads``, ``kv_heads``, ``ffn`` and ``vocab`` shard over ``tp``
(an axis that ``tp`` does not divide is replicated, ``_divisible_axes``),
``experts`` over ``ep``, the layer stack over ``pp`` and ``seq`` over
``sp``.  Here each rank process holds its own slice (``RankPlace``: where
the rank sits on the grid), and the model adds the collectives
(``models/llama.py``, Megatron-style):

- tp: ``wq``, ``wk``, ``wv`` and ``w_gate``/``w_up`` by columns (the rank's
  query heads, KV heads and FFN columns), ``wo`` and ``w_down`` by rows,
  whose partial products the model sums with an all-reduce; ``embed`` by
  vocab rows (a masked lookup, then an all-reduce) and ``lm_head`` by vocab
  columns (the logits all-gathered); norms replicated;
- pp: stage s of S holds layers ``[s*L/S, (s+1)*L/S)`` of every stacked
  weight, the embedding on the first stage (on the last too when
  ``lm_head`` is tied to it) and ``final_norm``/``lm_head`` on the last;
- ep: rank r of ep holds experts ``[r*X/ep, (r+1)*X/ep)`` of
  ``w_gate``/``w_up``/``w_down`` and the whole router;
- sp: everything, as the reference replicates over ``sp``.

KV heads: when ``tp`` divides ``num_kv_heads`` each rank keeps
``num_kv_heads / tp`` of them; otherwise, when ``tp`` is a multiple of
``num_kv_heads``, rank r keeps the one KV head its query heads group onto,
``r * num_kv_heads // tp``, so ranks replicate KV heads (the reference's
fallback for 2 KV heads at tp=4).  The vocab is replicated when ``tp`` does
not divide it.

Weights keep the port's folded layout (``wq [L, E, H*D]``, ...), and every
tp slice here acts on the last two axes, so it serves a stacked ``[L, ...]``
tensor and one layer's ``[...]`` alike: ``init_params(..., shard=)`` draws
each layer whole and keeps the rank's slice (``Sharder``), so a rank engine
and a single-device one hold the same model from the same seed."""

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


def rank_config(cfg: ModelConfig, tp: int, pp: int = 1, ep: int = 1) -> ModelConfig:
    """The model config one rank computes with: its query heads, KV heads
    and FFN width under ``tp`` (the vocabulary stays whole: logits are
    gathered), its stage's ``L / pp`` layers and its ``X / ep`` experts."""
    if tp > 1:
        plan = shard_plan(cfg, tp, 0)
        cfg = dataclasses.replace(
            cfg, num_heads=plan.heads[1] - plan.heads[0],
            num_kv_heads=plan.kv_heads[1] - plan.kv_heads[0],
            intermediate_size=plan.ffn[1] - plan.ffn[0])
    return dataclasses.replace(cfg, num_layers=cfg.num_layers // pp,
                               num_experts=cfg.num_experts // ep)


@dataclass(frozen=True)
class RankPlace:
    """Where one rank sits on the grid: its index along tp, pp (its stage)
    and ep, and those axes' sizes (sp and dp hold no slice of their own)."""

    tp: int = 1
    tp_rank: int = 0
    pp: int = 1
    stage: int = 0
    ep: int = 1
    ep_rank: int = 0

    @classmethod
    def of(cls, sizes: dict, coords: dict) -> "RankPlace":
        """From a grid's axis sizes and a rank's coordinates on it
        (``parallel/group.py``)."""
        return cls(tp=sizes.get("tp", 1), tp_rank=coords.get("tp", 0),
                   pp=sizes.get("pp", 1), stage=coords.get("pp", 0),
                   ep=sizes.get("ep", 1), ep_rank=coords.get("ep", 0))

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    def layers(self, cfg: ModelConfig) -> tuple[int, int]:
        """The stage's layers, half-open."""
        n = cfg.num_layers // self.pp
        return self.stage * n, self.stage * n + n

    def experts(self, cfg: ModelConfig) -> tuple[int, int]:
        """The rank's experts, half-open."""
        n = cfg.num_experts // self.ep
        return self.ep_rank * n, self.ep_rank * n + n

    def holds(self, cfg: ModelConfig, name: str) -> bool:
        """Does the rank hold top-level weight ``name`` (``embed``,
        ``final_norm``, ``lm_head``)?"""
        if name == "embed":
            return self.first or (self.last and cfg.tie_word_embeddings)
        return self.last


def check_mesh(cfg: ModelConfig, place: RankPlace) -> None:
    """Raise ValueError when ``cfg`` cannot be split as ``place``'s grid
    says: tp as ``check_tp``; pp must divide the layers; ep needs an expert
    layer and must divide its experts."""
    if place.tp > 1:
        check_tp(cfg, place.tp)
    if cfg.num_layers % place.pp:
        raise ValueError(f"pp={place.pp} does not divide num_layers={cfg.num_layers}")
    if place.ep > 1 and not cfg.num_experts:
        raise ValueError(f"ep={place.ep} on a dense (non-MoE) model")
    if place.ep > 1 and cfg.num_experts % place.ep:
        raise ValueError(f"ep={place.ep} does not divide num_experts={cfg.num_experts}")


def tp_range(name: str, plan: ShardPlan, head_dim: int) -> tuple[int, int, int] | None:
    """Where rank ``plan.rank``'s tp slice of weight ``name`` lies: (the
    axis counted from the end, -1 or -2, and its half-open range), or None
    when tp replicates the weight."""
    D = head_dim
    if name == "wq":
        return -1, plan.heads[0] * D, plan.heads[1] * D
    if name in ("wk", "wv"):
        return -1, plan.kv_heads[0] * D, plan.kv_heads[1] * D
    if name == "wo":
        return -2, plan.heads[0] * D, plan.heads[1] * D
    if name in ("w_gate", "w_up"):
        return -1, *plan.ffn
    if name == "w_down":
        return -2, *plan.ffn
    if name == "embed" and plan.vocab is not None:
        return -2, *plan.vocab
    if name == "lm_head" and plan.vocab is not None:
        return -1, *plan.vocab
    return None


def shard_tensor(name: str, t: torch.Tensor, plan: ShardPlan, head_dim: int) -> torch.Tensor:
    """Rank ``plan.rank``'s slice of weight ``name`` (a stacked ``[L, ...]``
    tensor or one layer of it, or ``embed``/``lm_head``), as a tensor of its
    own (the whole one can be freed).  Replicated weights come back as they
    are."""
    r = tp_range(name, plan, head_dim)
    if r is None:
        return t
    dim, a, b = r
    return t.narrow(dim, a, b - a).clone(memory_format=torch.contiguous_format)


#: the stacked weights whose second axis is the expert axis
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
#: the weights outside the layer stack
_TOP_KEYS = ("embed", "lm_head", "final_norm")


def shard_params(params: dict, cfg: ModelConfig, tp: int = 1, rank: int = 0,
                 place: RankPlace | None = None) -> tuple[ModelConfig, dict]:
    """``(rank_cfg, rank_params)``: a rank's slices of the port's parameter
    dict (``models/llama.py::init_params`` layout) and the config its model
    computes with.  ``place`` gives the rank's spot on the grid; without it,
    rank ``rank`` of ``tp``.  Every slice is a tensor of its own (the whole
    can be freed)."""
    place = place or RankPlace(tp=tp, tp_rank=rank)
    check_mesh(cfg, place)
    if cfg.num_experts and place.tp > 1:
        raise NotImplementedError("the expert layer under tp > 1 is ROADMAP.md Queue A item 9i")
    cut = Sharder(cfg, place)
    out = {k: cut.piece(k, v) for k, v in params.items()
           if k != "layers" and place.holds(cfg, k)}
    out["layers"] = {k: cut.piece(k, v) for k, v in params["layers"].items()}
    return rank_config(cfg, place.tp, place.pp, place.ep), out


class Sharder:
    """A rank's cut of the weights (``RankPlace``), for ``init_params``'s
    ``shard`` and ``shard_params``: ``keep(name, depth, n)`` is the range
    the rank keeps of a stacked weight's leading axis ``depth`` (layers at
    0, experts at 1) of length ``n``; ``holds(name)`` whether it keeps a
    top-level weight at all; calling it on one drawn ``[...]`` piece (a
    layer's, an expert's, or ``embed``/``lm_head``) gives the rank's tp
    slice."""

    def __init__(self, cfg: ModelConfig, place: RankPlace):
        self.cfg = cfg
        self.place = place
        self.plan = shard_plan(cfg, place.tp, place.tp_rank) if place.tp > 1 else None

    def holds(self, name: str) -> bool:
        return self.place.holds(self.cfg, name)

    def keep(self, name: str, depth: int, n: int) -> tuple[int, int]:
        if name in _TOP_KEYS:
            return 0, n
        if depth == 0:
            return self.place.layers(self.cfg)
        if depth == 1 and self.cfg.num_experts and name in _EXPERT_KEYS:
            return self.place.experts(self.cfg)
        return 0, n

    def __call__(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if self.plan is None:
            return t
        return shard_tensor(name, t, self.plan, self.cfg.head_dim)

    def region(self, name: str, shape: tuple) -> tuple[slice, ...]:
        """Where the rank's slice of a whole weight ``name`` of ``shape``
        (stacked or top-level) lies in it: a slice for each axis."""
        idx = [slice(None)] * len(shape)
        if name not in _TOP_KEYS:
            for depth in range(2 if self.cfg.num_experts and name in _EXPERT_KEYS else 1):
                idx[depth] = slice(*self.keep(name, depth, shape[depth]))
        r = None if self.plan is None else tp_range(name, self.plan, self.cfg.head_dim)
        if r is not None:
            idx[len(shape) + r[0]] = slice(r[1], r[2])
        return tuple(idx)

    def piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a whole weight (stacked or top-level)."""
        part = t[self.region(name, t.shape)]
        if part.shape == t.shape:
            return t  # whole
        return part.clone(memory_format=torch.contiguous_format)


# ---- the training mesh (``train/step.py``) ----

#: the reference's default ``ShardingRules`` table
#: (``smg_tpu/parallel/sharding.py``), copied by value: the one table the
#: port's ``Sharder`` lays out, with ``layers -> pp`` added under pp as the
#: reference's ``make_train_step`` adds it
DEFAULT_RULES = {
    "vocab": "tp", "embed": None, "q_heads": "tp", "kv_heads": "tp", "kv_lanes": "tp",
    "head_dim": None, "ffn": "tp", "experts": "ep", "layers": None,
    "batch": "dp", "seq": "sp", "pages": None, "act_embed": None, "act_heads": "tp",
}
#: the norm weights: replicated over tp, after which the model places its
#: ``copy_to`` (``models/llama.py::_fan_out``), so each tp rank's gradient of
#: them is whole, except q_norm/k_norm, applied to the rank's own heads
_NORM_KEYS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm", "final_norm")
_HEAD_NORM_KEYS = ("q_norm", "k_norm")


@dataclass(frozen=True)
class LeafRule:
    """How one weight (and its two moments) lies on the training grid, the
    counterpart of the reference's ``_infer_opt_shardings``, which places
    the moments like their params: ``replicated`` are the axes along which
    ranks hold the same piece, ``summed`` those of them whose ranks each
    compute a part of its gradient (the batch over dp, the sequence over sp,
    a replicated weight whose use the axis splits), summed after the
    backward.  Along tp a piece may be held by groups of ``tp_share`` ranks
    (1: split, tp: replicated; KV heads fewer than tp are held by
    ``tp / num_kv_heads`` ranks each)."""

    replicated: tuple[str, ...]
    summed: tuple[str, ...]
    tp_share: int = 1

    def owner(self, coords: dict) -> bool:
        """Does the rank at ``coords`` count this piece (in a norm) for every
        rank that holds it?"""
        return all((coords.get(a, 0) % self.tp_share if a == "tp" else coords.get(a, 0)) == 0
                   for a in self.replicated)


def train_rules(cfg: ModelConfig, sizes: dict) -> dict[str, LeafRule]:
    """The ``LeafRule`` of every weight of ``cfg`` on a grid of ``sizes``,
    by name (``embed``, ``final_norm``, ``lm_head``, ``layers.<key>``)."""
    tp, pp, ep = (sizes.get(a, 1) for a in ("tp", "pp", "ep"))
    every = tuple(a for a in ("dp", "sp") if sizes.get(a, 1) > 1)
    names = ["embed", "final_norm"] + ([] if cfg.tie_word_embeddings else ["lm_head"])
    layer = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down"]
    if cfg.post_norms:
        layer += ["post_attn_norm", "post_mlp_norm"]
    if cfg.qk_norm:
        layer += list(_HEAD_NORM_KEYS)
    if cfg.num_experts:
        layer.append("router")
    names += [f"layers.{k}" for k in layer]
    out = {}
    for name in names:
        key = name.removeprefix("layers.")
        rep, summed, share = list(every), list(every), 1
        if ep > 1 and not (cfg.num_experts and key in _EXPERT_KEYS):
            rep.append("ep")
            if key == "router":  # each ep rank's gates weigh only its experts
                summed.append("ep")
        if tp > 1:
            vocab_whole = cfg.vocab_size % tp != 0
            if key in _NORM_KEYS or key in _HEAD_NORM_KEYS or (
                    key in ("embed", "lm_head") and vocab_whole):
                share = tp
            elif key in ("wk", "wv") and cfg.num_kv_heads % tp:
                share = tp // cfg.num_kv_heads  # a KV head for each group of ranks
            if share > 1:
                rep.append("tp")
            if key in _HEAD_NORM_KEYS or (key in ("wk", "wv") and share > 1):
                summed.append("tp")  # each rank's heads use a part of it
        if pp > 1 and key == "embed" and cfg.tie_word_embeddings:
            rep.append("pp")  # on the first stage and the last
            summed.append("pp")
        out[name] = LeafRule(tuple(rep), tuple(summed), share)
    return out
