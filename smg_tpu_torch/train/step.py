"""The training step on one device (port of ``smg_tpu/train/step.py``).

``make_train_step(cfg)`` returns ``(init_fn, step_fn)``:

    init_fn(seed=0, params=None) -> TrainState
    step_fn(state, tokens[B,T], targets[B,T], loss_mask[B,T]) -> (state, metrics)

The step is the reference's: float32 logits from ``forward_train``, their
log-softmax, the NLL at the pre-shifted ``targets`` weighted by
``loss_mask`` and divided by ``max(mask.sum(), 1)``; the gradient by
autograd; ``metrics`` holds that ``loss`` and ``grad_norm``, the global L2
norm of the gradients (``optax.global_norm``), as 0-d float32 tensors on
the device (no host sync); the update is ``optax.adamw(learning_rate)``'s.

AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay
1e-4 on every leaf (optax's default; torch's is 1e-2), decoupled:
``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, the moments in the
parameters' dtype.  ``torch.optim.AdamW`` set up so computes it, fused (one
multi-tensor kernel per device and dtype, float32 arithmetic): the
reference runs its optimizer in XLA, with no Pallas kernel.

Parameters, moments and step keep the reference's tree (stacked ``[L, ...]``
layer weights), so a JAX ``TrainState`` carries across
(``models/convert.py::train_state_from_jax``).  The step works on one view
a layer of every stacked tensor: the model is built over those views as
leaves (``LlamaModel`` takes per-layer sequences), so a layer's gradient is
its own tensor (a select of the stack would backpropagate a zero-filled
copy of the whole stack for every layer), and the optimizer updates the
views, hence the stacks, in place.  A step consumes the state it is given
(the reference donates it) and returns the next one over the same tensors.

Float32 products run with TF32 off, as XLA's float32 does not round to
TF32.

With a ``mesh`` of more than one device the step is the reference's
sharded step (``train/leader.py`` starts a rank process a device; this
module holds the rank's body, ``RankTrainer``): each rank keeps its piece
of the params and of both moments (``parallel/sharding.py::Sharder``, the
reference's rules table and ``_infer_opt_shardings``), its dp rows of the
batch and its sp positions of them; ``forward_train`` runs its layers over
differentiable collectives (``parallel/autograd.py``), round the training
ring under sp and through the microbatch pipeline under pp
(``parallel/pipeline.py``).  The loss is the reference's global one: every
rank divides by the mask count of the whole batch.  After the backward the
gradients are summed over the axes each leaf's ``LeafRule`` names, the
``grad_norm`` counts every piece once, and each rank's fused AdamW updates
its own pieces.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from smg_tpu_torch.engine.runner import resolve_device
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.llama import LlamaModel, init_params
from smg_tpu_torch.parallel.autograd import TrainGroup
from smg_tpu_torch.parallel.group import AXIS_ORDER
from smg_tpu_torch.parallel.pipeline import (
    check_microbatches,
    check_stages,
    local_microbatches,
    pipeline_backward,
)
from smg_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    RankPlace,
    Sharder,
    check_mesh,
    rank_config,
    tp_range,
    train_rules,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default
RULES_ITEM = "ROADMAP.md Queue A item 9m (custom sharding rules in training)"
MOE_TP_ITEM = "ROADMAP.md Queue A item 9i"
#: the reference's refusal of ring attention under a logit softcap
#: (``smg_tpu/train/step.py``), word for word
RING_SOFTCAP = ("ring attention does not implement attn_logit_softcap; train "
                "softcapped (Gemma-2) models with sp=1 / use_ring_attention=False")
#: gradients go through a sum over an axis in buckets of at most this many
#: bytes (a bounded copy beside the gradients)
GRAD_BUCKET_BYTES = 256 << 20


@dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: ``mu``/``nu`` trees shaped as the
    params, in their dtype, and ``count``, the updates applied."""
    mu: dict
    nu: dict
    count: int


@dataclass
class TrainState:
    params: dict
    opt_state: AdamWState
    step: int


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_views(tree: dict) -> list[torch.Tensor]:
    """The leaves of a parameter-shaped tree in a fixed order, every stacked
    layer tensor as its L per-layer views."""
    out = [tree[k] for k in sorted(tree) if k != "layers"]
    for k in sorted(tree["layers"]):
        out.extend(tree["layers"][k][l] for l in range(tree["layers"][k].shape[0]))
    return out


def nll_sum(logits: torch.Tensor, targets: torch.Tensor,
            loss_mask: torch.Tensor) -> torch.Tensor:
    """The NLL of ``targets`` under float32 ``logits`` [B, T, V] summed over
    the positions ``loss_mask`` weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * loss_mask.float()).sum()


def vocab_parallel_nll_sum(logits: torch.Tensor, targets: torch.Tensor,
                           loss_mask: torch.Tensor, tp, vocab0: int) -> torch.Tensor:
    """``nll_sum`` of logits whose vocab columns are split over the tp ranks
    (Megatron's vocab-parallel cross-entropy): ``logits`` [B, T, V/tp] this
    rank's columns from ``vocab0`` (float32), ``tp`` its ``TrainGroup``.
    The log-sum-exp over every rank's columns and the target's logit, held
    by one rank, are sums over tp (``reduce_from``), so no rank gathers the
    [B, T, V] logits; each rank's gradient is its columns' share of the
    softmax less the target's one-hot."""
    top = tp.axis.all_gather(logits.detach().amax(dim=-1, keepdim=True)).amax(
        dim=-1, keepdim=True)  # a constant for exp's range
    shifted = logits - top
    lse = torch.log(tp.all_reduce(torch.exp(shifted).sum(dim=-1)))
    local = targets.long() - vocab0
    mine = (local >= 0) & (local < logits.shape[-1])
    picked = shifted.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    picked = tp.all_reduce(torch.where(mine, picked, 0.0))
    return ((lse - picked) * loss_mask.float()).sum()


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               loss_mask: torch.Tensor) -> torch.Tensor:
    """The reference's loss: mean NLL of ``targets`` under float32
    ``logits`` [B, T, V] over the positions ``loss_mask`` weights."""
    return nll_sum(logits, targets, loss_mask) / loss_mask.float().sum().clamp(min=1.0)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every element,
    accumulated in float32."""
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                         for t in tensors])
    return torch.linalg.vector_norm(norms)


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis sizes of ``mesh``: a mapping of axis sizes or an object with
    ``.shape`` (a JAX ``Mesh``).  Raises ValueError on an axis outside the
    reference's ``AXIS_ORDER``."""
    shape = dict(getattr(mesh, "shape", mesh) or {})
    for axis, n in shape.items():
        if axis not in AXIS_ORDER:
            raise ValueError(f"mesh axis {axis!r}: expected axis=N with axis in "
                             f"{sorted(AXIS_ORDER)}")
        if int(n) < 1:
            raise ValueError(f"mesh axis {axis!r}: size must be >= 1")
    return {a: int(shape.get(a, 1)) for a in AXIS_ORDER}


def check_rules(rules) -> None:
    """Take ``rules`` when it is None or the reference's default table
    (with ``layers -> pp`` or without); any other table raises, naming its
    ROADMAP item: the port places pieces by its ``Sharder``."""
    if rules is None:
        return
    table = getattr(rules, "rules", rules)
    if not isinstance(table, dict) or table not in (DEFAULT_RULES,
                                                    {**DEFAULT_RULES, "layers": "pp"}):
        raise NotImplementedError(
            f"the training step lays pieces out by the reference's default rules table "
            f"only; a custom table is {RULES_ITEM}")


def adamw(leaves: list, mu: list, nu: list, count: int, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` over ``leaves`` (tensors that require grad), as a
    fused ``torch.optim.AdamW`` whose moments are the tensors ``mu``/``nu``
    (one a leaf, updated in place) after ``count`` updates."""
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                            weight_decay=WEIGHT_DECAY, fused=True)
    for p, m, v in zip(leaves, mu, nu, strict=True):
        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32,
                                             device=p.device),
                        "exp_avg": m, "exp_avg_sq": v}
    return opt




def flat_names(tree: dict) -> list[str]:
    """The names of a parameter-shaped tree's leaves in ``layer_views``'s
    order: top-level keys, then ``layers.<key>`` (each of L views)."""
    out = [k for k in sorted(tree) if k != "layers"]
    for k in sorted(tree["layers"]):
        out.extend([f"layers.{k}"] * tree["layers"][k].shape[0])
    return out


class _Bound:
    """One state's training model and optimizer: the model over per-layer
    leaf views of the params, a fused ``torch.optim.AdamW`` over the same
    views whose moments are the matching views of ``mu``/``nu``.  ``groups``
    are the model's collectives on a training mesh (``LlamaModel``'s
    ``tp``, ``pp``, ``sp``, ``ep``)."""

    def __init__(self, cfg: ModelConfig, state: TrainState, lr: float, **groups):
        self.params, self.mu, self.nu = state.params, state.opt_state.mu, state.opt_state.nu
        # aliases of the state's storage: its own tensors stay without grad
        layers = {k: [w.detach()[l].requires_grad_() for l in range(w.shape[0])]
                  for k, w in self.params["layers"].items()}
        top = {k: v.detach().requires_grad_() for k, v in self.params.items()
               if k != "layers"}
        self.model = LlamaModel(cfg, {**top, "layers": layers}, **groups)
        self.leaves = [top[k] for k in sorted(top)]
        for k in sorted(layers):
            self.leaves.extend(layers[k])
        self.names = flat_names(self.params)
        self.count = state.opt_state.count
        self.opt = adamw(self.leaves, layer_views(self.mu), layer_views(self.nu),
                         self.count, lr)

    def holds(self, state: TrainState) -> bool:
        return (self.params is state.params and self.mu is state.opt_state.mu
                and self.nu is state.opt_state.nu and self.count == state.opt_state.count)

    def update(self, state: TrainState) -> TrainState:
        """AdamW on the gradients in the leaves' ``.grad``, which it clears;
        the next state over the same tensors."""
        self.opt.step()
        for p in self.leaves:
            p.grad = None
        self.count += 1
        return TrainState(params=state.params,
                          opt_state=AdamWState(mu=self.mu, nu=self.nu, count=self.count),
                          step=state.step + 1)


def zero_state(params: dict) -> TrainState:
    """``params`` with zero moments at step 0."""
    return TrainState(params=params,
                      opt_state=AdamWState(mu=tree_map(torch.zeros_like, params),
                                           nu=tree_map(torch.zeros_like, params), count=0),
                      step=0)


def train_options(cfg: ModelConfig, mesh=None, rules=None,
                  use_ring_attention: bool | None = None,
                  num_microbatches: int | None = None) -> tuple[dict, bool, int]:
    """The reference's defaults and refusals (``smg_tpu/train/step.py``):
    (the mesh's axis sizes, ring attention on or off, the microbatches).
    ``num_microbatches`` defaults to 2 x pp under pp, else 1; ring attention
    to on when sp > 1, refused under a logit softcap; a custom ``rules``
    table raises (9m), as does a model the mesh cannot split."""
    sizes = mesh_sizes(mesh)
    check_rules(rules)
    pp = sizes["pp"]
    if num_microbatches is None:
        num_microbatches = 2 * pp if pp > 1 else 1
    if use_ring_attention is None:
        use_ring_attention = sizes["sp"] > 1
    if use_ring_attention and cfg.attn_logit_softcap:
        raise ValueError(RING_SOFTCAP)
    if pp > 1:
        check_stages(cfg.num_layers, pp)
    check_mesh(cfg, RankPlace.of(sizes, {}))
    if cfg.num_experts and sizes["tp"] > 1:
        raise NotImplementedError(f"the expert layer under tp > 1 is {MOE_TP_ITEM}")
    return sizes, bool(use_ring_attention), int(num_microbatches)


def check_batch(sizes: dict, microbatches: int, shape: tuple) -> None:
    """Raise ValueError when a [B, T] batch cannot be split over the mesh:
    B over dp, T over sp (the reference's jit refuses unevenly sharded
    arguments), B into the pipeline's microbatches (its words)."""
    B, T = shape
    if B % sizes["dp"]:
        raise ValueError(f"batch {B} not divisible by dp={sizes['dp']}")
    if T % sizes["sp"]:
        raise ValueError(f"sequence length {T} not divisible by sp={sizes['sp']}: the "
                         f"reference refuses an unevenly sharded sequence")
    if sizes["pp"] > 1:
        check_microbatches(B, microbatches)


def _axis_sum(axis, tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` (one dtype) over ``axis`` in place, in buckets of at
    most ``GRAD_BUCKET_BYTES``."""
    i = 0
    while i < len(tensors):
        j, nbytes = i, 0
        while j < len(tensors) and (j == i or nbytes + tensors[j].nbytes <= GRAD_BUCKET_BYTES):
            nbytes += tensors[j].nbytes
            j += 1
        part = tensors[i:j]
        flat = axis.sum(torch.cat([t.reshape(-1) for t in part]))
        for t, g in zip(part, flat.split([t.numel() for t in part]), strict=True):
            t.copy_(g.view_as(t))
        i = j


class RankTrainer:
    """One rank's body of the sharded step: its place on the grid, its
    pieces of the state and its model over them.  Every method is called on
    every rank in the same order (rank 0's leader broadcasts the calls,
    ``train/leader.py``); the collectives inside pair the ranks up.

    ``cfg`` is the whole model's config; ``groups`` the rank's
    ``parallel/group.py::RankGroups`` over the training grid."""

    def __init__(self, cfg: ModelConfig, groups, learning_rate: float, ring: bool,
                 microbatches: int):
        self.cfg, self.groups, self.lr = cfg, groups, learning_rate
        self.ring, self.microbatches = ring, microbatches
        self.sizes = {a: groups.sizes.get(a, 1) for a in AXIS_ORDER}
        self.coords = groups.coords
        self.place = RankPlace.of(self.sizes, self.coords)
        self.device = groups.device
        self.rank_cfg = rank_config(cfg, self.place.tp, self.place.pp, self.place.ep)
        self.sharder = Sharder(cfg, self.place)
        self.rules = train_rules(cfg, self.sizes)
        ax = groups.axis
        self.model_groups = dict(
            tp=TrainGroup(ax("tp")) if ax("tp") else None, pp=ax("pp"), sp=ax("sp"),
            ep=TrainGroup(ax("ep")) if ax("ep") else None)
        self.state: TrainState | None = None
        self.bound: _Bound | None = None

    # ---- the state ----

    def init(self, seed: int = 0, params: dict | None = None) -> None:
        """Zero moments at step 0 over this rank's piece of ``params`` (the
        whole tree, host tensors) or of ``init_params`` drawn from ``seed``
        (the whole model's draws, the rank's part kept)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            mine = init_params(self.cfg, gen, self.device, shard=self.sharder)
        else:
            mine = self._pieces(params)
        self._set(zero_state(mine))

    def place_state(self, state: TrainState) -> None:
        """This rank's piece of a whole ``TrainState`` (host tensors)."""
        self._set(TrainState(params=self._pieces(state.params),
                             opt_state=AdamWState(mu=self._pieces(state.opt_state.mu),
                                                  nu=self._pieces(state.opt_state.nu),
                                                  count=state.opt_state.count),
                             step=state.step))

    def _pieces(self, tree: dict) -> dict:
        """This rank's pieces of a whole tree, as tensors of its own."""
        cut = lambda k, v: self.sharder.piece(k, v).to(self.device, copy=True)  # noqa: E731
        out = {k: cut(k, v) for k, v in tree.items() if k != "layers" and self.sharder.holds(k)}
        out["layers"] = {k: cut(k, v) for k, v in tree["layers"].items()}
        return out

    def _set(self, state: TrainState) -> None:
        self.state, self.bound = state, None

    def _named(self, tree: dict) -> dict[str, torch.Tensor]:
        out = {k: v for k, v in tree.items() if k != "layers"}
        out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
        return out

    def pieces(self) -> dict:
        """This rank's pieces of params, mu and nu by leaf name, on the
        host, with its coordinates, count and step (``gather_state``)."""
        st = self.state
        return dict(coords=self.coords, count=st.opt_state.count, step=st.step,
                    trees={t: {k: v.detach().cpu() for k, v in self._named(tree).items()}
                           for t, tree in (("params", st.params), ("mu", st.opt_state.mu),
                                           ("nu", st.opt_state.nu))})

    def memory(self) -> dict:
        """This rank's device bytes: allocated now, and the most allocated
        since the last call (the peak is reset); None on the CPU."""
        if self.device.type != "cuda":
            return {"allocated": None, "peak": None}
        out = {"allocated": torch.cuda.memory_allocated(self.device),
               "peak": torch.cuda.max_memory_allocated(self.device)}
        torch.cuda.reset_peak_memory_stats(self.device)
        return out

    def square_sums(self) -> dict:
        """For every leaf of params, mu and nu, the sum of squares of this
        rank's piece (its float32 norm, squared) where the rank counts it
        (``LeafRule.owner``), else 0."""
        st = self.state
        out = {}
        for t, tree in (("params", st.params), ("mu", st.opt_state.mu), ("nu", st.opt_state.nu)):
            for k, v in self._named(tree).items():
                own = self.rules[k].owner(self.coords)
                out[f"{t}.{k}"] = float(global_norm([v])) ** 2 if own else 0.0
        return out

    # ---- the step ----

    def step(self, tokens, targets, loss_mask) -> tuple[float, float]:
        """One AdamW step on the whole [B, T] batch (host arrays; this rank
        takes its rows and positions).  Returns the loss and the squared
        gradient norm, summed over every rank (the same on each)."""
        if self.bound is None or not self.bound.holds(self.state):
            self.bound = _Bound(self.rank_cfg, self.state, self.lr, **self.model_groups)
        b = self.bound
        B, T = np.shape(tokens)
        dp, sp = self.sizes["dp"], self.sizes["sp"]
        rows = slice(self.coords["dp"] * B // dp, (self.coords["dp"] + 1) * B // dp)
        cols = slice(self.coords["sp"] * T // sp, (self.coords["sp"] + 1) * T // sp)
        count = max(float(np.asarray(loss_mask, np.float64).sum()), 1.0)  # the whole batch's
        tokens, targets, loss_mask = (torch.as_tensor(np.asarray(x)[rows, cols], device=self.device)
                                      for x in (tokens, targets, loss_mask))
        Bl, Tl = tokens.shape
        pp = self.model_groups["pp"]
        M = local_microbatches(B, Bl, self.microbatches) if pp else 1
        mb = Bl // M
        model = b.model

        def embed(m):
            return model.embed_tokens(tokens[m * mb:(m + 1) * mb])

        def layers(h):
            return model.layers_train(h, self.ring)

        def loss(m, h):
            r = slice(m * mb, (m + 1) * mb)
            if model.vocab_start is None:
                return nll_sum(model.unembed(h), targets[r], loss_mask[r]) / count
            return vocab_parallel_nll_sum(model.unembed(h, gather=False), targets[r],
                                          loss_mask[r], model.tp, model.vocab_start) / count

        with ieee_float32():
            total = pipeline_backward(pp, M, embed, layers, loss,
                                      (mb, Tl, self.cfg.hidden_size), model.dtype, self.device)
            self._sum_gradients(b)
            owned = [p.grad for name, p in zip(b.names, b.leaves, strict=True)
                     if self.rules[name].owner(self.coords)]
            sq = float(global_norm(owned)) ** 2 if owned else 0.0
            self.state = b.update(self.state)
        if self.device.type == "cuda":  # the step is done on every rank when it returns
            torch.cuda.synchronize(self.device)
        counted = (total is not None and self.coords["tp"] == 0 and self.coords["ep"] == 0)
        mine = torch.tensor([float(total) if counted else 0.0, sq], dtype=torch.float64)
        self.groups.control.allreduce([mine]).wait()
        return float(mine[0]), float(mine[1])

    def _sum_gradients(self, b: _Bound) -> None:
        """Sum each leaf's gradient over the axes its ``LeafRule`` names, in
        ``AXIS_ORDER`` on every rank: dp and sp in buckets, tp over the
        ranks sharing a piece (a piece held by fewer than all tp ranks goes
        through a whole-width buffer), ep, and the tied embedding between the
        first and the last pp stage."""
        by_axis: dict[str, list] = {}
        for name, p in zip(b.names, b.leaves, strict=True):
            for axis in self.rules[name].summed:
                by_axis.setdefault(axis, []).append((name, p))
        for axis in AXIS_ORDER:
            pairs = by_axis.get(axis)
            if not pairs:
                continue
            group = self.groups.axis(axis)
            if axis == "pp":
                self._tied_sum(group, [p.grad for _, p in pairs])
            elif axis == "tp":
                for name, p in pairs:
                    self._tp_sum(group, name, p.grad)
            else:
                for dtype in sorted({p.grad.dtype for _, p in pairs}, key=str):
                    _axis_sum(group, [p.grad for _, p in pairs if p.grad.dtype == dtype])

    def _tp_sum(self, group, name: str, grad: torch.Tensor) -> None:
        rule = self.rules[name]
        if rule.tp_share == group.size:
            grad.copy_(group.sum(grad))
            return
        # a KV head held by a group of ranks: each rank's part in its place
        # of a whole-width buffer, summed, its place read back
        _, a, b = tp_range(name.removeprefix("layers."), self.sharder.plan, self.cfg.head_dim)
        whole = grad.new_zeros((*grad.shape[:-1], self.cfg.num_kv_heads * self.cfg.head_dim))
        whole[..., a:b] = grad
        grad.copy_(group.sum(whole)[..., a:b])

    def _tied_sum(self, group, grads: list[torch.Tensor]) -> None:
        """The tied embedding's gradients of the first and the last stage,
        summed on both (the middle stages hold no embedding)."""
        first, last = 0, group.size - 1
        if group.rank not in (first, last):
            return
        for g in grads:
            if group.rank == first:
                group.send(g, last)
                other = group.recv(torch.empty_like(g), last)
            else:
                other = group.recv(torch.empty_like(g), first)
                group.send(g, first)
            g.add_(other)


def make_train_step(cfg: ModelConfig, device=None, learning_rate: float = 1e-4, *,
                    mesh=None, rules=None, use_ring_attention: bool | None = None,
                    num_microbatches: int | None = None, devices=None, ranks=None):
    """Returns ``(init_fn, step_fn)`` on ``device`` (the card unless the
    caller asks for the CPU; no CPU fallback).

    ``init_fn(seed=0, params=None)``: random weights (``init_params`` from
    a generator seeded with ``seed``), or ``params`` moved to the device and
    trained in place from then on; zero moments; step 0.
    ``step_fn(state, tokens, targets, loss_mask)``: [B, T] tensors or
    arrays; returns the next state and ``{"loss", "grad_norm"}``.

    ``mesh`` (axis sizes, or a JAX ``Mesh``), ``rules``,
    ``use_ring_attention`` and ``num_microbatches`` are the reference's.  A
    mesh of more than one device runs a rank process on each of
    ``devices`` (``train/leader.py``); the state is then a handle on the
    ranks' pieces, ``step_fn.close()`` stops them and ``gather_state``
    brings the whole tree to the host.  ``ranks`` (a
    ``train/leader.py::RankPool``) lends the mesh its follower processes,
    which outlive its close; without it the mesh starts a pool of its own
    and stops it at ``close``.  One device takes ring attention
    (the same attention) and ignores the microbatches, as the reference's
    one-stage pipeline does."""
    sizes, ring, microbatches = train_options(cfg, mesh, rules, use_ring_attention,
                                              num_microbatches)
    if math.prod(sizes.values()) > 1:
        from smg_tpu_torch.train.leader import MeshTrainer

        return MeshTrainer(cfg, sizes, devices, learning_rate, ring, microbatches,
                           ranks=ranks).functions()
    dev = resolve_device(device)
    bound: list[_Bound] = []  # the state the last step ran on

    def init(seed: int = 0, params: dict | None = None) -> TrainState:
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        else:
            params = tree_map(lambda t: t.detach().to(dev), params)
        return zero_state(params)

    def step(state: TrainState, tokens, targets, loss_mask):
        if not (bound and bound[0].holds(state)):
            bound[:] = [_Bound(cfg, state, learning_rate)]
        b = bound[0]
        tokens, targets, loss_mask = (torch.as_tensor(x, device=dev)
                                      for x in (tokens, targets, loss_mask))
        with ieee_float32():
            loss = masked_nll(b.model.forward_train(tokens), targets, loss_mask)
            loss.backward()
            gnorm = global_norm([p.grad for p in b.leaves])
            nxt = b.update(state)
        return nxt, {"loss": loss.detach(), "grad_norm": gnorm}

    step.close = lambda: None
    return init, step
