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
TF32.  The reference's sharded variants (dp/tp batches and weights, sp ring
attention, the pp microbatch schedule) need several devices: a ``mesh``,
``rules``, ``use_ring_attention`` or ``num_microbatches`` that would shard
raises, naming ROADMAP Queue A item 9 (parallelism).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from smg_tpu_torch.engine.runner import resolve_device
from smg_tpu_torch.models.config import ModelConfig
from smg_tpu_torch.models.llama import LlamaModel, init_params

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default
PARALLEL_ITEM = "ROADMAP Queue A item 9 (parallelism)"


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


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               loss_mask: torch.Tensor) -> torch.Tensor:
    """The reference's loss: mean NLL of ``targets`` under float32
    ``logits`` [B, T, V] over the positions ``loss_mask`` weights."""
    m = loss_mask.float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * m).sum() / m.sum().clamp(min=1.0)


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


def refuse_sharding(mesh=None, rules=None, use_ring_attention=None,
                    num_microbatches=None) -> None:
    """Raise for any of the reference's mesh arguments that would shard the
    step.  ``mesh`` is a mapping of axis sizes or an object with ``.shape``
    (a JAX ``Mesh``); every axis of size 1 is one device."""
    shape = dict(getattr(mesh, "shape", mesh) or {})
    wide = {k: int(v) for k, v in shape.items() if int(v) > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} shard the training step; the port trains on one "
            f"device until {PARALLEL_ITEM}")
    if rules is not None:
        raise NotImplementedError(f"sharding rules wait for {PARALLEL_ITEM}")
    if use_ring_attention:
        raise NotImplementedError(f"ring attention (sp) waits for {PARALLEL_ITEM}")
    if num_microbatches not in (None, 1):
        raise NotImplementedError(
            f"num_microbatches={num_microbatches} is the pipeline (pp) schedule, which "
            f"waits for {PARALLEL_ITEM}")


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


class _Bound:
    """One state's training model and optimizer: the model over per-layer
    leaf views of the params, a fused ``torch.optim.AdamW`` over the same
    views whose moments are the matching views of ``mu``/``nu``."""

    def __init__(self, cfg: ModelConfig, state: TrainState, lr: float):
        self.params, self.mu, self.nu = state.params, state.opt_state.mu, state.opt_state.nu
        # aliases of the state's storage: its own tensors stay without grad
        layers = {k: [w.detach()[l].requires_grad_() for l in range(w.shape[0])]
                  for k, w in self.params["layers"].items()}
        top = {k: v.detach().requires_grad_() for k, v in self.params.items()
               if k != "layers"}
        self.model = LlamaModel(cfg, {**top, "layers": layers})
        self.leaves = [top[k] for k in sorted(top)]
        for k in sorted(layers):
            self.leaves.extend(layers[k])
        self.count = state.opt_state.count
        self.opt = adamw(self.leaves, layer_views(self.mu), layer_views(self.nu),
                         self.count, lr)

    def holds(self, state: TrainState) -> bool:
        return (self.params is state.params and self.mu is state.opt_state.mu
                and self.nu is state.opt_state.nu and self.count == state.opt_state.count)


def make_train_step(cfg: ModelConfig, device=None, learning_rate: float = 1e-4, *,
                    mesh=None, rules=None, use_ring_attention: bool | None = None,
                    num_microbatches: int | None = None):
    """Returns ``(init_fn, step_fn)`` on ``device`` (the card unless the
    caller asks for the CPU; no CPU fallback).

    ``init_fn(seed=0, params=None)``: random weights (``init_params`` from
    a generator seeded with ``seed``), or ``params`` moved to the device and
    trained in place from then on; zero moments; step 0.
    ``step_fn(state, tokens, targets, loss_mask)``: [B, T] tensors or
    arrays; returns the next state and ``{"loss", "grad_norm"}``."""
    refuse_sharding(mesh, rules, use_ring_attention, num_microbatches)
    dev = resolve_device(device)
    bound: list[_Bound] = []  # the state the last step ran on

    def init(seed: int = 0, params: dict | None = None) -> TrainState:
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        else:
            params = tree_map(lambda t: t.detach().to(dev), params)
        return TrainState(params=params,
                          opt_state=AdamWState(mu=tree_map(torch.zeros_like, params),
                                               nu=tree_map(torch.zeros_like, params),
                                               count=0),
                          step=0)

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
            b.opt.step()
        for p in b.leaves:
            p.grad = None
        b.count += 1
        nxt = TrainState(params=state.params,
                         opt_state=AdamWState(mu=b.mu, nu=b.nu, count=b.count),
                         step=state.step + 1)
        return nxt, {"loss": loss.detach(), "grad_norm": gnorm}

    return init, step
