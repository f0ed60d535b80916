"""The leader of a sharded training step: rank 0 in the caller's process,
a follower process for every other rank of the mesh — the counterpart of
the reference's jitted ``make_train_step`` over a mesh
(``smg_tpu/train/step.py``), which one process drives over every device.

``MeshTrainer`` opens a ``TCPStore``, takes its followers from a
``RankPool`` (its own, started with the mesh and stopped at its close, or
the caller's, whose processes outlive the mesh and serve the next one) and
builds its own ``RankTrainer`` (``train/step.py``) on the training grid
(``parallel/group.py::RankGroups``).  The serving mesh's ``Leader``
(``parallel/leader.py``) mirrors the trainer's calls: each broadcasts its
name and host arguments on the control group, then runs on rank 0, and
every follower (``parallel/leader.py::follow``) makes it on its own rank.
The calls: ``init`` (weights from a seed, each rank drawing the whole model
and keeping its piece, or a whole parameter tree every rank cuts),
``place_state`` (a whole ``TrainState`` cut the same way), ``step`` (the
whole [B, T] batch goes to every rank, which takes its rows and positions);
and, gathered to rank 0, ``pieces`` (every rank's pieces, put together as
the whole tree on the host), ``square_sums`` (the norm of every leaf,
scalars only) and ``memory``.

The state ``init`` and ``step`` return is a handle (``MeshTrainState``):
the pieces stay on the ranks.  A step consumes the handle it is given, as
the reference's donated state; an older handle raises.

Liveness is the serving mesh's (``Leader``): pings while rank 0 is idle; a
follower whose call raised, or whose leader is gone, exits, and rank 0's
next collective then fails at once.  A failed call marks the mesh broken:
every later call raises.  ``close`` hands the followers back to their pool
idle, and stops the pool when the mesh owns it."""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from dataclasses import dataclass

import torch

from smg_tpu_torch.engine.config import ParallelConfig
from smg_tpu_torch.models.llama import init_params
from smg_tpu_torch.parallel.group import (
    TP_TIMEOUT_S,
    RankGroups,
    connect_store,
    open_store,
    resolve_devices,
)
from smg_tpu_torch.parallel.leader import (
    _PRELOAD,
    Leader,
    _await_followers,
    _rank_context,
    _watch_parent,
    follow,
)
from smg_tpu_torch.parallel.sharding import RankPlace, Sharder
from smg_tpu_torch.train.step import (
    AdamWState,
    RankTrainer,
    TrainState,
    check_batch,
)
#: what a training mesh's fork server imports: the serving mesh's modules,
#: this one, and ``torch._dynamo``, which ``torch.optim`` imports at its
#: first step (seconds in every new process)
TRAIN_PRELOAD = [*_PRELOAD, "smg_tpu_torch.train.leader", "torch._dynamo"]

@dataclass
class MeshTrainState:
    """A handle on the ranks' ``TrainState`` pieces: its ``step`` and the
    optimizer's ``count``, and the trainer that holds it."""

    step: int
    count: int
    trainer: "MeshTrainer"
    version: int


#: the trainer's calls rank 0 broadcasts, and those whose results it
#: gathers from every rank
MIRRORED = ("init", "place_state", "step")
GATHERED = {"pieces": RankTrainer.pieces, "square_sums": RankTrainer.square_sums,
            "memory": RankTrainer.memory}


class MeshTrainer:
    """Rank 0's side of a training mesh of ``sizes`` (axis -> size) on
    ``devices`` (one a rank; None: ``cuda:0 .. cuda:N-1``, raising when the
    machine has fewer); its followers come from ``ranks`` (a ``RankPool``)
    or from a pool of its own."""

    def __init__(self, cfg, sizes: dict, devices, learning_rate: float, ring: bool,
                 microbatches: int, timeout: float = TP_TIMEOUT_S,
                 ranks: "RankPool | None" = None):
        self.cfg, self.sizes, self.microbatches = cfg, sizes, microbatches
        devs = resolve_devices(ParallelConfig(**sizes), devices)
        world = len(devs)
        self.owned = ranks is None
        self.pool = RankPool(world - 1) if ranks is None else ranks
        workers = self.pool.take(world - 1)
        procs = [p for p, _ in workers]
        try:
            store = open_store(world, timeout)
            spec = dict(port=store.port, devices=[str(d) for d in devs], config=cfg,
                        sizes=sizes, lr=learning_rate, ring=ring, microbatches=microbatches,
                        timeout=timeout)
            for rank, (_, conn) in enumerate(workers, start=1):
                conn.send({**spec, "rank": rank})
            _await_followers(store, procs, timeout)
            groups = RankGroups(store, 0, devs, timeout, sizes=sizes)
            self.rank = RankTrainer(cfg, groups, learning_rate, ring, microbatches)
        except BaseException:
            self.pool.give_back(workers, 0.0)  # none answers idle: each is killed
            if self.owned:
                self.pool.close()
            raise
        self.store = store
        self.device = devs[0]
        self.leader = Leader(self.rank, groups, procs, mirrored=MIRRORED, gathered=GATHERED,
                             release=lambda t: self.pool.give_back(workers, t),
                             name="training mesh")
        self._version = 0

    @property
    def procs(self) -> list:
        """The follower processes, in rank order."""
        return self.leader.procs

    # ---- the calls ----

    def functions(self):
        """``(init_fn, step_fn)`` as ``make_train_step`` returns them; the
        step also has ``close`` and ``trainer``."""

        def init(seed: int = 0, params: dict | None = None) -> MeshTrainState:
            return self.init(seed, params)

        def step(state: MeshTrainState, tokens, targets, loss_mask):
            return self.step(state, tokens, targets, loss_mask)

        init.trainer = step.trainer = self
        step.close = self.close
        return init, step

    def _trainer(self) -> RankTrainer:
        if self.rank is None:
            raise RuntimeError("training mesh is closed")
        return self.rank

    def _handle(self) -> MeshTrainState:
        self._version += 1
        st = self.rank.state
        return MeshTrainState(st.step, st.opt_state.count, self, self._version)

    def _check(self, state: MeshTrainState) -> None:
        if state.trainer is not self or state.version != self._version:
            raise ValueError("this training state is not the mesh's current one: a step "
                             "consumes the state it is given")

    def init(self, seed: int = 0, params: dict | None = None) -> MeshTrainState:
        """Weights from ``seed`` (each rank keeps its piece of the whole
        draw) or the whole tree ``params`` (host tensors), zero moments."""
        self._trainer().init(seed, None if params is None else _host(params))
        return self._handle()

    def place(self, state: TrainState) -> MeshTrainState:
        """A whole ``TrainState`` (host tensors) cut onto the ranks."""
        self._trainer().place_state(TrainState(
            params=_host(state.params),
            opt_state=AdamWState(mu=_host(state.opt_state.mu), nu=_host(state.opt_state.nu),
                                 count=state.opt_state.count),
            step=state.step))
        return self._handle()

    def step(self, state: MeshTrainState, tokens, targets, loss_mask):
        """One step on the whole [B, T] batch; ``(next state, {"loss",
        "grad_norm"})``, 0-d float32 tensors on rank 0's device."""
        self._check(state)
        arrays = [(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
                  for x in (tokens, targets, loss_mask)]
        check_batch(self.sizes, self.microbatches, tuple(arrays[0].shape))
        loss, sq = self._trainer().step(*arrays)
        metric = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        return self._handle(), {"loss": metric(loss), "grad_norm": metric(sq ** 0.5)}

    def gather_state(self, state: MeshTrainState) -> TrainState:
        """The whole ``TrainState`` on the host, as ``jax.device_get`` of
        the reference's would give it: every rank's pieces put in place."""
        self._check(state)
        pieces = self.leader.gather("pieces")
        # the whole model's shapes, drawn on the meta device (no memory)
        drawn = init_params(self.cfg, torch.Generator(), "meta")
        layers = drawn.pop("layers")
        shapes = {k: v.shape for k, v in {**drawn, **layers}.items()}
        trees = {}
        for t in ("params", "mu", "nu"):
            whole = {}
            for part in pieces:
                cut = Sharder(self.cfg, RankPlace.of(self.sizes, part["coords"]))
                for name, piece in part["trees"][t].items():
                    key = name.removeprefix("layers.")
                    if name not in whole:
                        whole[name] = piece.new_zeros(shapes[key])
                    whole[name][cut.region(key, shapes[key])] = piece
            trees[t] = _nest(whole)
        return TrainState(params=trees["params"],
                          opt_state=AdamWState(mu=trees["mu"], nu=trees["nu"],
                                               count=pieces[0]["count"]),
                          step=pieces[0]["step"])

    def leaf_norms(self, state: MeshTrainState) -> dict[str, float]:
        """The L2 norm of every leaf of params, mu and nu (``"params.embed"``,
        ``"mu.layers.wq"``, ...), each piece counted once: sums of squares
        from the ranks, no tensor gathered."""
        self._check(state)
        sums = self.leader.gather("square_sums")
        names = sorted(set().union(*sums))  # the stages hold different leaves
        return {k: sum(s.get(k, 0.0) for s in sums) ** 0.5 for k in names}

    def rank_memory(self) -> list[dict]:
        """Every rank's ``RankTrainer.memory`` (device bytes allocated and
        the peak since the last reading), in rank order."""
        return self.leader.gather("memory")

    def rank_pids(self) -> list[int]:
        """The follower processes' pids."""
        return [p.pid for p in self.procs]

    def close(self, timeout: float = 30.0) -> None:
        """Hand the followers back to their pool idle (and stop it when the
        mesh owns it); kill any that linger."""
        if self.rank is None:
            return
        self.leader.close(timeout)
        self.rank = None
        _release_device(self.device)
        if self.owned:
            self.pool.close(timeout)


class RankPool:
    """The follower processes of training meshes: a mesh of N ranks takes
    N - 1 of them, and at its close each leaves the mesh's groups, drops
    its tensors and waits for the next mesh.  A mesh started without one
    makes its own and stops it at its close; a caller that runs meshes one
    after another (``make_train_step(..., ranks=pool)``, as
    ``chip_smoke.py``'s phase 22 runs seven) lends one pool to all of them,
    so each mesh after the first forks no process and initialises no CUDA
    context, cuBLAS or lazily loaded kernel again.  One mesh at a time;
    ``close`` stops the processes, forked from the fork server that
    preloads ``TRAIN_PRELOAD``."""

    def __init__(self, size: int):
        ctx = _rank_context(TRAIN_PRELOAD)
        self.workers: list[tuple] = []  # (process, connection)
        self.busy = False
        for i in range(size):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=pool_main, args=(theirs, os.getpid(), torch.get_num_threads()),
                            name=f"smg-train-pool{i}", daemon=True)
            p.start()
            theirs.close()
            self.workers.append((p, ours))
        self.started = [p.pid for p, _ in self.workers]

    def pids(self) -> list[int]:
        """Every worker the pool started, retired ones included."""
        return list(self.started)

    def take(self, n: int) -> list[tuple]:
        """``n`` live workers for a mesh (raises when the pool is serving
        one, or has fewer)."""
        if self.busy:
            raise RuntimeError("the rank pool serves one training mesh at a time")
        alive = [w for w in self.workers if w[0].is_alive()]
        if len(alive) < n:
            raise RuntimeError(f"the rank pool has {len(alive)} live processes; the mesh "
                               f"needs {n}")
        self.busy = True
        return alive[:n]

    def give_back(self, workers: list[tuple], timeout: float) -> None:
        """Wait for each of a closed mesh's ``workers`` to say it is idle;
        one that does not within ``timeout`` is killed."""
        deadline = time.monotonic() + timeout
        for p, conn in workers:
            try:
                if conn.poll(max(deadline - time.monotonic(), 0.1)):
                    conn.recv()
                    continue
            except (EOFError, OSError):  # it died: nothing to wait for
                pass
            p.kill()
            p.join(5)
        self.busy = False

    def retire(self, keep: int, timeout: float = 30.0) -> None:
        """Stop every idle worker past the first ``keep``: their CUDA
        contexts and whatever their caches hold go back to the card."""
        extra, self.workers = self.workers[keep:], self.workers[:keep]
        _stop(extra, timeout)

    def close(self, timeout: float = 30.0) -> None:
        _stop(self.workers, timeout)
        self.workers = []


def _stop(workers: list[tuple], timeout: float) -> None:
    """Tell idle pool workers to exit and wait for them; kill any that
    linger."""
    for p, conn in workers:
        try:
            conn.send(None)
        except (BrokenPipeError, OSError):  # already gone
            pass
    deadline = time.monotonic() + timeout
    for p, _ in workers:
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.is_alive():
            p.kill()
            p.join(5)


def gather_state(state) -> TrainState:
    """The whole training state on the host: a mesh's handle put together
    from its ranks' pieces, a one-device state copied."""
    if isinstance(state, MeshTrainState):
        return state.trainer.gather_state(state)
    return TrainState(params=_host(state.params),
                      opt_state=AdamWState(mu=_host(state.opt_state.mu),
                                           nu=_host(state.opt_state.nu),
                                           count=state.opt_state.count),
                      step=state.step)


def leaf_norms(state) -> dict[str, float]:
    """The L2 norm of every leaf of params, mu and nu by name
    (``MeshTrainer.leaf_norms``'s names), of a mesh's handle or of a
    one-device state."""
    if isinstance(state, MeshTrainState):
        return state.trainer.leaf_norms(state)
    out = {}
    for t, tree in (("params", state.params), ("mu", state.opt_state.mu),
                    ("nu", state.opt_state.nu)):
        flat = {**{k: v for k, v in tree.items() if k != "layers"},
                **{f"layers.{k}": v for k, v in tree["layers"].items()}}
        for k, v in flat.items():
            out[f"{t}.{k}"] = float(torch.linalg.vector_norm(v, dtype=torch.float32))
    return dict(sorted(out.items()))


def _host(tree: dict) -> dict:
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _nest(flat: dict) -> dict:
    out = {k: v for k, v in flat.items() if not k.startswith("layers.")}
    out["layers"] = {k.removeprefix("layers."): v for k, v in flat.items()
                     if k.startswith("layers.")}
    return out


def _release_device(device: torch.device) -> None:
    """Give a closed mesh's cached device blocks back (its groups'
    ``shutdown`` gave back the sums' CUDA IPC buffers)."""
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def _follow(spec: dict) -> None:
    """One follower rank of one mesh: join the grid, build the rank's
    trainer, then make rank 0's calls until it says close (or stops
    pinging: the process exits)."""
    rank = spec["rank"]
    store = connect_store(spec["port"], len(spec["devices"]), spec["timeout"])
    store.set(f"up{rank}", "1")
    groups = RankGroups(store, rank, spec["devices"], spec["timeout"], sizes=spec["sizes"])
    trainer = RankTrainer(spec["config"], groups, spec["lr"], spec["ring"],
                          spec["microbatches"])
    follow(groups, trainer, GATHERED)
    device = trainer.device
    del trainer
    groups.shutdown()
    del groups, store
    _release_device(device)


def pool_main(conn, parent: int, threads: int) -> None:
    """A ``RankPool`` worker: a follower of each mesh it is sent, idle
    between them, until it is sent None (or its creator is gone: the
    process exits)."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    torch.set_num_threads(threads)
    while True:
        try:
            spec = conn.recv()
        except EOFError:
            break
        if spec is None:
            break
        _follow(spec)
        conn.send("idle")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
