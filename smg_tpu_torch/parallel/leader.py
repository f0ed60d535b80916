"""The leader (rank 0) and the followers' loop of a rank mesh (tp, pp, sp
and ep, ``parallel/group.py``): a rank-mesh engine's here, and, with the
training rank's calls mirrored, a training mesh's (``train/leader.py``).

The scheduler, the radix cache and the page pool live on rank 0 only: the
engine's process.  Rank 0's ``ModelRunner`` broadcasts each call that
touches the device (``MIRRORED``: its method name and host arguments, the
page tables, positions, sampling arrays, grammar masks and penalty state)
on the control group, then makes the same call itself; every follower runs
the same method on its shard and drops the result.  Collectives inside the
forward pair the ranks up; the sampler runs on every rank over the same
logits (all-gathered over tp, broadcast from the last pipeline stage) with
the same counter-hash noise, so every rank holds the same tokens with no
broadcast of them, and ``rng_mark``/``rng_restore`` stay mirrored.  Adapter
loads are mirrored too: each pipeline stage keeps its layers of an
adapter.

Rank processes fork from a fork server that imported the port once
(``_rank_context``); none is forked from a process holding CUDA.

Calls reach rank 0's runner from several threads (the engine loop, the
overlap pipeline's launch and fetch, aborts), so every broadcast-then-call
runs under one lock: two ranks that issued collectives in different orders
would wait on each other.  A call made inside a mirrored call (``prefill``
calls ``prefill_batched``) is local: the followers make it themselves.  A
lookahead megastep chains from the device column of the previous launch;
that argument travels as the launch's sequence number, and each follower
chains from its own launch of that number (every rank sampled the same
tokens).

Liveness: while rank 0 is idle it pings the followers every quarter of the
timeout, so a follower's receive never times out while the engine lives,
and a follower that waits longer than the timeout (its parent died) exits;
so does one whose parent process is gone, and one whose call failed: rank
0, waiting in that call's collectives, then sees the connection reset at
once instead of waiting out the timeout.  A follower found dead before a
call, or a call that fails under the lock, marks the mesh broken: every
later call with a collective raises at once (the rest run on rank 0
alone, so the scheduler's recovery completes and fails the requests), and
the engine turns unhealthy.  ``close`` stops the followers and joins
them."""

from __future__ import annotations

import functools
import multiprocessing
import os
import sys
import threading
import time
import traceback

import torch

from smg_tpu_torch.parallel.group import TP_TIMEOUT_S, RankGroups, connect_store, open_store
from smg_tpu_torch.utils import get_logger

logger = get_logger("parallel.leader")

#: runner methods that touch a rank's device state: broadcast, then called
MIRRORED = ("prefill", "prefill_extend", "prefill_batched", "decode_multi_async",
            "decode_multi", "decode_spec_async", "sync_slot_penalty_state", "rng_restore",
            "flush_cache_buffers", "invalidate_graphs", "load_lora", "unload_lora")
#: mirrored calls with no collective inside: once the mesh is broken they
#: still run on rank 0, so the scheduler's failure recovery (rewinding the
#: sampling counter, resetting slot state) completes and fails the requests
_LOCAL_WHEN_BROKEN = ("rng_restore", "sync_slot_penalty_state", "flush_cache_buffers",
                      "invalidate_graphs")
#: what a rank-mesh engine refuses in this slice: the ``ROADMAP.md`` Queue A
#: item that brings it, and where it is refused
REFUSED = {
    "dp": ("the in-engine dp axis", "9g"),
    "lora": ("LoRA under tensor parallelism (tp > 1)", "9h"),
    "experts": ("the expert layer under tensor parallelism (tp > 1)", "9i"),
    "vision": ("the vision tower under a rank mesh", "9j"),
    "embeddings": ("embeddings under a rank mesh", "9k"),
    "pd": ("the PD legs under a rank mesh", "9l"),
}
_REFUSED_RUNNER = {"embed": "embeddings", "export_pages": "pd", "export_pages_device": "pd",
                   "import_pages": "pd", "import_pages_device": "pd"}
#: follower launches kept for a lookahead to chain from
_KEEP_LAUNCHES = 8


def refusal(what: str) -> NotImplementedError:
    text, item = REFUSED[what]
    return NotImplementedError(f"{text} is not ported yet: ROADMAP.md Queue A item {item}")


class _Chained:
    """A lookahead's token column: the ``seq``-th megastep's last column."""

    __slots__ = ("seq",)

    def __init__(self, seq: int):
        self.seq = seq


def _tag_launches(runner) -> dict:
    """Number each ``decode_multi_async`` launch on ``runner`` (in call
    order, nested calls included) and keep the last few by number."""
    kept: dict[int, object] = {}
    count = [0]
    inner = runner.decode_multi_async

    @functools.wraps(inner)
    def tagged(*args, **kwargs):
        launch = inner(*args, **kwargs)
        launch.last_col._tp_seq = count[0]
        kept[count[0]] = launch.last_col
        kept.pop(count[0] - _KEEP_LAUNCHES, None)
        count[0] += 1
        return launch

    runner.decode_multi_async = tagged
    return kept


class Leader:
    """Rank 0's side of a rank mesh: wraps the methods of ``target`` (the
    runner, or a training rank) named in ``mirrored`` (instance attributes
    over the class's) so each broadcasts its call before it runs, makes the
    ``gathered`` calls (name -> function of the target) whose results every
    rank gets, owns the follower processes ``procs`` and the ping thread.
    The followers run ``follow``.  ``local_when_broken`` are the mirrored
    calls with no collective inside, which run on rank 0 alone once the
    mesh is broken.  ``release(timeout)`` takes the followers back at
    ``close`` (None: wait for them to exit, and kill any that linger);
    ``name`` is the mesh's in errors."""

    def __init__(self, target, groups: RankGroups, procs: list, *, mirrored: tuple,
                 gathered: dict, local_when_broken: tuple = (), release=None,
                 name: str = "rank mesh"):
        self.target = target
        self.groups = groups
        self.procs = procs
        self.gathered = gathered
        self.local_when_broken = local_when_broken
        self.release = release
        self.name = name
        self._lock = threading.RLock()
        self._local = threading.local()
        self._broken: str | None = None
        self._closed = False
        self._last_send = time.monotonic()
        for m in mirrored:
            setattr(target, m, self._mirror(m, getattr(target, m)))
        self._stop = threading.Event()  # set by close: the ping thread ends within 1 s
        self._pinger = threading.Thread(target=self._ping_loop, name="rank-ping", daemon=True)
        self._pinger.start()

    def _check(self) -> None:
        if self._closed:
            raise RuntimeError(f"{self.name} is closed")
        if self._broken is None:
            dead = [p for p in self.procs if not p.is_alive()]
            if dead:
                self._broken = (f"rank process {dead[0].name} exited "
                                f"(code {dead[0].exitcode})")
        if self._broken is not None:
            raise RuntimeError(f"{self.name} broken: {self._broken}")

    @property
    def alive(self) -> bool:
        """Every follower runs and no call has broken the mesh."""
        # lock-free: the health probe must not wait behind a long call
        broken = self._broken  # smglint: disable=GUARDED GIL-atomic snapshot for health
        closed = self._closed  # smglint: disable=GUARDED GIL-atomic snapshot for health
        return not closed and broken is None and all(p.is_alive() for p in self.procs)

    def _send(self, msg) -> None:
        self.groups.send(msg)
        self._last_send = time.monotonic()

    def _mirror(self, name: str, inner):
        @functools.wraps(inner)
        def mirrored(*args, **kwargs):
            depth = getattr(self._local, "depth", 0)
            if depth:  # inside a mirrored call: the followers make this one too
                return inner(*args, **kwargs)
            with self._lock:
                try:
                    self._check()
                except RuntimeError:
                    if self._closed or name not in self.local_when_broken:
                        raise
                    return inner(*args, **kwargs)  # the mesh is gone; rank 0 alone
                self._local.depth = 1
                try:
                    self._send((name, _wire(args), _wire(kwargs)))
                    return inner(*args, **kwargs)
                except Exception as e:
                    # the followers made the same call: one that failed has exited
                    self._broken = f"{name} failed: {e!r}"
                    raise
                finally:
                    self._local.depth = 0
        return mirrored

    def gather(self, name: str) -> list:
        """Every rank's result of the ``gathered`` call ``name``, in rank
        order (a collective on the control group, under the lock)."""
        with self._lock:
            self._check()
            try:
                self._send((name, (), {}))
                return self.groups.gather(self.gathered[name](self.target))
            except Exception as e:
                self._broken = f"{name} failed: {e!r}"
                raise

    def rank_reports(self) -> list[dict]:
        """Every rank's ``rank_report`` (a serving mesh's)."""
        return self.gather("report")

    def _ping_loop(self) -> None:
        period = self.groups.timeout / 4
        while not self._stop.wait(min(period, 1.0)):
            # lock-free peek: re-read under the lock before sending
            last = self._last_send  # smglint: disable=GUARDED GIL-atomic float peek
            if time.monotonic() - last < period:
                continue
            with self._lock:
                if self._closed or self._broken is not None:
                    return
                try:
                    self._check()
                    self._send(("ping", (), {}))
                except Exception as e:  # noqa: BLE001 - recorded, raised at the next call
                    if self._broken is None:
                        self._broken = f"ping failed: {e!r}"
                    return

    def close(self, timeout: float = 30.0) -> None:
        """Stop the followers and wait for them (or hand them to
        ``release``); kill any that linger."""
        with self._lock:
            if self._closed:
                return
            if self._broken is None:
                try:
                    self._send(("close", (), {}))
                except Exception:  # noqa: BLE001 - a dead peer: terminated below
                    pass
            self._closed = True
            self._stop.set()
        if self.release is not None:
            self.release(timeout)
        else:
            deadline = time.monotonic() + timeout
            for p in self.procs:
                p.join(max(deadline - time.monotonic(), 0.1))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        self.groups.shutdown()


def follow(groups: RankGroups, target, gathered: dict, unwire=None) -> None:
    """A follower's side of ``Leader``: make rank 0's calls on ``target``
    (its arguments through ``unwire``) until it says close; a ``gathered``
    call's result goes to every rank.  A call that fails ends the process
    (code 5), and so does no call within the timeout (4: rank 0 is gone):
    rank 0's collectives then fail at once."""
    rank = groups.rank
    while True:
        try:
            name, args, kwargs = groups.recv()
        except Exception as e:  # noqa: BLE001 - rank 0 is gone or silent past the timeout
            logger.error("rank %d: no call from rank 0 (%r); exiting", rank, e)
            os._exit(4)
        if name == "close":
            return
        if name == "ping":
            continue
        try:
            if name in gathered:
                groups.gather(gathered[name](target))
            else:
                if unwire is not None:
                    args, kwargs = unwire(args), unwire(kwargs)
                getattr(target, name)(*args, **kwargs)
        except Exception:  # noqa: BLE001 - out: rank 0's collectives fail at once
            logger.error("rank %d: %s failed; exiting\n%s", rank, name,
                         traceback.format_exc())
            sys.stderr.flush()
            os._exit(5)


def _refuse(what: str):
    def refused(*args, **kwargs):
        raise refusal(what)
    return refused


def rank_report(runner) -> dict:
    """What one rank's process can say of itself: its pid and device, its
    runner's schedule counters, the attention kernels' launches in the
    process, the bytes of its weights and KV cache and, on the card, the
    bytes allocated in the process."""
    from smg_tpu_torch.ops.cuda import decode_attention, prefill_attention

    dev = runner.device
    return dict(rank=runner.groups.rank, pid=os.getpid(), device=str(dev),
                stats=dict(runner.stats),
                launches={"decode_attention": decode_attention.launches,
                          "prefill_attention": prefill_attention.launches},
                weight_bytes=sum(b.nbytes for b in runner.model.buffers()),
                kv_bytes=runner.k_cache.nbytes + runner.v_cache.nbytes,
                allocated_bytes=(torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                                 else None))


def _wire(obj):
    """A call's arguments as they travel: a chained token column becomes
    its launch number, any other tensor host memory."""
    if isinstance(obj, torch.Tensor):
        seq = getattr(obj, "_tp_seq", None)
        return _Chained(seq) if seq is not None else obj.detach().cpu()
    if isinstance(obj, tuple):
        return tuple(_wire(x) for x in obj)
    if isinstance(obj, list):
        return [_wire(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _wire(v) for k, v in obj.items()}
    return obj


def _unwire(obj, kept: dict):
    if isinstance(obj, _Chained):
        return kept[obj.seq]
    if isinstance(obj, tuple):
        return tuple(_unwire(x, kept) for x in obj)
    if isinstance(obj, list):
        return [_unwire(x, kept) for x in obj]
    if isinstance(obj, dict):
        return {k: _unwire(v, kept) for k, v in obj.items()}
    return obj


def start_ranks(config, params, devices: list, attention: str):
    """Start a rank-mesh engine's ranks: the store, a follower process for
    each rank but 0, then rank 0's own runner on ``devices[0]`` wrapped by
    its ``Leader``.  Every rank builds the grid of ``config.parallel``
    (``RankGroups``) and its shard of the weights: ``params`` (the whole
    model, CPU tensors, or None for weights from ``config.seed``) go to
    every rank, which keeps its part.  Returns (runner, leader)."""
    from smg_tpu_torch.engine.runner import ModelRunner

    world = len(devices)
    timeout = TP_TIMEOUT_S
    store = open_store(world, timeout)
    ctx = _rank_context()
    procs = []
    base = dict(port=store.port, devices=[str(d) for d in devices], config=config,
                params=params, attention=attention, timeout=timeout,
                threads=torch.get_num_threads(), parent=os.getpid())
    for rank in range(1, world):
        p = ctx.Process(target=follower_main, args=({**base, "rank": rank},),
                        name=f"smg-tp-rank{rank}", daemon=True)
        p.start()
        procs.append(p)
    try:
        _await_followers(store, procs, timeout)
        groups = RankGroups(store, 0, devices, timeout, sizes=config.parallel.axis_sizes())
        runner = ModelRunner(config, params=params, device=devices[0], attention=attention,
                             groups=groups)
    except BaseException:
        for p in procs:
            p.kill()
            p.join(5)
        dead = [f"{p.name} exit {p.exitcode}" for p in procs if p.exitcode]
        if dead:
            logger.error("rank processes failed at start: %s", dead)
        raise
    runner.tp_store = store  # the followers' rendezvous lives as long as the engine
    _tag_launches(runner)
    leader = Leader(runner, groups, procs, mirrored=MIRRORED, gathered={"report": rank_report},
                    local_when_broken=_LOCAL_WHEN_BROKEN)
    refused = dict(_REFUSED_RUNNER)
    if config.parallel.tp > 1:
        refused.update(load_lora="lora", unload_lora="lora")
    for name, what in refused.items():
        setattr(runner, name, _refuse(what))
    return runner, leader


def _await_followers(store, procs: list, timeout: float) -> None:
    """Wait until every follower reached the store; raise at once if one
    exited first (an import error, a device it cannot open)."""
    keys = [f"up{rank}" for rank in range(1, len(procs) + 1)]
    deadline = time.monotonic() + timeout
    while not store.check(keys):
        dead = [p for p in procs if p.exitcode is not None]
        if dead:
            raise RuntimeError(f"rank process {dead[0].name} exited with code "
                               f"{dead[0].exitcode} before joining the mesh")
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank processes did not start within {timeout} s")
        time.sleep(0.05)


#: what the fork server imports once, so each rank process it forks starts
#: with the port loaded
_PRELOAD = ["smg_tpu_torch.engine.runner", "smg_tpu_torch.parallel.leader"]


def _rank_context(preload: list | None = None):
    """The multiprocessing context rank processes start from: a fork server
    that imported the port once (``forkserver``, its modules preloaded:
    ``preload``, by default ``_PRELOAD``; the first caller in a process
    fixes them), so a rank process is forked from it in a fraction of a
    second instead of starting an interpreter and importing torch (several
    seconds a rank).  The fork server holds no CUDA context, so nothing is
    forked after CUDA initialised, as ``spawn`` guarantees too."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD if preload is None else preload)
    return ctx


def prestart(preload: list | None = None) -> None:
    """Start the rank processes' fork server now, ahead of the first
    rank-mesh engine (or training mesh, with its ``preload``): it imports
    the port while the caller does other work (nothing of it touches a
    device)."""
    from multiprocessing import forkserver

    _rank_context(preload)
    forkserver.ensure_running()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _watch_parent(parent: int) -> None:
    """Exit once the engine's process that started this rank is gone (the
    fork server, not the engine, is this process's parent)."""
    while True:
        time.sleep(1.0)
        if not _alive(parent):
            os._exit(3)


def follower_main(spec: dict) -> None:
    """A follower rank's process: join the groups, build the rank's runner,
    then run rank 0's calls until it says close (or stops pinging)."""
    from smg_tpu_torch.engine.runner import ModelRunner

    threading.Thread(target=_watch_parent, args=(spec["parent"],), daemon=True).start()
    torch.set_num_threads(spec["threads"])
    rank = spec["rank"]
    store = connect_store(spec["port"], len(spec["devices"]), spec["timeout"])
    store.set(f"up{rank}", "1")
    groups = RankGroups(store, rank, spec["devices"], spec["timeout"],
                        sizes=spec["config"].parallel.axis_sizes())
    runner = ModelRunner(spec["config"], params=spec["params"], device=groups.device,
                         attention=spec["attention"], groups=groups)
    del spec
    kept = _tag_launches(runner)
    follow(groups, runner, {"report": rank_report}, lambda a: _unwire(a, kept))
    groups.release_device()  # rank 0 frees its sum buffer once every peer unmapped it
    # straight out: the groups' native threads may not outlive their
    # destructors cleanly once a peer has gone
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
