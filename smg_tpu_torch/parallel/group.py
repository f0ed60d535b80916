"""Rank processes, the rank grid, its process groups and collectives of a
rank-mesh engine (tp, pp, sp and ep).  The reference has no counterpart:
GSPMD places its shards and inserts its collectives inside one process, over
a ``jax.sharding.Mesh`` whose axes it lays out in ``AXIS_ORDER``
(``smg_tpu/parallel/mesh.py``).

Every rank is a process with its own explicit device; rank 0 lives in the
engine's process and the followers fork from a fork server that holds no
CUDA context (``leader.py``), never from a process after CUDA has
initialised.  Ranks meet
at a ``TCPStore`` on a port the OS picks (port 0), so engines and test
workers side by side never collide on a fixed port.  The ranks lie on a
grid over ``AXIS_ORDER`` = (pp, dp, ep, sp, tp), the reference's order, tp
innermost: rank r's coordinates are r's digits in that mixed radix
(``rank_coords``).  Each rank joins, built from the store without
``init_process_group`` (no process-wide default group, so one process may
hold several engines):

- the **control** group of every rank, gloo over CPU tensors: rank 0
  broadcasts its runner calls on it (``send``/``recv``), and the ranks agree
  on the KV pages there (``min_int``);
- one **axis group** for each axis above 1 (``AxisGroup``, ``axis(name)``):
  the ranks that differ from this one along that axis alone, for the
  collectives inside the forward: tp's all-reduce and all-gather, pp's
  hand-off and broadcast, sp's ring exchange and gather, ep's all-reduce.
  The backend follows one rule (``device_backend``): ``nccl`` when every
  rank has a CUDA device of its own; ``gloo`` on the CPU, and when ranks
  share one CUDA device, which a caller asks for by passing a device list
  that repeats it (NCCL refuses two ranks of one communicator on one
  device).  Over gloo a CUDA tensor goes through host memory, so the
  collective waits for the device.

Every group has a ``timeout``: a collective or a receive that waits longer
raises, so no rank waits forever for a peer that died.

Ranks that share one CUDA device over gloo sum on the device
(``AxisGroup.all_reduce``, the serving forward's sums and the training
mesh's alike): each rank's buffer is mapped by the others through CUDA IPC
(``DeviceSum``), so a sum's data never goes through host memory or a
socket; its other collectives go through host memory."""

from __future__ import annotations

import datetime
import math
import pickle

import numpy as np
import torch
import torch.distributed as dist

#: default bound on any one collective, receive or rendezvous (seconds)
TP_TIMEOUT_S = 300.0
LOCALHOST = "127.0.0.1"


def device_backend(devices: list) -> str:
    """The device group's backend for ranks on ``devices``: ``nccl`` when
    every rank has a CUDA device of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def resolve_devices(parallel, devices=None) -> list[torch.device]:
    """One device per rank of ``parallel`` (a ``ParallelConfig``): the
    first ``world_size`` of ``devices``, or ``cuda:0 .. cuda:N-1`` when none
    are given.  Raises with the reference's wording when the machine (or
    the list) has fewer than the mesh needs; never falls back to the CPU or
    to fewer ranks."""
    world = parallel.world_size
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < world:
            raise RuntimeError(
                f"mesh {parallel.axis_sizes()} needs {world} devices, found {found}")
        return [torch.device("cuda", i) for i in range(world)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < world:
        raise RuntimeError(
            f"mesh {parallel.axis_sizes()} needs {world} devices, found {len(devs)}")
    devs = devs[:world]
    if any(d.type == "cuda" for d in devs):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = max((d.index or 0) for d in devs if d.type == "cuda") + 1
        if found < need:
            raise RuntimeError(
                f"mesh {parallel.axis_sizes()} needs {need} devices, found {found}")
        devs = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devs]
    return devs


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _gloo(store, prefix: str, rank: int, world: int, timeout: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = _timeout(timeout)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname=LOCALHOST)]
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, world, opts)


def _nccl(store, prefix: str, rank: int, world: int, timeout: float):
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = _timeout(timeout)
    return dist.ProcessGroupNCCL(dist.PrefixStore(prefix, store), rank, world, opts)


def open_store(world: int, timeout: float = TP_TIMEOUT_S) -> dist.TCPStore:
    """Rank 0's store on a free loopback port (``store.port``)."""
    return dist.TCPStore(LOCALHOST, 0, world, True, timeout=_timeout(timeout),
                         wait_for_workers=False)


def connect_store(port: int, world: int, timeout: float = TP_TIMEOUT_S) -> dist.TCPStore:
    return dist.TCPStore(LOCALHOST, port, world, False, timeout=_timeout(timeout))


#: the grid's axes, outermost first (the reference's ``mesh.py::AXIS_ORDER``)
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


def rank_coords(sizes: dict, rank: int) -> dict[str, int]:
    """Rank ``rank``'s index along each axis of a grid of ``sizes`` (axis ->
    size; absent axes are 1), laid out in ``AXIS_ORDER`` with tp
    innermost."""
    coords = {}
    for axis in reversed(AXIS_ORDER):
        n = sizes.get(axis, 1)
        coords[axis] = rank % n
        rank //= n
    return coords


def axis_members(sizes: dict, rank: int, axis: str) -> list[int]:
    """The ranks that differ from ``rank`` along ``axis`` alone, in axis
    order (index i holds the rank at coordinate i)."""
    stride = 1
    for a in reversed(AXIS_ORDER):
        if a == axis:
            break
        stride *= sizes.get(a, 1)
    here = rank_coords(sizes, rank)[axis]
    return [rank + (i - here) * stride for i in range(sizes.get(axis, 1))]


class AxisGroup:
    """One axis of the grid as this rank sees it: its index ``rank`` among
    the ``size`` ranks of the group (``members``, global ranks) and the
    collectives over them.  ``device`` is set when every member computes on
    that one CUDA device over gloo (a sum then goes through CUDA IPC)."""

    def __init__(self, name: str, pg, rank: int, members: list[int], backend: str,
                 device: torch.device | None = None):
        self.name = name
        self.pg = pg
        self.rank = rank
        self.size = len(members)
        self.members = members
        self.backend = backend
        self.device = device
        self._device_sum: DeviceSum | None = None

    def _host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def _shared(self, x: torch.Tensor) -> bool:
        return self.device is not None and x.device == self.device

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (every rank gets the same bits):
        on the device through CUDA IPC when every member shares ``x``'s card
        over gloo (``DeviceSum``), through host memory on another CUDA
        device over gloo, else in place."""
        if self._shared(x):
            if self._device_sum is None:
                self._device_sum = DeviceSum(self)
            return self._device_sum(x)
        if self._host(x):
            h = x.cpu()
            self.pg.allreduce([h]).wait()
            return h.to(x.device)
        x = x.contiguous()
        self.pg.allreduce([x]).wait()
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``all_reduce`` that leaves ``x`` as it is: a copy goes where the
        sum would be made in place."""
        if self._shared(x) or self._host(x):
            return self.all_reduce(x)
        return self.all_reduce(x.clone(memory_format=torch.contiguous_format))

    def barrier(self) -> None:
        self.pg.allreduce([torch.zeros(1)]).wait()

    def all_gather_objects(self, obj) -> list:
        """Every member's picklable ``obj``, in rank order (host memory)."""
        return _gather_objects(self.pg, self.size, obj)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, in rank order."""
        src = x.cpu() if self._host(x) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self.pg.allgather([parts], [src]).wait()
        return torch.cat(parts, dim=dim).to(x.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` of the group's rank ``src`` on every rank (a new tensor on
        the others; ``x`` is their buffer of its shape and dtype)."""
        buf = x.cpu() if self._host(x) else x.contiguous()
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        self.pg.broadcast([buf], opts).wait()
        return buf.to(x.device)

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Send ``x`` to the group's rank ``dst`` (returns once sent)."""
        self.pg.send([x.cpu() if self._host(x) else x.contiguous()], dst, 0).wait()

    def recv(self, buf: torch.Tensor, src: int) -> torch.Tensor:
        """The tensor the group's rank ``src`` sends, into ``buf``'s shape,
        dtype and device."""
        h = buf.cpu() if self._host(buf) else buf
        self.pg.recv([h], src, 0).wait()
        return h.to(buf.device)

    def exchange(self, out: list[torch.Tensor], dst: int, src: int) -> list[torch.Tensor]:
        """Send the tensors ``out`` to rank ``dst`` while receiving as many
        of the same shapes from rank ``src`` (a ring's step), all posted
        before any is waited on, as ``torch.distributed.batch_isend_irecv``
        posts them; that function needs a registered group, and these are
        built without a default one.  Even ranks post their sends first
        and odd ranks their receives, so a backend that runs point-to-point
        operations in order on one stream (NCCL between two ranks) never
        waits on a pair posted after it."""
        host = self._host(out[0])
        sends = [t.cpu() if host else t.contiguous() for t in out]
        bufs = [torch.empty_like(t) for t in sends]

        def post_sends():
            return [self.pg.send([t], dst, 0) for t in sends]

        def post_recvs():
            return [self.pg.recv([b], src, 0) for b in bufs]

        if self.rank % 2 == 0:
            works = post_sends() + post_recvs()
        else:
            works = post_recvs() + post_sends()
        for w in works:
            w.wait()
        dev = out[0].device
        return [b.to(dev) for b in bufs]


#: bytes of each member's buffer of a ``DeviceSum``: a larger sum goes
#: through in pieces of this size
DEVICE_SUM_BYTES = 64 << 20


class DeviceSum:
    """Sums over an ``AxisGroup`` whose members all compute on one CUDA
    device over gloo, without host memory: each member holds a buffer of
    ``DEVICE_SUM_BYTES`` that every other member maps through CUDA IPC
    (``torch.multiprocessing``'s handles, exchanged once over the group).
    A sum copies each member's piece into its own buffer, waits for the
    device and meets the others at a barrier; then every member adds the
    buffers in member order (the same bits on every rank) and meets them
    again before a buffer is written anew."""

    def __init__(self, group: AxisGroup):
        from torch.multiprocessing.reductions import reduce_tensor

        self.group = group
        self.buf = torch.empty(DEVICE_SUM_BYTES, dtype=torch.uint8, device=group.device)
        handles = group.all_gather_objects(reduce_tensor(self.buf)[1])
        self.bufs = [self.buf if i == group.rank else _open_ipc(h)
                     for i, h in enumerate(handles)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.contiguous().view(-1)
        out = torch.empty_like(flat)
        per = DEVICE_SUM_BYTES // flat.element_size()
        for a in range(0, flat.numel(), per):
            part = flat[a:a + per]
            views = [b[:part.nbytes].view(flat.dtype) for b in self.bufs]
            views[self.group.rank].copy_(part)
            torch.cuda.synchronize(self.group.device)
            self.group.barrier()
            acc = out[a:a + part.numel()]
            acc.copy_(views[0])
            for v in views[1:]:
                acc.add_(v)
            torch.cuda.synchronize(self.group.device)
            self.group.barrier()
        return out.view_as(x)


def _gather_objects(pg, size: int, obj) -> list:
    """Every member's picklable ``obj`` of the gloo group ``pg`` of ``size``
    members, in rank order, on every member."""
    data = torch.from_numpy(np.frombuffer(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8).copy())
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    pg.allgather([sizes], [torch.tensor([data.numel()])]).wait()
    n = max(int(t[0]) for t in sizes)
    padded = torch.zeros(n, dtype=torch.uint8)
    padded[:data.numel()] = data
    bufs = [torch.empty(n, dtype=torch.uint8) for _ in range(size)]
    pg.allgather([bufs], [padded]).wait()
    return [pickle.loads(b[:int(k[0])].numpy().tobytes()) for b, k in zip(bufs, sizes)]


def _open_ipc(args: tuple) -> torch.Tensor:
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    return rebuild_cuda_tensor(*args)


class RankGroups:
    """One rank's view of the mesh: its rank, the world size, its device,
    its coordinates on the grid (``coords``), the control group, an
    ``AxisGroup`` for each axis above 1 (``axes``) and the collectives the
    model and the leader use.  ``sizes`` (axis -> size) defaults to a tp
    grid of every rank.  ``all_reduce``/``all_gather`` act over the tp
    group (the whole world when tp is the only axis).  ``ranks_on_device``
    counts the ranks that share this rank's device (its share of the free
    memory)."""

    def __init__(self, store, rank: int, devices: list, timeout: float = TP_TIMEOUT_S,
                 sizes: dict | None = None):
        devs = [torch.device(d) for d in devices]
        self.rank = rank
        self.world = len(devs)
        self.devices = devs
        self.device = devs[rank]
        self.timeout = timeout
        self.sizes = {a: n for a, n in (sizes or {"tp": self.world}).items() if n > 1}
        if math.prod(self.sizes.values()) != self.world:
            raise ValueError(f"grid {self.sizes} does not hold {self.world} ranks")
        self.coords = rank_coords(self.sizes, rank)
        self.backend = device_backend(devs)
        self.ranks_on_device = sum(d == self.device for d in devs)
        self.control = _gloo(store, "control", rank, self.world, timeout)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        self.axes: dict[str, AxisGroup] = {}
        for axis in AXIS_ORDER:  # every rank builds its groups in one order
            if axis not in self.sizes:
                continue
            members = axis_members(self.sizes, rank, axis)
            prefix = f"device/{axis}/{members[0]}"
            make = _nccl if self.backend == "nccl" else _gloo
            pg = make(store, prefix, self.coords[axis], len(members), timeout)
            shared = (self.backend == "gloo" and self.device.type == "cuda"
                      and all(devs[m] == self.device for m in members))
            self.axes[axis] = AxisGroup(axis, pg, self.coords[axis], members, self.backend,
                                        self.device if shared else None)

    def axis(self, name: str) -> AxisGroup | None:
        """This rank's group along ``name`` (None when the axis is 1)."""
        return self.axes.get(name)

    # ---- collectives inside the forward (the tp group) ----

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the tp group."""
        return self.axes["tp"].all_reduce(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The tp group's ``x`` concatenated along the last axis, in rank
        order."""
        return self.axes["tp"].all_gather(x)

    # ---- the control group ----

    def barrier(self) -> None:
        self.control.allreduce([torch.zeros(1)]).wait()

    def min_int(self, n: int) -> int:
        """The least of every rank's ``n``."""
        t = torch.tensor([n], dtype=torch.int64)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN
        self.control.allreduce([t], opts).wait()
        return int(t[0])

    def _bcast(self, t: torch.Tensor) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self.control.broadcast([t], opts).wait()

    def send(self, obj) -> None:
        """Rank 0: broadcast one picklable object to every other rank."""
        data = np.frombuffer(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8)
        self._bcast(torch.tensor([data.size], dtype=torch.int64))
        self._bcast(torch.from_numpy(data.copy()))

    def recv(self):
        """A follower: the next object rank 0 sent (raises after
        ``timeout`` without one)."""
        n = torch.zeros(1, dtype=torch.int64)
        self._bcast(n)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._bcast(buf)
        return pickle.loads(buf.numpy().tobytes())

    def gather(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        return _gather_objects(self.control, self.world, obj)

    def release_device(self) -> None:
        """Drop the groups' ``DeviceSum`` buffers: unmap the peers' and, once
        the peers unmapped this rank's, give its own back to the card."""
        held = [g for g in self.axes.values() if g._device_sum is not None]
        for g in held:
            g._device_sum = None
        if held:
            torch.cuda.ipc_collect()

    def shutdown(self) -> None:
        self.release_device()
        for pg in [g.pg for g in self.axes.values()] + [self.control]:
            try:
                pg.shutdown()
            except Exception:  # noqa: BLE001 - a group already broken by a dead peer
                pass
