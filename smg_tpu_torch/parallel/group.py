"""Rank processes, process groups and collectives of a tensor-parallel
engine.  The reference has no counterpart: GSPMD places its shards and
inserts its collectives inside one process.

Every rank is a process with its own explicit device; rank 0 lives in the
engine's process and the followers are started with the ``spawn`` method
(``leader.py``), never by ``fork`` after CUDA has initialised.  Ranks meet
at a ``TCPStore`` on a port the OS picks (port 0), so engines and test
workers side by side never collide on a fixed port.  Each rank joins two
groups, built from the store without ``init_process_group`` (no process-wide
default group, so one process may hold several engines):

- the **control** group, gloo over CPU tensors: rank 0 broadcasts its
  runner calls on it (``send``/``recv``), and the ranks agree on the KV
  pages there (``min_int``);
- the **device** group, for the collectives inside the forward
  (``all_reduce``, ``all_gather``).  Its backend follows one rule
  (``device_backend``): ``nccl`` when every rank has a CUDA device of its
  own; ``gloo`` on the CPU, and when ranks share one CUDA device, which a
  caller asks for by passing a device list that repeats it (NCCL refuses
  two ranks of one communicator on one device).  Over gloo a CUDA tensor
  goes through host memory, so the collective waits for the device.

Every group has a ``timeout``: a collective or a receive that waits longer
raises, so no rank waits forever for a peer that died."""

from __future__ import annotations

import datetime
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


class RankGroups:
    """One rank's view of the mesh: its rank, the world size, its device,
    the two process groups and the collectives the model and the leader
    use.  ``ranks_on_device`` counts the ranks that share this rank's
    device (its share of the free memory)."""

    def __init__(self, store, rank: int, devices: list, timeout: float = TP_TIMEOUT_S):
        devs = [torch.device(d) for d in devices]
        self.rank = rank
        self.world = len(devs)
        self.devices = devs
        self.device = devs[rank]
        self.timeout = timeout
        self.backend = device_backend(devs)
        self.ranks_on_device = sum(d == self.device for d in devs)
        self.control = _gloo(store, "control", rank, self.world, timeout)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            self.group = _nccl(store, "device", rank, self.world, timeout)
        else:
            self.group = _gloo(store, "device", rank, self.world, timeout)

    # ---- collectives inside the forward (the device group) ----

    def _host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (every rank gets the same bits)."""
        if self._host(x):
            h = x.cpu()
            self.group.allreduce([h]).wait()
            return h.to(x.device)
        x = x.contiguous()
        self.group.allreduce([x]).wait()
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along the last axis, in rank order."""
        src = x.cpu() if self._host(x) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        self.group.allgather([parts], [src]).wait()
        return torch.cat(parts, dim=-1).to(x.device)

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
        data = torch.from_numpy(np.frombuffer(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8).copy())
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        self.control.allgather([sizes], [torch.tensor([data.numel()])]).wait()
        n = max(int(t[0]) for t in sizes)
        padded = torch.zeros(n, dtype=torch.uint8)
        padded[:data.numel()] = data
        bufs = [torch.empty(n, dtype=torch.uint8) for _ in range(self.world)]
        self.control.allgather([bufs], [padded]).wait()
        return [pickle.loads(b[:int(k[0])].numpy().tobytes()) for b, k in zip(bufs, sizes)]

    def shutdown(self) -> None:
        for pg in (self.group, self.control):
            try:
                pg.shutdown()
            except Exception:  # noqa: BLE001 - a group already broken by a dead peer
                pass
