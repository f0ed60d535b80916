"""Same-host device-to-device KV transfer (PD disaggregation leg 3) — the
port's copy of ``smg_tpu/engine/kv_transfer.py``.

The reference moves prompt KV between a prefill and a decode worker process
with ``jax.experimental.transfer``: the prefill side *offers* the gathered
KV arrays under a uuid, the decode side *pulls* them into its own device
memory.  Only (address, uuid, shape, dtype) ride the gRPC control channel;
the bulk bytes never pass through the gRPC process boundary.  PyTorch has no
such transport, so the port brings its own, with the same API and
lifecycle:

- each manager runs a small pull server on ``SMG_TRANSFER_BIND`` (default
  ``127.0.0.1:0``); its address carries the ``smgkv://`` scheme, so a
  reference worker handed a port offer (or the reverse) fails at once
  instead of dialling the wrong protocol;
- a pull sends the uuid; the server answers with a handle to the offered
  tensors; the puller copies them into its own memory and then says
  "done", and only then does the offer's storage become free to drop (the
  offer is one-shot: a second pull of it fails).  The server takes "done"
  only for the uuid that the same connection just pulled, and uuids are
  random 63-bit numbers, so a peer cannot drop or guess another's offer;
- a CUDA payload's handle is a CUDA IPC handle
  (``torch.multiprocessing.reductions.reduce_tensor``, which carries the
  storage's offset inside the caching allocator's block and keeps the block
  from being handed out while a peer maps it); the puller copies device to
  device.  A CUDA payload goes by IPC or the pull raises: it never goes
  through the host;
- a CPU payload (the CPU engine's own memory) goes through a named
  ``multiprocessing.shared_memory`` block the server makes for the pull
  and unlinks when the puller is done (Linux: the puller reads it as its
  ``/dev/shm`` file);
- a pull of an offer made in this process (a manager's own address, two
  engines in one process) copies from the offer itself without dialling:
  an IPC handle cannot be opened in the process that made it.

Divergences from the reference: CUDA IPC does not cross hosts (the
reference's transfer server does, over DCN), and ``reclaim`` drops the offer
where the reference self-pulls it (its transfer API cannot cancel an offer).
"""

from __future__ import annotations

import base64
import json
import os
import secrets
import socket
import threading
import time
import weakref

import torch

from smg_tpu_torch.utils import get_logger

logger = get_logger("engine.kv_transfer")

SCHEME = "smgkv://"

#: managers of this process by address: a pull from one of them copies from
#: the offer itself (an IPC handle cannot be opened where it was made)
_LOCAL: "weakref.WeakValueDictionary[str, TransferManager]" = weakref.WeakValueDictionary()


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown KV dtype {name!r}")
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _send(sock: socket.socket, payload: dict) -> None:
    data = json.dumps(payload).encode()
    sock.sendall(len(data).to_bytes(4, "big") + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kv transfer peer closed the connection")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket) -> dict:
    n = int.from_bytes(_recv_exact(sock, 4), "big")
    if n > 64 * 1024 * 1024:
        raise ValueError("kv transfer frame too large")
    return json.loads(_recv_exact(sock, n))


def _cuda_handle(t: torch.Tensor) -> dict:
    """JSON form of ``reduce_tensor``'s rebuild arguments for a CUDA tensor."""
    from torch.multiprocessing.reductions import reduce_tensor

    _, args = reduce_tensor(t)
    (_, size, stride, offset, _, dtype, device, handle, size_bytes, offset_bytes,
     _, rc_handle, rc_offset, ev_handle, ev_sync) = args
    b64 = lambda b: base64.b64encode(b).decode() if b is not None else None  # noqa: E731
    return {"size": list(size), "stride": list(stride), "offset": offset,
            "dtype": _dtype_name(dtype), "device": device, "handle": b64(handle),
            "size_bytes": size_bytes, "offset_bytes": offset_bytes,
            "rc_handle": b64(rc_handle), "rc_offset": rc_offset,
            "ev_handle": b64(ev_handle), "ev_sync": ev_sync}


def _open_cuda(h: dict) -> torch.Tensor:
    """Map a peer's CUDA tensor from its IPC handle (valid until the
    returned tensor is dropped)."""
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    unb64 = lambda s: base64.b64decode(s) if s is not None else None  # noqa: E731
    return rebuild_cuda_tensor(
        torch.Tensor, torch.Size(h["size"]), tuple(h["stride"]), h["offset"],
        torch.UntypedStorage, _dtype(h["dtype"]), h["device"], unb64(h["handle"]),
        h["size_bytes"], h["offset_bytes"], False, unb64(h["rc_handle"]),
        h["rc_offset"], unb64(h["ev_handle"]), h["ev_sync"])


def _wait_ready(t: torch.Tensor) -> None:
    """Order the current stream after an export's ``ready`` event."""
    ready = getattr(t, "ready", None)
    if ready is not None:
        torch.cuda.current_stream(t.device).wait_event(ready)


def _read_shm(h: dict) -> torch.Tensor:
    """A CPU tensor read from a peer's shared memory block.  The block is
    read as its ``/dev/shm`` file, not attached as a ``SharedMemory``: an
    attach would register the block with this process's resource tracker,
    which unlinks it at exit, and the server alone owns the block."""
    out = torch.empty(h["size"], dtype=_dtype(h["dtype"]))
    buf = memoryview(out.view(-1).view(torch.uint8).numpy())
    fd = os.open("/dev/shm/" + h["name"].lstrip("/"), os.O_RDONLY)
    try:
        got = 0
        while got < len(buf):
            n = os.preadv(fd, [buf[got:]], got)
            if n <= 0:
                raise RuntimeError(f"kv offer block {h['name']} is short")
            got += n
    finally:
        os.close(fd)
    return out


class _Connection:
    """One cached connection to a peer's pull server (pulls on it run one
    at a time)."""

    def __init__(self, address: str, timeout: float):
        host, port = address.removeprefix(SCHEME).rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self.sock.settimeout(timeout)
        self.lock = threading.Lock()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class TransferManager:
    """One per engine: lazy pull server + uuid allocation + pull client.

    Bind address comes from ``SMG_TRANSFER_BIND`` (default ``127.0.0.1:0``).
    CUDA IPC reaches the processes of this host only, so a routable bind
    address does not make the transfer cross hosts."""

    #: seconds an un-pulled offer may live before being reclaimed
    OFFER_TTL = 120.0
    #: cached connections to remote pull servers (LRU-evicted beyond)
    MAX_CONNECTIONS = 32
    #: seconds a pull may wait on its peer (connect, answer, done)
    PULL_TIMEOUT = 30.0

    def __init__(self, device):
        self._device = torch.device(device)
        self._listener: socket.socket | None = None
        self._address: str | None = None
        self._lock = threading.RLock()
        # insertion order doubles as LRU order (moved on hit)
        self._connections: dict[str, _Connection] = {}
        # uuid -> [deadline, tensors]: tracked until mark_consumed, reclaim
        # or the TTL reap; the tensors go (None) once a pull is done
        self._offers: dict[int, list] = {}
        # offers made, pulls this server finished serving, pulls this
        # manager made, offers reclaimed (the TTL reap included)
        self.counts = dict(offered=0, served=0, pulled=0, reclaimed=0)

    # ---- the pull server ----

    @property
    def address(self) -> str:
        with self._lock:
            if self._listener is None:
                bind = os.environ.get("SMG_TRANSFER_BIND", "127.0.0.1:0")
                host, port = bind.rsplit(":", 1)
                sock = socket.create_server((host, int(port)))
                self._listener = sock
                self._address = f"{SCHEME}{host}:{sock.getsockname()[1]}"
                _LOCAL[self._address] = self
                threading.Thread(target=self._accept, args=(sock,), daemon=True,
                                 name="kv-transfer-server").start()
                logger.info("kv transfer server on %s", self._address)
            return self._address

    def _accept(self, sock: socket.socket) -> None:
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="kv-transfer-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        """One peer's pulls, one at a time: answer a pull with handles to the
        offer's tensors, then drop them when the peer says done (taken only
        for the uuid this connection just pulled)."""
        shms: list = []
        pulled = None
        try:
            while True:
                msg = _recv(conn)
                uuid = int(msg.get("uuid", 0))
                if msg.get("op") == "done":
                    if uuid != pulled:
                        _send(conn, {"ok": False, "error": f"kv offer {uuid} not pulled here"})
                        continue
                    pulled = tensors = None  # the peer has its copy
                    self._take(uuid)
                    for shm in shms:
                        shm.close()
                        shm.unlink()
                    shms.clear()
                    _send(conn, {"ok": True})
                    continue
                tensors = self._tensors(uuid)
                if tensors is None:
                    _send(conn, {"ok": False, "error": f"no kv offer {uuid}"})
                    continue
                try:
                    if tensors[0].device.type == "cuda":
                        answer = {"kind": "cuda", "tensors": [_cuda_handle(t) for t in tensors]}
                    else:
                        answer = {"kind": "shm", "tensors": [self._shm_copy(t, shms)
                                                             for t in tensors]}
                except Exception as e:  # noqa: BLE001 — the puller raises it
                    logger.exception("kv offer %d: handle failed", uuid)
                    _send(conn, {"ok": False, "error": f"{type(e).__name__}: {e}"})
                    continue
                pulled = uuid
                _send(conn, {"ok": True, **answer})
        except (ConnectionError, OSError, ValueError):
            pass  # the peer went away, or sent no frame of this protocol
        finally:
            for shm in shms:
                shm.close()
                shm.unlink()
            conn.close()

    @staticmethod
    def _shm_copy(t: torch.Tensor, shms: list) -> dict:
        from multiprocessing import shared_memory

        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        shm = shared_memory.SharedMemory(create=True, size=max(nbytes, 1))
        shms.append(shm)
        if nbytes:
            dst = torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes)
            dst.copy_(t.view(-1).view(torch.uint8))
            del dst  # the block closes only without exported views
        return {"name": shm.name, "size": list(t.shape), "dtype": _dtype_name(t.dtype)}

    def close(self) -> None:
        """Stop the pull server and drop every offer and connection."""
        with self._lock:
            if self._listener is not None:
                _LOCAL.pop(self._address, None)
                self._listener.close()
                self._listener = None
            for c in self._connections.values():
                c.close()
            self._connections.clear()
            self._offers.clear()

    # ---- the offer lifecycle ----

    def _tensors(self, uuid: int) -> list | None:
        with self._lock:
            entry = self._offers.get(uuid)
            return None if entry is None else entry[1]

    def _take(self, uuid: int) -> list | None:
        """A pull of ``uuid`` is served: hand its tensors over once and stop
        holding them (the offer stays tracked until it is signalled)."""
        with self._lock:
            entry = self._offers.get(uuid)
            if entry is None or entry[1] is None:
                return None
            tensors, entry[1] = entry[1], None
            self.counts["served"] += 1
            return tensors

    def held(self) -> list[int]:
        """The uuids whose tensors are still held (offered, not yet pulled
        or dropped)."""
        with self._lock:
            return sorted(u for u, (_, t) in self._offers.items() if t is not None)

    def offer(self, arrays: list) -> int:
        """Register tensors for a one-shot pull; returns the uuid.

        The offer keeps its tensors (and so their memory) until a pull is
        done with them, or until the decode outcome is signalled back
        (``mark_consumed`` on success, ``reclaim`` on failure).  A TTL reap
        backstops requests whose router died before signalling either way."""
        self._reap()
        _ = self.address  # the server is up before the uuid leaves
        with self._lock:
            uuid = 0
            while uuid == 0 or uuid in self._offers:
                uuid = secrets.randbits(63)
            self._offers[uuid] = [time.monotonic() + self.OFFER_TTL, list(arrays)]
            self.counts["offered"] += 1
        return uuid

    def mark_consumed(self, uuid: int) -> bool:
        """The decode leg pulled this offer — stop tracking it."""
        with self._lock:
            return self._offers.pop(uuid, None) is not None

    def reclaim(self, uuid: int) -> bool:
        """The decode leg failed before pulling: drop the offer, which frees
        its tensors (the reference self-pulls, as its transfer API has no
        cancel).  A pull already under way keeps the memory it mapped until
        it is done."""
        with self._lock:
            entry = self._offers.pop(uuid, None)
            if entry is not None:
                self.counts["reclaimed"] += 1
        if entry is None:
            return False
        logger.info("reclaimed abandoned kv offer %d", uuid)
        return True

    def _reap(self) -> None:
        """TTL backstop for offers that were never signalled (router died
        between the PD legs)."""
        now = time.monotonic()
        with self._lock:
            expired = [u for u, (dl, _) in self._offers.items() if dl < now]
        for u in expired:
            logger.warning("kv offer %d expired without signal; reclaiming", u)
            self.reclaim(u)

    # ---- the pull client ----

    def _connection(self, address: str) -> _Connection:
        with self._lock:
            conn = self._connections.pop(address, None)
            if conn is None:
                conn = _Connection(address, self.PULL_TIMEOUT)
            self._connections[address] = conn  # re-insert = LRU touch
            while len(self._connections) > self.MAX_CONNECTIONS:
                old_addr = next(iter(self._connections))
                self._connections.pop(old_addr).close()
                logger.info("evicted cached kv connection to %s", old_addr)
            return conn

    def pull(self, address: str, uuid: int, shapes_dtypes: list) -> list:
        """Pull tensors offered by a TransferManager into this manager's
        device memory.  ``shapes_dtypes``: [(shape, dtype name), ...]."""
        if not address.startswith(SCHEME):
            raise ValueError(f"kv transfer address {address!r} is not a {SCHEME} pull "
                             "server (a reference worker's offer?)")
        uuid = int(uuid)
        peer = _LOCAL.get(address)
        src = peer._take(uuid) if peer is not None else None
        if src is not None:  # made in this process: copy from the offer itself
            out = self._land_local(src)
        else:
            out = self._pull_remote(address, uuid)
        with self._lock:
            self.counts["pulled"] += 1
        want = [(tuple(s), _dtype(str(d))) for s, d in shapes_dtypes]
        got = [(tuple(t.shape), t.dtype) for t in out]
        if got != want:
            raise ValueError(f"kv pull of {uuid}: got {got}, want {want}")
        return out

    def _pull_remote(self, address: str, uuid: int) -> list:
        conn = self._connection(address)
        try:
            with conn.lock:
                _send(conn.sock, {"op": "pull", "uuid": uuid})
                answer = _recv(conn.sock)
                if not answer.get("ok"):
                    raise RuntimeError(f"kv pull of {uuid} from {address}: {answer.get('error')}")
                out = self._land(answer)
                _send(conn.sock, {"op": "done", "uuid": uuid})
                _recv(conn.sock)
        except Exception:
            # a failed pull usually means the peer is gone — drop the
            # cached connection so the next call re-dials
            with self._lock:
                if self._connections.get(address) is conn:
                    del self._connections[address]
            conn.close()
            raise
        return out

    def _land_local(self, src: list) -> list:
        """Copies of an offer of this process on this device, finished when
        this returns."""
        for t in src:
            if t.device.type == "cuda":
                _wait_ready(t)
        out = [t.to(self._device, copy=True) for t in src]
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        return out

    def _land(self, answer: dict) -> list:
        """Copy the answered tensors into fresh tensors on this device; every
        copy has finished when this returns (the peer frees the offer on
        "done")."""
        dev = self._device
        if answer["kind"] == "cuda":
            if dev.type != "cuda":
                raise RuntimeError(f"a CUDA kv offer cannot land on {dev}")
            out = []
            for h in answer["tensors"]:
                peer_t = _open_cuda(h)
                dst = torch.empty(peer_t.shape, dtype=peer_t.dtype, device=dev)
                dst.copy_(peer_t)
                out.append(dst)
                del peer_t
        else:
            out = [_read_shm(h).to(dev) for h in answer["tensors"]]
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return out
