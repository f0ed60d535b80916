"""Gossip node: SWIM-lite membership + CRDT anti-entropy over TCP — the
port's copy of ``smg_tpu/mesh/gossip.py``, on the same wire (a fleet of
port and reference gateways converges).

Reference: ``crates/mesh`` — SWIM-style gossip over a custom transport with
deferred start, partition detector (SURVEY.md §2.2).  Protocol here: every
``interval`` each node picks a random peer and exchanges (membership table,
CRDT snapshot) as one length-prefixed JSON frame; unreachable peers accrue
suspicion and are marked dead after ``suspect_after`` missed rounds.  DCN/
plain-TCP friendly — no multicast, no external deps.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from dataclasses import dataclass, field

from smg_tpu_torch.mesh.crdt import LwwMap
from smg_tpu_torch.utils import get_logger

logger = get_logger("mesh.gossip")


@dataclass
class GossipConfig:
    node_id: str = ""
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    seeds: list[str] = field(default_factory=list)  # "host:port"
    interval_secs: float = 1.0
    suspect_after: int = 3  # missed rounds before marking a peer dead
    # mutual TLS (reference: crates/mesh transport security): all three
    # paths set = every gossip connection is mTLS — the server REQUIRES a
    # client cert signed by ca_file, and dials verify the peer against it.
    # Unset = plaintext (single-trust-domain deployments).
    tls_cert_file: str | None = None
    tls_key_file: str | None = None
    tls_ca_file: str | None = None

    def __post_init__(self) -> None:
        tls = (self.tls_cert_file, self.tls_key_file, self.tls_ca_file)
        if any(tls) and not all(tls):
            # partial TLS config must FAIL, not silently run plaintext —
            # that's a security downgrade the operator would never see
            raise ValueError(
                "mesh mTLS needs all of tls_cert_file/tls_key_file/"
                f"tls_ca_file; got cert={bool(tls[0])} key={bool(tls[1])} "
                f"ca={bool(tls[2])}"
            )

    @property
    def tls_enabled(self) -> bool:
        return bool(self.tls_cert_file and self.tls_key_file and self.tls_ca_file)


@dataclass
class Member:
    node_id: str
    addr: str  # host:port
    incarnation: int = 0
    alive: bool = True
    last_seen: float = field(default_factory=time.monotonic)
    misses: int = 0


class GossipNode:
    def __init__(self, config: GossipConfig, state: LwwMap | None = None,
                 partition_config=None):
        from smg_tpu_torch.mesh.partition import PartitionDetector

        self.config = config
        self.node_id = config.node_id or f"node-{random.getrandbits(32):08x}"
        self.state = state or LwwMap(self.node_id)
        self.members: dict[str, Member] = {}
        self._server: asyncio.Server | None = None
        self._task: asyncio.Task | None = None
        self.addr = ""
        # partition classification over the membership view (reference:
        # crates/mesh/src/partition.rs); refreshed every gossip round
        self.partition = PartitionDetector(partition_config)

    # ---- lifecycle ----

    def _ssl_server(self):
        """Server SSL context, built once (contexts are shareable; per-dial
        rebuilds would re-read cert files on the event loop every round)."""
        if not self.config.tls_enabled:
            return None
        if getattr(self, "_server_ctx", None) is None:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.config.tls_cert_file, self.config.tls_key_file)
            ctx.load_verify_locations(self.config.tls_ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED  # mutual: peers present certs
            self._server_ctx = ctx
        return self._server_ctx

    def _ssl_client(self):
        if not self.config.tls_enabled:
            return None
        if getattr(self, "_client_ctx", None) is None:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.load_cert_chain(self.config.tls_cert_file, self.config.tls_key_file)
            ctx.load_verify_locations(self.config.tls_ca_file)
            # mesh peers are addressed by ip:port, not certificate
            # hostnames; trust is the shared CA, not the name
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_REQUIRED
            self._client_ctx = ctx
        return self._client_ctx

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.host, self.config.port,
            ssl=self._ssl_server(),
        )
        port = self._server.sockets[0].getsockname()[1]
        self.addr = f"{self.config.host}:{port}"
        self.members[self.node_id] = Member(self.node_id, self.addr)
        for seed in self.config.seeds:
            self.members.setdefault(
                f"seed@{seed}", Member(f"seed@{seed}", seed)
            )
        self._task = asyncio.get_running_loop().create_task(self._loop())
        logger.info("gossip node %s listening on %s", self.node_id, self.addr)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ---- wire ----

    def _payload(self) -> dict:
        # bump own incarnation every round: liveness proof that refutes any
        # stale death declaration (SWIM refutation)
        me = self.members[self.node_id]
        me.incarnation += 1
        return {
            "from": self.node_id,
            "addr": self.addr,
            "members": [
                {"node_id": m.node_id, "addr": m.addr, "incarnation": m.incarnation,
                 "alive": m.alive}
                for m in self.members.values()
                if not m.node_id.startswith("seed@")
            ],
            "state": self.state.snapshot(),
        }

    def _absorb(self, payload: dict) -> None:
        now = time.monotonic()
        sender = payload.get("from")
        for m in payload.get("members", []):
            if m["node_id"] == self.node_id:
                continue  # we are the authority on ourselves
            cur = self.members.get(m["node_id"])
            if cur is None:
                self.members[m["node_id"]] = Member(
                    m["node_id"], m["addr"], m["incarnation"], m["alive"], now
                )
            elif m["incarnation"] > cur.incarnation:
                # strictly newer incarnation: the node proved liveness since
                # our last information — accept everything, clear suspicion
                cur.incarnation = m["incarnation"]
                cur.addr = m["addr"]
                cur.alive = m["alive"]
                if m["alive"]:
                    cur.misses = 0
            elif m["incarnation"] == cur.incarnation and not m["alive"]:
                cur.alive = False  # death wins at equal incarnation
        if sender in self.members:
            self.members[sender].last_seen = now
            self.members[sender].alive = True
            self.members[sender].misses = 0
        self.state.merge([tuple(e) for e in payload.get("state", [])])

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            frame = await _read_frame(reader)
            if frame is not None:
                self._absorb(frame)
                await _write_frame(writer, self._payload())
        except Exception:
            logger.debug("gossip inbound failed", exc_info=True)
        finally:
            writer.close()

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_secs)
            try:
                await self._round()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("gossip round failed", exc_info=True)
            self.partition.detect(self)

    @property
    def has_quorum(self) -> bool:
        """False only in a detected minority partition — HA adapters use
        this to fence state-mutating sync (divergence bounded to the CRDT
        merge window instead of split-brain writes)."""
        return self.partition.has_quorum

    async def _round(self) -> None:
        peers = [
            m for m in self.members.values()
            if m.node_id != self.node_id and (m.alive or m.node_id.startswith("seed@"))
        ]
        if not peers:
            return
        peer = random.choice(peers)
        host, port = peer.addr.rsplit(":", 1)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port), ssl=self._ssl_client()),
                timeout=2.0,
            )
            await _write_frame(writer, self._payload())
            resp = await asyncio.wait_for(_read_frame(reader), timeout=2.0)
            writer.close()
            if resp is not None:
                self._absorb(resp)
            # a responding seed reveals its real node id; drop the placeholder
            if peer.node_id.startswith("seed@") and resp is not None:
                self.members.pop(peer.node_id, None)
        except (OSError, asyncio.TimeoutError):
            peer.misses += 1
            if peer.misses >= self.config.suspect_after and peer.alive:
                peer.alive = False
                logger.warning("gossip peer %s marked dead", peer.node_id)

    # ---- views ----

    def alive_members(self) -> list[Member]:
        return [m for m in self.members.values()
                if m.alive and not m.node_id.startswith("seed@")]


async def _read_frame(reader: asyncio.StreamReader) -> dict | None:
    header = await reader.readexactly(4)
    n = int.from_bytes(header, "big")
    if n > 64 * 1024 * 1024:
        raise ValueError("gossip frame too large")
    data = await reader.readexactly(n)
    return json.loads(data)


async def _write_frame(writer: asyncio.StreamWriter, payload: dict) -> None:
    data = json.dumps(payload).encode()
    writer.write(len(data).to_bytes(4, "big") + data)
    await writer.drain()
