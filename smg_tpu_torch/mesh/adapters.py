"""Gateway <-> mesh bridges — the port's copy of ``smg_tpu/mesh/adapters.py``
(remote workers are the port's ``GrpcWorkerClient``s).

Reference: ``model_gateway/src/mesh/adapters/`` — ``worker_sync`` (worker
CRDT namespace) and ``tree_sync`` (prefix-tree deltas) (SURVEY.md §2.1, §3.5).

``WorkerSyncAdapter`` replicates worker registrations between gateway peers:
local registry changes publish into the CRDT; merged remote entries register
gRPC workers locally (so every gateway can route to every worker without a
shared control plane).
"""

from __future__ import annotations

from smg_tpu_torch.mesh.crdt import LwwMap
from smg_tpu_torch.utils import get_logger

logger = get_logger("mesh.adapters")

WORKER_NS = "worker/"


class WorkerSyncAdapter:
    def __init__(self, registry, state: LwwMap, client_factory=None):
        self.registry = registry
        self.state = state
        self._client_factory = client_factory or self._default_factory
        self._remote: set[str] = set()  # worker ids created from mesh state
        registry.on_change(self._on_local_change)
        state.on_change(self._on_state_change)
        # publish pre-existing local workers
        for w in registry.list():
            self._publish(w)

    @staticmethod
    def _default_factory(url: str):
        from smg_tpu_torch.rpc.client import GrpcWorkerClient

        return GrpcWorkerClient(url)

    # ---- local -> mesh ----

    def _publish(self, worker) -> None:
        if worker.worker_id in self._remote or not worker.url:
            return
        self.state.set(
            WORKER_NS + worker.worker_id,
            {
                "url": worker.url,
                "model_id": worker.model_id,
                "type": worker.worker_type.value,
            },
        )

    def _on_local_change(self, event: str, worker) -> None:
        if worker.worker_id in self._remote:
            return  # don't re-publish entries that came from the mesh
        if event == "added":
            self._publish(worker)
        elif event == "removed":
            self.state.delete(WORKER_NS + worker.worker_id)

    # ---- mesh -> local ----

    def _on_state_change(self, key: str, value, deleted: bool) -> None:
        if not key.startswith(WORKER_NS):
            return
        wid = key[len(WORKER_NS):]
        if deleted:
            if wid in self._remote:
                self._remote.discard(wid)
                worker = self.registry.remove(wid)
                if worker is not None:
                    logger.info("mesh: removed remote worker %s", wid)
            return
        if self.registry.get(wid) is not None:
            return  # already known (local or previously synced)
        from smg_tpu_torch.gateway.workers import Worker, WorkerType

        try:
            wtype = WorkerType(value.get("type", "regular"))
        except ValueError:
            wtype = WorkerType.REGULAR
        client = self._client_factory(value["url"])
        self._remote.add(wid)
        self.registry.add(
            Worker(
                worker_id=wid, client=client, model_id=value.get("model_id", "default"),
                worker_type=wtype, url=value["url"],
            )
        )
        logger.info("mesh: registered remote worker %s (%s)", wid, value["url"])


TREE_NS = "tree/"
_MAX_SYNC_TOKENS = 256  # bound gossip payloads; long prefixes truncate


class TreeSyncAdapter:
    """Replicates cache_aware routed-prefix inserts between gateway peers.

    Reference: ``mesh/adapters/tree_sync.rs`` — ``td:{model}`` gossip stream
    carrying prefix-tree deltas so every peer's approximate tree knows which
    worker holds which prefix, keeping cache-aware routing sticky across a
    gateway fleet.  CRDT key = ``tree/{model}/{prefix-hash}``; value carries
    the (bounded) sequence + worker attribution; LWW merge resolves races the
    same way the local tree does (last router wins).

    Policies are created lazily per model, so the adapter registers a
    creation hook on the PolicyRegistry instead of snapshotting; on creation
    it also replays any tree state already gossiped for that model.  Gossip
    for models this gateway does not serve is ignored (no policy is
    materialized for it)."""

    def __init__(self, policies, state: LwwMap, max_entries: int = 4096):
        self.policies = policies
        self.state = state
        self._applying_remote = False
        self._publishing = False
        # bound locally-published entries (LRU): the radix tree evicts, so
        # mesh state must too — evictions tombstone the CRDT key and
        # replicate as deletes to peers
        from collections import OrderedDict

        self._published: OrderedDict[str, None] = OrderedDict()
        self._max_entries = max_entries
        # origin tag baked into every key this gateway publishes: two
        # gateways caching the same prefix publish under DIFFERENT keys, so
        # a local LRU eviction's replicated tombstone can only ever remove
        # our own entries, never a peer's still-valid one
        import hashlib as _hl

        self._origin = _hl.blake2b(
            str(getattr(state, "node_id", "")).encode(), digest_size=4
        ).hexdigest()
        state.on_change(self._on_state_change)
        policies.add_create_hook(self._on_policy_created)

    def _on_policy_created(self, model_id: str | None, policy) -> None:
        from smg_tpu_torch.policies.cache_aware import CacheAwarePolicy

        if not isinstance(policy, CacheAwarePolicy):
            return
        key_model = model_id or "__default__"
        policy.add_insert_hook(
            lambda seq, wid, m=key_model: self._publish(m, seq, wid)
        )
        # replay tree state peers gossiped before this policy existed
        prefix = f"{TREE_NS}{key_model}/"
        for key, value in self.state.items().items():
            if key.startswith(prefix):
                self._apply(policy, value)

    # ---- local -> mesh ----

    def _publish(self, model: str, seq, worker_id: str) -> None:
        if self._applying_remote:
            return
        import hashlib

        if isinstance(seq, str):
            payload, kind = seq[: _MAX_SYNC_TOKENS * 4], "str"
        else:
            payload, kind = list(seq)[:_MAX_SYNC_TOKENS], "tokens"
        digest = hashlib.blake2b(
            repr(payload).encode(), digest_size=12
        ).hexdigest()
        # LwwMap.set notifies local listeners synchronously: the flag stops
        # the publish from echoing back into apply on the routing hot path.
        # Key carries the origin tag (see __init__) so evictions are local.
        key = f"{TREE_NS}{model}/{digest}.{self._origin}"
        self._publishing = True
        try:
            self.state.set(
                key, {"kind": kind, "seq": payload, "worker": worker_id}
            )
            self._published[key] = None
            self._published.move_to_end(key)
            while len(self._published) > self._max_entries:
                old, _ = self._published.popitem(last=False)
                self.state.delete(old)
        finally:
            self._publishing = False

    # ---- mesh -> local ----

    def _on_state_change(self, key: str, value, deleted: bool) -> None:
        if self._publishing:
            return  # our own set() echoing back
        if not key.startswith(TREE_NS) or deleted or not isinstance(value, dict):
            return
        model = key[len(TREE_NS):].rsplit("/", 1)[0]
        model_id = None if model == "__default__" else model
        # only mirror into models this gateway actually serves — peers may
        # gossip trees for models we have no policy (or workers) for
        if not self.policies.has_policy(model_id):
            return
        self._apply(self.policies.policy_for(model_id), value)

    def _apply(self, policy, value: dict) -> None:
        from smg_tpu_torch.policies.cache_aware import CacheAwarePolicy

        if not isinstance(policy, CacheAwarePolicy) or not isinstance(value, dict):
            return
        seq = value.get("seq")
        if value.get("kind") == "tokens" and isinstance(seq, list):
            seq = [int(t) for t in seq]
        self._applying_remote = True
        try:
            policy.apply_remote_insert(seq, value.get("worker", ""))
        finally:
            self._applying_remote = False
