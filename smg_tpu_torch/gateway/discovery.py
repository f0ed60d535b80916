"""Kubernetes service discovery — the port's copy of
``smg_tpu/gateway/discovery.py``: a pod watch feeding the worker registry.

Reference: ``model_gateway/src/service_discovery.rs``: a pod watch with
per-role selectors (regular/prefill/decode), ``model_id`` from pod
metadata, bootstrap-port annotations.

Implementation: poll the Kubernetes API with the in-cluster service-account
token (aiohttp; no client library).  The ``KubeApi`` seam is injectable,
so tests run against a fake API and deployments outside Kubernetes never
touch it.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass, field

from smg_tpu_torch.gateway.workers import Worker, WorkerRegistry, WorkerType
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.discovery")

ROLE_LABEL = "smg.ai/role"  # regular | prefill | decode
MODEL_ANNOTATION = "smg.ai/model-id"
PORT_ANNOTATION = "smg.ai/grpc-port"


@dataclass
class DiscoveryConfig:
    namespace: str = "default"
    selector: str = "app=smg-worker"
    poll_interval_secs: float = 10.0
    default_port: int = 30001
    # role for pods WITHOUT a smg.ai/role label (per-role selector groups:
    # --prefill-selector pods default to prefill without labelling)
    default_role: str = "regular"


class KubeApi:
    """Minimal in-cluster pod listing (injectable for tests)."""

    NAMESPACE_FILE = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"

    def __init__(self, namespace: str | None = None):
        if namespace is None:
            try:
                with open(self.NAMESPACE_FILE) as f:
                    namespace = f.read().strip()
            except OSError:
                namespace = "default"
        self.namespace = namespace
        self.host = os.environ.get("KUBERNETES_SERVICE_HOST")
        self.port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self._token = None
        self._session = None

    @property
    def available(self) -> bool:
        return self.host is not None

    async def list_pods(self, selector: str) -> list[dict]:
        import aiohttp

        # session init stays BEFORE the first await: the check-then-create
        # must run in one synchronous segment, or two concurrent first calls
        # would both construct a ClientSession and leak one
        if self._session is None:
            self._session = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(ssl=False)
            )
        if self._token is None:
            # the service-account token is read on a worker thread: list_pods
            # runs on the gateway loop, and a slow volume mount must not
            # stall in-flight streams
            def _read_token() -> str:
                with open("/var/run/secrets/kubernetes.io/serviceaccount/token") as f:
                    return f.read().strip()

            self._token = await asyncio.to_thread(_read_token)
        url = (
            f"https://{self.host}:{self.port}/api/v1/namespaces/"
            f"{self.namespace}/pods?labelSelector={selector}"
        )
        async with self._session.get(
            url, headers={"Authorization": f"Bearer {self._token}"}
        ) as resp:
            body = await resp.json()
        return body.get("items", [])

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()


class ServiceDiscovery:
    def __init__(
        self,
        registry: WorkerRegistry,
        config: DiscoveryConfig | None = None,
        api: KubeApi | None = None,
        client_factory=None,
    ):
        self.config = config or DiscoveryConfig()
        self.registry = registry
        self.api = api or KubeApi(self.config.namespace)
        self._client_factory = client_factory or self._default_client_factory
        self._task: asyncio.Task | None = None
        self._managed: set[str] = set()  # worker ids this discovery registered

    @staticmethod
    def _default_client_factory(url: str):
        from smg_tpu_torch.rpc.client import GrpcWorkerClient

        return GrpcWorkerClient(url)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def aclose(self) -> None:
        """Cancel polling and close the API session (awaited on shutdown)."""
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        close = getattr(self.api, "close", None)
        if close is not None:
            await close()

    async def _loop(self) -> None:
        logger.info(
            "service discovery polling %s/%s every %.0fs",
            self.config.namespace, self.config.selector, self.config.poll_interval_secs,
        )
        while True:
            try:
                await self.sync_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("discovery sweep failed")
            await asyncio.sleep(self.config.poll_interval_secs)

    async def sync_once(self) -> None:
        pods = await self.api.list_pods(self.config.selector)
        seen: set[str] = set()
        for pod in pods:
            status = pod.get("status", {})
            meta = pod.get("metadata", {})
            ip = status.get("podIP")
            if not ip or status.get("phase") != "Running":
                continue
            labels = meta.get("labels", {})
            annotations = meta.get("annotations", {})
            role = labels.get(ROLE_LABEL, self.config.default_role)
            wtype = {
                "prefill": WorkerType.PREFILL,
                "decode": WorkerType.DECODE,
                "encode": WorkerType.ENCODE,
            }.get(role, WorkerType.REGULAR)
            port = int(annotations.get(PORT_ANNOTATION, self.config.default_port))
            url = f"{ip}:{port}"
            wid = f"k8s-{meta.get('name', url)}"
            seen.add(wid)
            if self.registry.get(wid) is not None:
                continue
            client = self._client_factory(url)
            model_id = annotations.get(MODEL_ANNOTATION)
            if model_id is None:
                try:
                    info = await client.get_model_info()
                    model_id = info.get("model_id", "default")
                except Exception:
                    logger.warning("discovered pod %s not ready yet", url)
                    await client.close()
                    continue
            self.registry.add(
                Worker(worker_id=wid, client=client, model_id=model_id,
                       worker_type=wtype, url=url)
            )
            self._managed.add(wid)
        # remove managed workers whose pods are gone
        for wid in list(self._managed):
            if wid not in seen:
                worker = self.registry.remove(wid)
                self._managed.discard(wid)
                if worker is not None:
                    await worker.client.close()
