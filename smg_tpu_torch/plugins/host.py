"""Plugin host: load middleware plugins and run their hooks with fault
isolation (the port's copy of ``smg_tpu/plugins/host.py``).

Reference behavior (``crates/wasm`` host): plugins are loaded at startup
from explicit paths, run in registration order on every request/response,
and a plugin fault never takes down the gateway — the host logs and treats
the hook as ``continue`` (fail-open) or rejects the request (fail-closed),
per config.  Each hook runs under a wall-clock budget.

A plugin is a Python module (file path or dotted import) exporting either or
both of::

    def on_request(req: PluginRequest) -> Action: ...
    def on_response(resp: PluginResponse) -> Action: ...

Hooks may be sync or async.
"""

from __future__ import annotations

import asyncio
import importlib
import importlib.util
import sys
import time
from dataclasses import dataclass

from smg_tpu_torch.plugins.spec import (
    Action,
    Continue,
    Modify,
    PluginRequest,
    PluginResponse,
    Reject,
)
from smg_tpu_torch.utils import get_logger

logger = get_logger("plugins")


@dataclass
class LoadedPlugin:
    name: str
    module: object

    @property
    def has_on_request(self) -> bool:
        return callable(getattr(self.module, "on_request", None))

    @property
    def has_on_response(self) -> bool:
        return callable(getattr(self.module, "on_response", None))


class PluginHost:
    def __init__(self, fail_open: bool = True, hook_timeout_s: float = 5.0):
        self.fail_open = fail_open
        self.hook_timeout_s = hook_timeout_s
        self.plugins: list[LoadedPlugin] = []

    def load(self, spec: str) -> LoadedPlugin:
        """Load a plugin from a file path (``/path/plug.py``) or a dotted
        module name (``mypkg.plug``)."""
        if spec.endswith(".py"):
            name = spec.rsplit("/", 1)[-1][:-3]
            modname = f"smg_tpu_torch_plugin_{name}_{len(self.plugins)}"
            il_spec = importlib.util.spec_from_file_location(modname, spec)
            if il_spec is None or il_spec.loader is None:
                raise ImportError(f"cannot load plugin file {spec!r}")
            module = importlib.util.module_from_spec(il_spec)
            sys.modules[modname] = module
            il_spec.loader.exec_module(module)
        else:
            name = spec
            module = importlib.import_module(spec)
        plugin = LoadedPlugin(name=name, module=module)
        if not (plugin.has_on_request or plugin.has_on_response):
            raise ValueError(
                f"plugin {spec!r} exports neither on_request nor on_response"
            )
        self.plugins.append(plugin)
        logger.info("plugin loaded: %s (request=%s response=%s)",
                    name, plugin.has_on_request, plugin.has_on_response)
        return plugin

    # ---- hook execution ----

    async def _call(self, plugin: LoadedPlugin, hook: str, arg) -> Action:
        fn = getattr(plugin.module, hook)
        try:
            if asyncio.iscoroutinefunction(fn):
                return await asyncio.wait_for(fn(arg), timeout=self.hook_timeout_s)
            loop = asyncio.get_running_loop()
            return await asyncio.wait_for(
                loop.run_in_executor(None, fn, arg), timeout=self.hook_timeout_s
            )
        except Exception as e:
            logger.warning("plugin %s %s failed: %s", plugin.name, hook, e)
            if self.fail_open:
                return Continue()
            return Reject(500, f"plugin {plugin.name} failed")

    async def on_request(self, req: PluginRequest) -> Action:
        """Run every plugin's on_request in order.  First Reject wins;
        Modifies accumulate into ``req`` in place."""
        for p in self.plugins:
            if not p.has_on_request:
                continue
            action = await self._call(p, "on_request", req)
            if isinstance(action, Reject):
                return action
            if isinstance(action, Modify):
                _apply_modify_request(req, action)
        return Continue()

    async def on_response(self, resp: PluginResponse) -> Action:
        for p in self.plugins:
            if not p.has_on_response:
                continue
            action = await self._call(p, "on_response", resp)
            if isinstance(action, Reject):
                return action
            if isinstance(action, Modify):
                _apply_modify_response(resp, action)
        return Continue()

    @staticmethod
    def make_request(request, request_id: str = "") -> PluginRequest:
        """Build a PluginRequest from an aiohttp request (body read lazily by
        the caller when a body-inspecting plugin is registered)."""
        return PluginRequest(
            method=request.method,
            path=request.path,
            query=request.query_string,
            headers={k.lower(): v for k, v in request.headers.items()},
            request_id=request_id,
            now_epoch_ms=int(time.time() * 1000),
        )


def _apply_modify_request(req: PluginRequest, m: Modify) -> None:
    for k in m.headers_remove:
        req.headers.pop(k.lower(), None)
    for k, v in m.headers_add.items():
        req.headers.setdefault(k.lower(), v)
    for k, v in m.headers_set.items():
        req.headers[k.lower()] = v
    if m.body_replace is not None:
        req.body = m.body_replace


def _apply_modify_response(resp: PluginResponse, m: Modify) -> None:
    if m.status is not None:
        resp.status = m.status
    for k in m.headers_remove:
        resp.headers.pop(k.lower(), None)
    for k, v in m.headers_add.items():
        resp.headers.setdefault(k.lower(), v)
    for k, v in m.headers_set.items():
        resp.headers[k.lower()] = v
    if m.body_replace is not None:
        resp.body = m.body_replace
