"""The port's workflow engine and worker registration, held against the
reference's (``tests/test_workflow.py``).

- (a) every case of the reference's workflow tests (validation, backoff
  schedules, event order, retry, the failure actions, a step timeout,
  resume, the job queue) runs through ``smg_tpu.workflow`` and
  ``smg_tpu_torch.workflow`` alike, with identical outcomes and events;
- (b) worker registration through ``POST /workers`` (synchronous, as a job
  with ``"async": true``, a failure against a port that is not listening,
  then a resume once a worker listens there) on the port's gateway and on
  the reference's, crosswise over a port gRPC worker (a tiny port engine
  on the CPU) and a reference one (``serve_worker_async`` over a JAX
  engine): the bodies, with ids and times removed, are identical.

The reference's model_info retry waits ~36 s before a registration against
a dead port fails; both gateways here retry that step at a fixed 10 ms
instead (their own definitions, changed after they are built)."""

import asyncio
import re
import socket
import threading

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import smg_tpu.workflow as jwf
import smg_tpu_torch.workflow as twf
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.gateway import server as jgw
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.rpc import server as jrpc
from smg_tpu.tokenizer import MockTokenizer as JaxMockTokenizer
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.gateway import server as tgw
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.rpc import server as trpc
from smg_tpu_torch.tokenizer import MockTokenizer

torch.set_num_threads(2)
WF = {"ref": jwf, "port": twf}


def _both(scenario):
    """``scenario(workflow package)`` run on a fresh loop with the
    reference's package and with the port's; the two results must be
    equal.  Returns the port's."""
    out = {name: asyncio.run(scenario(mod)) for name, mod in WF.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _fast(wf):
    return wf.RetryPolicy(max_attempts=3, backoff=wf.BackoffStrategy("fixed", base=0.01))


# ---- (a) the workflow engine ----


def test_the_public_names_are_the_reference_ones():
    assert twf.__all__ == jwf.__all__


def test_definition_validation():
    async def go(wf):
        async def noop(d):
            pass

        msgs = []
        for defn in (
            wf.WorkflowDefinition("empty"),
            wf.WorkflowDefinition("dup", [wf.StepDefinition("a", noop),
                                          wf.StepDefinition("a", noop)]),
            wf.WorkflowDefinition("bad", [wf.StepDefinition(
                "a", noop, retry=wf.RetryPolicy(max_attempts=0))]),
        ):
            with pytest.raises(wf.ValidationError) as ei:
                defn.validate()
            msgs.append(str(ei.value))
        return msgs

    assert len(_both(go)) == 3


def test_backoff_schedules():
    async def go(wf):
        B = wf.BackoffStrategy
        exp = B("exponential", base=1, max_delay=10)
        with pytest.raises(wf.ValidationError):
            B("bogus")
        return (B("fixed", base=2).delay(5), B("linear", increment=1, max_delay=3).delay(2),
                B("linear", increment=2, max_delay=3).delay(5),
                [exp.delay(i) for i in (1, 2, 3, 4, 5)])

    assert _both(go) == (2, 2, 3, [1, 2, 4, 8, 10])


def _events(engine):
    events = []
    engine.bus.subscribe(events.append)
    return events


def _kinds(events):
    return [(e.kind, e.step, e.error, e.attempt) for e in events]


def test_success_path_and_event_order():
    async def go(wf):
        engine = wf.WorkflowEngine()
        events = _events(engine)

        async def step1(d):
            d["x"] = 1

        async def step2(d):
            d["y"] = d["x"] + 1

        engine.register(wf.WorkflowDefinition("wf", [wf.StepDefinition("one", step1),
                                                     wf.StepDefinition("two", step2)]))
        inst = await engine.wait(await engine.start("wf", {}))
        return inst.status.value, inst.data, _kinds(events)

    status, data, kinds = _both(go)
    assert status == "completed" and data == {"x": 1, "y": 2}
    assert [k[0] for k in kinds] == ["workflow_started", "step_started", "step_succeeded",
                                     "step_started", "step_succeeded", "workflow_completed"]


def test_retry_then_success():
    async def go(wf):
        engine = wf.WorkflowEngine()
        events = _events(engine)
        attempts = {"n": 0}

        async def flaky(d):
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("transient")

        engine.register(wf.WorkflowDefinition("wf", [
            wf.StepDefinition("flaky", flaky, retry=_fast(wf))]))
        inst = await engine.wait(await engine.start("wf"))
        return inst.status.value, inst.steps["flaky"].attempts, _kinds(events)

    status, attempts, kinds = _both(go)
    assert (status, attempts) == ("completed", 3)
    assert [k[0] for k in kinds].count("step_retrying") == 2


def test_fail_workflow_and_continue_next_step():
    async def go(wf):
        engine = wf.WorkflowEngine()
        events = _events(engine)

        async def boom(d):
            raise RuntimeError("kaput")

        async def after(d):
            d["after"] = True

        engine.register(wf.WorkflowDefinition("hard", [
            wf.StepDefinition("boom", boom, retry=_fast(wf)), wf.StepDefinition("after", after)]))
        hard = await engine.wait(await engine.start("hard"))
        engine.register(wf.WorkflowDefinition("soft", [
            wf.StepDefinition("boom", boom, retry=_fast(wf),
                              on_failure=wf.FailureAction.CONTINUE_NEXT_STEP),
            wf.StepDefinition("after", after)]))
        soft = await engine.wait(await engine.start("soft"))
        return ([(i.status.value, i.error, {n: s.status.value for n, s in i.steps.items()},
                  i.data) for i in (hard, soft)], _kinds(events))

    (hard, soft), _ = _both(go)
    assert hard == ("failed", "kaput", {"boom": "failed", "after": "pending"}, {})
    assert soft[0] == "completed" and soft[2]["boom"] == "skipped"
    assert soft[3] == {"after": True}


def test_retry_indefinitely_until_cancel():
    async def go(wf):
        engine = wf.WorkflowEngine()

        async def forever(d):
            raise RuntimeError("nope")

        engine.register(wf.WorkflowDefinition("wf", [wf.StepDefinition(
            "forever", forever,
            retry=wf.RetryPolicy(max_attempts=1, backoff=wf.BackoffStrategy("fixed", base=0.01)),
            on_failure=wf.FailureAction.RETRY_INDEFINITELY)]))
        iid = await engine.start("wf")
        await asyncio.sleep(0.15)
        cancelled = await engine.cancel(iid)
        inst = await engine.wait(iid)
        return cancelled, inst.status.value, inst.steps["forever"].attempts > 3

    assert _both(go) == (True, "cancelled", True)


def test_step_timeout():
    async def go(wf):
        engine = wf.WorkflowEngine()
        events = _events(engine)

        async def slow(d):
            await asyncio.sleep(5)

        engine.register(wf.WorkflowDefinition("wf", [wf.StepDefinition(
            "slow", slow, timeout=0.05, retry=wf.RetryPolicy(max_attempts=1))]))
        inst = await engine.wait(await engine.start("wf"))
        return inst.status.value, _kinds(events)

    status, kinds = _both(go)
    assert status == "failed" and kinds[-1][0] == "workflow_failed"


def test_resume_from_failure():
    """A failed step reruns on resume; succeeded steps do not repeat."""

    async def go(wf):
        engine = wf.WorkflowEngine()
        events = _events(engine)
        runs = {"good": 0}
        gate = {"open": False}

        async def good(d):
            runs["good"] += 1

        async def gated(d):
            if not gate["open"]:
                raise RuntimeError("closed")
            d["done"] = True

        engine.register(wf.WorkflowDefinition("wf", [
            wf.StepDefinition("good", good), wf.StepDefinition("gated", gated, retry=_fast(wf))]))
        iid = await engine.start("wf")
        first = (await engine.wait(iid)).status.value
        gate["open"] = True
        resumed = await engine.resume(iid)
        inst = await engine.wait(iid)
        again = await engine.resume(iid)  # a completed instance is not resumable
        return (first, resumed, inst.status.value, inst.data, runs["good"], again,
                _kinds(events))

    first, resumed, status, data, good_runs, again, _ = _both(go)
    assert (first, resumed, status, data, good_runs, again) == (
        "failed", True, "completed", {"done": True}, 1, False)


def test_job_queue():
    async def go(wf):
        q = wf.JobQueue(concurrency=2)
        try:
            async def ok():
                await asyncio.sleep(0.01)
                return 42

            async def bad():
                raise ValueError("no")

            j1, j2 = q.submit(ok, "ok"), q.submit(bad, "bad")
            j1, j2 = await q.wait(j1.job_id), await q.wait(j2.job_id)
            listed = {j.job_id for j in q.list()} >= {j1.job_id, j2.job_id}
            return ([(j.status, j.result, j.error, j.name) for j in (j1, j2)], listed,
                    sorted(j1.describe()))
        finally:
            await q.close()

    jobs, listed, _keys = _both(go)  # the describe() keys: equal across the two
    assert jobs == [("succeeded", 42, None, "ok"), ("failed", None, "no", "bad")] and listed


# ---- (b) registration through POST /workers, crosswise ----

MODEL = "tiny-reg"
SCHED = dict(max_batch_size=2, max_seq_len=128, max_prefill_tokens=32)
GATEWAYS = {"ref": jgw, "port": tgw}
VOLATILE = {"instance_id", "created_at", "updated_at", "job_id", "finished_at"}


def _jax_params():
    cfg = tiny_test_config()
    return get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))


def _scrub(obj):
    """A response body without ids and times."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"\b(wfi|job)_[0-9a-f]{24}\b", r"\1_", obj)
    return obj


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Stack:
    """A JAX and a port engine, each behind its own implementation's gRPC
    server, and both gateways, on one private loop thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        jp = _jax_params()
        self.engines = {
            "ref": JaxEngine(jconf.EngineConfig(
                model=tiny_test_config(),
                cache=jconf.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                        dtype="float32"),
                scheduler=jconf.SchedulerConfig(prefill_token_buckets=(32,),
                                                decode_batch_buckets=(2,), **SCHED),
                dtype="float32", model_id=MODEL), params=jp, tokenizer=JaxMockTokenizer()),
            "port": Engine(tconf.EngineConfig(
                model=port_tiny(),
                cache=tconf.CacheConfig(page_size=16, num_pages=64, auto_size=False,
                                        dtype="float32"),
                scheduler=tconf.SchedulerConfig(**SCHED), model_id=MODEL),
                params=params_from_jax(jax.tree.map(np.asarray, jp)), device="cpu",
                tokenizer=MockTokenizer()),
        }
        for e in self.engines.values():
            e.start()
        self.servers, self.urls, self.ctx, self.tc = {}, {}, {}, {}
        self.run(self._setup())

    async def _setup(self):
        for side, rpc in (("ref", jrpc), ("port", trpc)):
            server = await rpc.serve_worker_async(self.engines[side], port=0, host="127.0.0.1")
            self.servers[side] = [server]
            self.urls[side] = f"127.0.0.1:{server._bound_port}"
        for side, gw in GATEWAYS.items():
            ctx = gw.AppContext(policy="round_robin")
            steps = ctx.workflows._definitions["worker_registration"].steps
            steps[1].retry = _fast(WF[side])  # model_info: no 36 s backoff here
            self.ctx[side] = ctx
            self.tc[side] = TestClient(TestServer(gw.build_app(ctx)))
            await self.tc[side].start_server()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def close(self):
        async def down():
            for tc in self.tc.values():
                await tc.close()
            for servers in self.servers.values():
                for s in servers:
                    await s.stop(grace=None)

        self.run(down())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        for e in self.engines.values():
            e.stop()


@pytest.fixture(scope="module")
def stack():
    s = Stack()
    yield s
    s.close()


async def _post_json(tc, path, body=None):
    r = await tc.post(path, json=body)
    return r.status, await r.json()


async def _remove(tc, wid):
    r = await tc.delete(f"/workers/{wid}", params={"drain": "0"})
    return r.status, await r.json()


@pytest.mark.parametrize("worker", ["port", "ref"], ids=["port-worker", "ref-worker"])
def test_worker_add_via_workflow_sync(stack, worker):
    out = {}
    for gw in GATEWAYS:
        wid = f"wf-sync-{worker}"
        out[gw] = stack.run(_post_json(stack.tc[gw], "/workers",
                                       {"url": stack.urls[worker], "worker_id": wid}))
        assert stack.ctx[gw].tokenizers.has(MODEL)
        assert stack.run(_remove(stack.tc[gw], wid)) == (
            200, {"removed": wid, "drained": True, "in_flight_at_removal": 0})
    assert _scrub(out["port"]) == _scrub(out["ref"])
    status, body = out["port"]
    assert status == 200, body
    assert body["added"]["worker_id"] == f"wf-sync-{worker}"
    assert body["added"]["model_id"] == MODEL
    assert body["workflow"]["status"] == "completed"
    steps = body["workflow"]["steps"]
    assert steps["model_info"]["status"] == steps["tokenizer"]["status"] == "succeeded"


@pytest.mark.parametrize("worker", ["port", "ref"], ids=["port-worker", "ref-worker"])
def test_worker_add_async_job(stack, worker):
    async def go(tc, wid):
        status, accepted = await _post_json(tc, "/workers", {
            "url": stack.urls[worker], "worker_id": wid, "async": True})
        assert status == 202 and accepted["status"] == "queued"
        for _ in range(400):
            r = await tc.get(f"/jobs/{accepted['job_id']}")
            job = await r.json()
            if job["status"] in ("succeeded", "failed"):
                listed = await (await tc.get("/jobs")).json()
                assert accepted["job_id"] in [j["job_id"] for j in listed["jobs"]]
                return job
            await asyncio.sleep(0.05)
        raise TimeoutError

    out = {}
    for gw in GATEWAYS:
        wid = f"wf-async-{worker}"
        out[gw] = stack.run(go(stack.tc[gw], wid))
        assert stack.ctx[gw].registry.get(wid) is not None
        stack.run(_remove(stack.tc[gw], wid))
    assert _scrub(out["port"]) == _scrub(out["ref"])
    assert out["port"]["status"] == "succeeded", out["port"]
    assert out["port"]["result"]["status"] == "completed"
    assert out["port"]["name"] == f"register {stack.urls[worker]}"


def test_failed_registration_is_resumable(stack):
    """Registration against a port nothing listens on fails after its
    retries; once the port's worker listens there, POST
    /workflows/{id}/resume completes it (connect dials again, as the
    failure reset it) and the worker serves."""

    async def fail(tc, url, wid):
        status, body = await _post_json(tc, "/workers", {"url": url, "worker_id": wid})
        wfs = await (await tc.get("/workflows", params={"type": "worker_registration"})).json()
        failed = [w for w in wfs["workflows"]
                  if w["status"] == "failed" and w["steps"]["model_info"]["status"] == "failed"]
        assert failed, wfs
        one = await (await tc.get(f"/workflows/{failed[-1]['instance_id']}")).json()
        assert one == failed[-1]
        return status, body, failed[-1]

    async def resume(tc, iid):
        status, desc = await _post_json(tc, f"/workflows/{iid}/resume")
        again = await _post_json(tc, f"/workflows/{iid}/resume")  # completed now
        return status, desc, again

    dead = _free_port()
    url = f"127.0.0.1:{dead}"
    failures = {gw: stack.run(fail(stack.tc[gw], url, "wf-resume")) for gw in GATEWAYS}
    for gw, (status, body, inst) in failures.items():
        assert status == 502 and body["error"]["type"] == "worker_error", body
        assert body["error"]["message"].startswith("worker registration failed: ")
        assert stack.ctx[gw].registry.get("wf-resume") is None
    # the gRPC error texts differ (ports, times); the shapes do not
    shape = {gw: {**_scrub(inst), "error": None,
                  "steps": {n: {**s, "error": s["error"] is not None}
                            for n, s in inst["steps"].items()}}
             for gw, (_s, _b, inst) in failures.items()}
    assert shape["port"] == shape["ref"]
    assert shape["port"]["steps"]["connect"] == {"status": "pending", "attempts": 1,
                                                 "error": False}
    assert shape["port"]["steps"]["model_info"]["attempts"] == 3

    async def listen():  # the port's worker comes up on the dead port
        server = await trpc.serve_worker_async(stack.engines["port"], port=dead,
                                               host="127.0.0.1")
        stack.servers["port"].append(server)

    stack.run(listen())
    resumed = {gw: stack.run(resume(stack.tc[gw], failures[gw][2]["instance_id"]))
               for gw in GATEWAYS}
    assert _scrub(resumed["port"]) == _scrub(resumed["ref"])
    status, desc, again = resumed["port"]
    assert status == 200 and desc["status"] == "completed", desc
    assert desc["steps"]["connect"]["attempts"] == 1
    assert again[0] == 409 and again[1]["error"]["message"].endswith("is not resumable")

    async def serves(tc):
        r = await tc.post("/generate", json={
            "input_ids": list(range(5, 25)),
            "sampling_params": {"max_new_tokens": 4, "temperature": 0}})
        return r.status, await r.json()

    gens = {gw: stack.run(serves(stack.tc[gw])) for gw in GATEWAYS}
    assert gens["port"][0] == 200 and len(gens["port"][1]["output_ids"]) == 4
    assert gens["port"][1]["output_ids"] == gens["ref"][1]["output_ids"]
    for gw in GATEWAYS:
        stack.run(_remove(stack.tc[gw], "wf-resume"))


def test_unknown_ids_and_bad_requests(stack):
    """The error bodies of the registration surface."""

    async def go(tc):
        out = []
        for method, path, body in (
                ("GET", "/jobs/job_nope", None), ("GET", "/workflows/wfi_nope", None),
                ("POST", "/workflows/wfi_nope/resume", None), ("POST", "/workers", {}),
                ("DELETE", "/workers/nope", None), ("DELETE", "/workers/nope?drain=x", None)):
            r = await tc.request(method, path, json=body)
            out.append((r.status, await r.json()))
        return out

    out = {gw: stack.run(go(stack.tc[gw])) for gw in GATEWAYS}
    assert out["port"] == out["ref"]
    assert [s for s, _ in out["port"]] == [404, 404, 409, 400, 404, 404]


def test_drain_bounds_and_a_second_drain(stack):
    """``?drain=`` out of [0, 300] is a 400; a worker already draining is a
    409."""

    async def go(gw):
        tc, ctx = stack.tc[gw], stack.ctx[gw]
        wid = "wf-drain"
        st, _ = await _post_json(tc, "/workers", {"url": stack.urls["port"], "worker_id": wid})
        assert st == 200
        bad = await tc.delete(f"/workers/{wid}", params={"drain": "301"})
        out = [(bad.status, await bad.json())]
        ctx.registry.get(wid).draining = True
        busy = await tc.delete(f"/workers/{wid}", params={"drain": "0"})
        out.append((busy.status, await busy.json()))
        ctx.registry.get(wid).draining = False
        out.append(await _remove(tc, wid))
        return out

    out = {gw: stack.run(go(gw)) for gw in GATEWAYS}
    assert [(s, _scrub(b)) for s, b in out["port"]] == [
        (s, _scrub(b)) for s, b in out["ref"]]
    assert [s for s, _ in out["port"]] == [400, 409, 200]
