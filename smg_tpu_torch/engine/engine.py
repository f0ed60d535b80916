"""Engine facade: scheduler + detokenisation + stop strings + streaming
results + the background step loop (port of ``smg_tpu/engine/engine.py``:
``submit``, ``abort``, ``step``, ``generate``, ``start``/``stop``,
``loads``, ``audit``, ``flush_cache``, ``healthy``, ``dump_flight``,
``metrics``, ``events``, ``embed``, ``start_profile``/``stop_profile``,
the LoRA adapter calls, the PD legs ``prefill_export`` and
``submit_prefilled`` and, on a vision-language model, ``encode_image`` and
``submit(mm_embeds=...)``), with the draft-model proposer installed when
``config.draft_model`` is set.

Entry points run on the card: ``device=None`` means CUDA, and a machine
without one raises.  ``start()`` runs ``step()`` on a loop thread while
there is work, and the step watchdog when ``step_watchdog_secs`` > 0;
output callbacks run on the loop thread, outside the engine lock (the
callback map itself is read and written under it).  The engine lock comes
from ``make_lock("engine", reentrant=True)``, so the lock-order sentinel
sees it; ``loads()["programs"]`` and ``program_audit()`` report the
runner's graph families (``analysis/runtime_guards.py``).  With a
``tokenizer``, outputs carry text (``text_delta``, and ``text`` in
``GenerationResult``), ``stop`` strings end a request at this layer (token
stops live in the scheduler), and ``json_schema``/``regex``/``ebnf``
install a grammar vocab mask.

A sticky CUDA error (an illegal address or a device-side assert inside a
kernel) makes every later launch fail too.  The engine applies the
reference's logic to it unchanged: the failing step blames its newest
lane, the retry fails and condemns the batch, every later step fails
again, so the consecutive-failure threshold turns ``healthy`` false and the
gateway routes around the worker.  Such a worker must be restarted.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from smg_tpu_torch.analysis.runtime_guards import make_lock
from smg_tpu_torch.constrained import JsonMachine, TokenFilter
from smg_tpu_torch.engine.config import EngineConfig
from smg_tpu_torch.engine.detokenize import IncrementalDecoder, StopStringChecker
from smg_tpu_torch.engine.events import KvEventPublisher
from smg_tpu_torch.engine.metrics import EngineMetrics
from smg_tpu_torch.engine.request import EngineRequest, StepOutput
from smg_tpu_torch.engine.runner import ModelRunner, resolve_device
from smg_tpu_torch.engine.scheduler import Scheduler
from smg_tpu_torch.models.llama import init_params
from smg_tpu_torch.parallel.group import device_backend, resolve_devices
from smg_tpu_torch.parallel.leader import refusal, start_ranks
from smg_tpu_torch.parallel.sharding import RankPlace, check_mesh
from smg_tpu_torch.protocols.sampling import SamplingParams
from smg_tpu_torch.utils import get_logger

logger = get_logger("engine")


@dataclass
class RequestOutput:
    """One streamed increment for a request."""

    rid: str
    new_token_ids: list[int] = field(default_factory=list)
    text_delta: str = ""
    finished: bool = False
    finish_reason: str | None = None
    matched_stop: str | int | None = None
    prompt_tokens: int = 0
    output_tokens: int = 0
    cached_tokens: int = 0
    logprobs: list[float] = field(default_factory=list)


@dataclass
class GenerationResult:
    rid: str
    token_ids: list[int]
    text: str
    finish_reason: str
    matched_stop: str | int | None
    prompt_tokens: int
    output_tokens: int
    cached_tokens: int
    logprobs: list[float]


class Engine:
    def __init__(self, config: EngineConfig, params: dict | None = None, device=None,
                 attention: str = "kernel", tokenizer=None, draft_params: dict | None = None,
                 vision_params: dict | None = None, devices: list | None = None):
        """``draft_params`` gives the draft model (``config.draft_model``)
        its weights; without them they are random, from ``draft_seed``.
        ``vision_params`` gives a vision-language model's tower its weights
        (``models.weights.load_vision_params``); without them they are
        random, from the seed (the reference's ``seed ^ 0x71510``).

        A rank mesh (``config.parallel``'s tp, pp, sp or ep above 1) runs one
        rank process per rank on ``devices`` (the reference's
        ``Engine(cfg, devices=...)``; left out, ``cuda:0 .. cuda:N-1``; a list
        that repeats a CUDA device puts ranks on one card, over gloo): tp
        shards heads, FFN and vocab, pp the layer stack (a pipeline stage a
        rank), sp runs a cold prefill chunk as ring attention, ep shards the
        experts.  The engine raises when the machine has fewer devices than
        the mesh, and ``close()`` stops the ranks;
        ``parallel/group.py::TP_TIMEOUT_S`` bounds every collective and
        rendezvous.  A rank-mesh engine refuses dp above 1, the expert layer
        under tp and the vision tower at construction, LoRA under tp,
        embeddings and the PD legs when called, each naming its ``ROADMAP.md``
        item."""
        if config.scheduler.speculative_tier == "draft" and config.draft_model is None:
            raise ValueError("scheduler.speculative_tier 'draft' requires a configured "
                             "draft model (EngineConfig.draft_model)")
        self.config = config
        self.tokenizer = tokenizer
        self._leader = None
        par = config.parallel
        if par.dp > 1:
            raise refusal("dp")
        if par.world_size > 1:
            if par.tp > 1 and config.model.num_experts:
                raise refusal("experts")
            if config.model.vision is not None:
                raise refusal("vision")
            check_mesh(config.model, RankPlace.of(par.axis_sizes(), {}))
            devices = resolve_devices(par, devices)
            if config.decode_graphs and device_backend(devices) == "gloo":
                raise ValueError(
                    "decode_graphs=True needs the nccl backend: gloo collectives "
                    f"(ranks on {[str(d) for d in devices]}) cannot be captured in a "
                    "CUDA graph; set EngineConfig.decode_graphs=False")
            device = devices[0]
        elif devices:
            device = devices[0]
        self.events = KvEventPublisher()
        if config.draft_model is not None and draft_params is None:
            # the draft's weights go on the device before the runner sizes
            # the KV caches from the memory left
            dev = resolve_device(device)
            draft_params = init_params(
                config.draft_model, torch.Generator(device=dev).manual_seed(config.draft_seed),
                dev)
        # the vision tower (VLM): resident before the runner sizes the KV
        # caches, which also set its peak activations aside
        self._vision_params = None
        if config.model.vision is not None:
            from smg_tpu_torch.models.vit import init_vision_params

            dev = resolve_device(device)
            if vision_params is None:
                vision_params = init_vision_params(
                    config.model.vision,
                    torch.Generator(device=dev).manual_seed(config.seed ^ 0x71510), dev)
            self._vision_params = _tree_to(vision_params, dev)
        if par.world_size > 1:
            self.runner, self._leader = start_ranks(config, params, devices, attention)
            # the ranks stop when the engine is dropped or the process exits
            self._close_ranks = weakref.finalize(self, self._leader.close)
        else:
            self.runner = ModelRunner(config, params=params, device=device,
                                      attention=attention)
        # the engine's own registry; the gateway also registers it into its
        # registry, so /metrics is one scrape
        self.metrics = EngineMetrics(
            window_secs=config.metrics_window_secs,
            device_sample_interval_secs=config.device_metrics_interval_secs)
        self.metrics.set_mesh_devices(self.runner.mesh_devices)
        self.scheduler = Scheduler(self.runner, config, event_sink=self.events.publish,
                                   metrics=self.metrics)
        if config.draft_model is not None:
            from smg_tpu_torch.engine.draft import DraftRunner

            self.scheduler.draft = DraftRunner(
                config.draft_model, num_pages=self.runner.spec.num_pages,
                page_size=self.runner.spec.page_size,
                dtype=config.cache.dtype,  # the draft cache follows the KV dtype
                params=draft_params, device=self.runner.device,
                max_prefill_tokens=config.scheduler.max_prefill_tokens,
                attention=attention)
        self._callbacks: dict[str, object] = {}
        self._json_filter = None  # shared TokenFilter (piece table + mask cache)
        self._grammar_filters: dict = {}  # (kind, pattern) -> TokenFilter
        self._lock = make_lock("engine", reentrant=True)
        self._wakeup = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self.start_time = time.monotonic()
        # step watchdog: ``_last_progress`` is a bare float the step thread
        # writes and the watchdog reads without the engine lock — the
        # watchdog must never block on a lock a wedged step holds
        self._watchdog: threading.Thread | None = None
        self._last_progress = time.monotonic()
        self._stalled = False
        self.num_watchdog_stalls = 0
        # torch.profiler trace (start_profile): the profiler, its output
        # directory and the steps left before it stops by itself (None:
        # until stop_profile)
        self._profiler = None
        self._profile_dir: str | None = None
        self._profile_steps_left: int | None = None

    @property
    def supports_vision(self) -> bool:
        """The model has a vision tower (the gateway reads this)."""
        return self._vision_params is not None

    def encode_image(self, pixel_values, grid: tuple) -> np.ndarray:
        """Vision-tower encode: pre-patchified pixels [N, patch_dim] (numpy
        or a tensor) -> language-space embeddings [N / merge^2, hidden]
        float32 on the host, the rows ``submit(mm_embeds=...)`` splices.
        Runs eagerly on the engine's device under the engine lock, between
        steps."""
        from smg_tpu_torch.models.vit import forward_vision

        if self._vision_params is None:
            raise ValueError("model has no vision tower")
        vcfg = self.config.model.vision
        with self._lock, torch.inference_mode():
            pv = torch.as_tensor(pixel_values, dtype=torch.float32).to(self.runner.device)
            out = forward_vision(self._vision_params, vcfg, pv, (int(grid[0]), int(grid[1])))
            return out.float().cpu().numpy()  # the blocking fetch

    # ---- submission ----

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               rid: str | None = None, on_output=None,
               mm_embeds: tuple | None = None,
               timeout_secs: float | None = None,
               trace_id: str | None = None) -> str:
        """Queue a request; ``on_output`` receives its ``RequestOutput``s.
        ``timeout_secs`` is the request's budget: past it the scheduler ends
        it with finish ``timeout``, queued or running.  ``trace_id`` links
        the flight-recorder timeline to the caller's trace.  ``mm_embeds``
        = (embeds [M, E] float32, positions [M][, grids]) splices image
        embeddings into the prompt at the placeholder positions; with the
        per-image merged grids (gh, gw) and a model with an M-RoPE section,
        the request takes M-RoPE position ids and its decode offset
        (``engine/mrope.py``).  Raises ``QueueFullError`` under admission
        back-pressure or while draining, and ``ValueError`` for an adapter
        that is not loaded and for image input that does not fit the
        prompt."""
        rid = rid or f"req-{uuid.uuid4().hex[:16]}"
        req = EngineRequest(rid=rid, prompt_ids=list(prompt_ids), sampling=sampling)
        req.trace_id = trace_id
        if timeout_secs is not None:
            req.deadline = time.monotonic() + max(timeout_secs, 0.0)
        if mm_embeds is not None:
            embeds, positions, *rest = mm_embeds
            grids = rest[0] if rest else None  # per-image merged (gh, gw)
            embeds = np.asarray(embeds, np.float32)
            positions = np.asarray(positions, np.int64)
            if positions.size and (positions.min() < 0
                                   or positions.max() >= len(prompt_ids)):
                raise ValueError("mm_embeds positions out of prompt range")
            if embeds.shape[0] != positions.shape[0]:
                raise ValueError("mm_embeds embeds/positions length mismatch")
            req.mm_embeds = (embeds, positions)
            if grids and self.config.model.mrope_section is not None:
                from smg_tpu_torch.engine.mrope import image_runs_from_positions, mrope_positions

                runs = image_runs_from_positions(positions, grids)
                req.mrope_pos, req.mrope_delta = mrope_positions(len(prompt_ids), runs)
        if self.tokenizer is not None:
            req.detok = IncrementalDecoder(
                self.tokenizer, skip_special_tokens=sampling.skip_special_tokens)
            if sampling.stop:
                req.stop_checker = StopStringChecker(sampling.stop)
        req.token_filter = self._build_token_filter(sampling)
        if sampling.lora_adapter:
            req.lora_idx = self.runner.lora_index(sampling.lora_adapter)
        with self._wakeup:
            self.scheduler.add_request(req)
            # fresh work restarts the watchdog clock: a stall is measured from
            # "work existed and no step completed", not from an idle engine
            self._last_progress = time.monotonic()
            if on_output is not None:
                self._callbacks[rid] = on_output
            self._wakeup.notify_all()
        return rid

    def _build_token_filter(self, sampling: SamplingParams):
        """The grammar vocab-mask filter for structured output.
        ``json_schema`` constrains generation to syntactically valid JSON
        (``{}`` = any document; the schema's shape is not enforced).  One
        filter per regex/EBNF pattern (at most 16 kept) and one shared JSON
        filter: the piece table and the text-to-mask cache are per
        tokenizer and pattern."""
        if sampling.json_schema is None and not sampling.regex and not sampling.ebnf:
            return None
        if self.tokenizer is None:
            logger.warning("grammar constraint ignored: engine has no tokenizer")
            return None
        eos = self.config.model.eos_token_ids
        V = self.config.model.vocab_size
        if sampling.regex or sampling.ebnf:
            key = ("ebnf", sampling.ebnf) if sampling.ebnf else ("regex", sampling.regex)
            cached = self._grammar_filters.get(key)
            if cached is not None:
                return cached
            if sampling.ebnf:
                from smg_tpu_torch.constrained.ebnf import EbnfMachine

                machine = EbnfMachine(sampling.ebnf)
            else:
                from smg_tpu_torch.constrained.regex_fsm import RegexMachine

                machine = RegexMachine(sampling.regex)
            filt = TokenFilter(self.tokenizer, machine, V, eos_token_ids=eos)
            if len(self._grammar_filters) >= 16:  # bound the pattern-keyed mask caches
                self._grammar_filters.pop(next(iter(self._grammar_filters)))
            self._grammar_filters[key] = filt
            return filt
        if self._json_filter is None:
            self._json_filter = TokenFilter(self.tokenizer, JsonMachine(), V, eos_token_ids=eos)
        return self._json_filter

    # ---- LoRA adapters (reference: Load/Unload/ListLoRAAdapter) ----

    def load_lora_adapter(self, name: str, path: str | None = None,
                          data: bytes | None = None) -> int:
        """Install an adapter from a PEFT directory, an ``.npz`` path or
        inline npz bytes; returns its bank slot.  The bank is written in
        place: captured graphs stay valid, and running requests are not
        touched (no row reads a slot until a request names its adapter).
        Replacing an adapter that live requests use is refused."""
        import os

        from smg_tpu_torch.models import lora as lora_mod

        self._refuse_under_mesh("lora")
        if data is not None:
            weights = lora_mod.load_npz(data)
        elif path is None:
            raise ValueError("need path or data")
        elif os.path.isdir(path):
            weights = lora_mod.load_peft_dir(path, self.config.model)
        else:
            weights = lora_mod.load_npz(path)
        with self._lock:
            names = self.runner._lora_names
            if name in names and self._lora_slot_busy(names[name]):
                raise ValueError(
                    f"adapter {name!r} has in-flight requests; drain before replacing")
            return self.runner.load_lora(name, weights)

    def _lora_slot_busy(self, slot: int) -> bool:
        """True when a live request is pinned to the bank slot: every launch
        re-reads the bank, so swapping a busy slot would change a running
        request's weights mid-generation."""
        return any(r.lora_idx == slot and not r.is_finished
                   for r in self.scheduler.requests.values())

    def unload_lora_adapter(self, name: str) -> bool:
        with self._lock:
            idx = self.runner._lora_names.get(name)
            if idx is not None and self._lora_slot_busy(idx):
                raise ValueError(
                    f"adapter {name!r} has in-flight requests; drain before unloading")
            return self.runner.unload_lora(name)

    def list_lora_adapters(self) -> list[str]:
        with self._lock:
            return self.runner.list_loras()

    def abort(self, rid: str) -> bool:
        with self._lock:
            ok = self.scheduler.abort_request(rid)
            self._callbacks.pop(rid, None)
            return ok

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    @property
    def healthy(self) -> bool:
        """False while the step watchdog sees a stall, after
        ``max_consecutive_step_failures`` failed steps in a row, or once a
        rank-mesh engine lost a rank; the gateway's health monitor and
        breakers route around it."""
        return (not self._stalled
                and self.scheduler.consec_step_failures
                < self.config.max_consecutive_step_failures
                and (self._leader is None or self._leader.alive))

    def loads(self, include_audit: bool = True) -> dict:
        """The scheduler's load counters, health and watchdog stalls;
        ``include_audit=False`` leaves out the audit (its radix lock walk)
        and the graph families' snapshot, for per-dispatch callers such as
        the gRPC worker's replica pick."""
        with self._lock:
            out = self.scheduler.loads()
            if include_audit:
                out["audit"] = self._audit_locked()
                # the graph families' launch and capture counts (a cheap
                # snapshot; the full pass is program_audit())
                out["programs"] = self.runner._programs.snapshot()
        out["healthy"] = self.healthy
        out["watchdog_stalls"] = self.num_watchdog_stalls
        return out

    def program_audit(self) -> dict:
        """The graph-family audit (``runtime_guards.ProgramAuditor``): arm
        ``self.runner._programs`` after warmup, run steady-state traffic,
        then call this.  Every input on this engine's device, the KV cache
        and every graph's static buffers in their storage across replays,
        and provenance for every capture while armed."""
        return self.runner.program_audit()

    def _audit_locked(self) -> dict:
        out = self.scheduler.audit()
        out["pending_callbacks"] = len(self._callbacks)
        out["clean"] = out["clean"] and (not out["quiescent"] or not self._callbacks)
        return out

    def audit(self) -> dict:
        """``Scheduler.audit`` plus output callbacks left at quiescence."""
        with self._lock:
            return self._audit_locked()

    def dump_flight(self, reason: str = "manual") -> dict:
        """Flight-recorder snapshot: the step ring, request timelines and
        the index of auto-dumps.  Never takes the engine lock: a wedged step
        thread (what a postmortem is for) holds it, and the recorder is
        consistent under its own lock."""
        fl = self.scheduler.flight
        if fl is None:
            from smg_tpu_torch.engine.flight_recorder import SCHEMA_VERSION

            return {"schema_version": SCHEMA_VERSION, "error": "flight recorder disabled"}
        snap = fl.snapshot(reason)
        snap["engine"] = {
            "model_id": self.config.model_id,
            "healthy": self.healthy,
            "uptime_secs": time.monotonic() - self.start_time,
            "watchdog_stalls": self.num_watchdog_stalls,
            "consecutive_step_failures": self.scheduler.consec_step_failures,
            "draining": self.scheduler.draining,
        }
        if fl.dumps:
            # the newest auto-dump rides along in full
            snap["last_auto_dump"] = fl.dumps[-1]
        return snap

    def flush_cache(self) -> bool:
        with self._lock:
            return self.scheduler.flush_cache()

    def embed(self, batches: list[list[int]]):
        """Sequence embeddings ``[n, hidden]`` float32 (``runner.embed``).
        Runs under the engine lock, so never inside a step or a graph
        capture, and on the device's default stream, which the loop
        thread's launches use too: it runs after the work they enqueued."""
        self._refuse_under_mesh("embeddings")
        with self._lock:
            return self.runner.embed(batches)

    # ---- profiling (the reference's /start_profile; here torch.profiler) ----

    def start_profile(self, output_dir: str, host_tracer: bool = True,
                      python_tracer: bool = False, num_steps: int = 0) -> str:
        """Start a ``torch.profiler`` trace of the CPU and, on the card,
        CUDA activity; returns ``output_dir``, where ``stop_profile`` writes
        the Chrome trace.  ``host_tracer`` records the host's operators with
        their shapes, ``python_tracer`` Python call stacks.  ``num_steps`` >
        0 stops the trace after that many engine steps."""
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._profiler is not None:
                raise RuntimeError("profiler already running")
            activities = [ProfilerActivity.CPU]
            if self.runner.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities, record_shapes=host_tracer,
                           with_stack=python_tracer,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
            prof.start()
            self._profiler, self._profile_dir = prof, output_dir
            self._profile_steps_left = num_steps if num_steps > 0 else None
        logger.info("profiler started -> %s", output_dir)
        return output_dir

    def stop_profile(self) -> None:
        with self._lock:
            if self._profiler is None:
                raise RuntimeError("profiler not running")
            self._stop_profile_locked()
        logger.info("profiler stopped")

    def _stop_profile_locked(self) -> None:
        """Stop the trace and write it as ``trace-<pid>-<ms>.json`` under its
        output directory; the profiler state is cleared even when the write
        fails (an unwritable directory)."""
        import os

        prof, out_dir = self._profiler, self._profile_dir
        self._profiler = self._profile_dir = self._profile_steps_left = None
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)

    # ---- PD disaggregation legs ----

    def prefill_export(self, prompt_ids: list[int], sampling: SamplingParams,
                       connector: str = "host") -> dict:
        """The prefill leg: compute the prompt's KV, export its pages through
        ``connector`` and free them.  Returns {first_token, k, v, seq_len,
        connector}; k and v are ``[L, n, ps, KD]``, CPU tensors for
        ``host`` and tensors on this engine's device for ``device``.  Runs
        under the engine lock, between two steps of the loop thread (an
        overlap frame may be in flight: see ``Scheduler.prefill_only``)."""
        from smg_tpu_torch.engine.kv_connector import get_connector

        self._refuse_under_mesh("pd")
        conn = get_connector(connector)
        with self._lock:
            tok, pages, seq_len = self.scheduler.prefill_only(
                prompt_ids, sampling, token_filter=self._build_token_filter(sampling))
            try:
                k, v = conn.export(self.runner, pages)
            finally:
                self.scheduler.release_pages(pages)
        return {"first_token": tok, "k": k, "v": v, "seq_len": seq_len,
                "connector": conn.name}

    def submit_prefilled(self, prompt_ids: list[int], first_token: int, k, v,
                         sampling: SamplingParams, rid: str | None = None,
                         on_output=None, trace_id: str | None = None) -> str:
        """The decode leg: import the prompt's KV (``k``, ``v``: [L, n, ps,
        KD]) by the connector its payload needs (``resolve_for_payload``),
        adopt the request into a decode lane and accept ``first_token``.
        With no slot or page free, or a failed import, the request is
        submitted normally and its prompt prefilled here, as the reference
        does: that keeps it alive under pressure (a warning is logged)."""
        from smg_tpu_torch.engine.kv_connector import resolve_for_payload

        self._refuse_under_mesh("pd")
        rid = rid or f"req-{uuid.uuid4().hex[:16]}"
        req = EngineRequest(rid=rid, prompt_ids=list(prompt_ids), sampling=sampling)
        req.trace_id = trace_id
        if self.tokenizer is not None:
            req.detok = IncrementalDecoder(
                self.tokenizer, skip_special_tokens=sampling.skip_special_tokens)
            if sampling.stop:
                req.stop_checker = StopStringChecker(sampling.stop)
        req.token_filter = self._build_token_filter(sampling)
        if sampling.lora_adapter:
            req.lora_idx = self.runner.lora_index(sampling.lora_adapter)
        with self._wakeup:
            pages = None
            try:
                pages = self.scheduler.alloc_import_pages(len(prompt_ids))
                resolve_for_payload(k).import_(self.runner, pages, k, v)
                adopted = self.scheduler.adopt_prefilled(req, pages, first_token)
            except Exception:
                logger.exception("KV import failed for %s", rid)
                adopted = False
            if not adopted and pages is not None:
                self.scheduler.release_pages(pages)
            if on_output is not None:
                self._callbacks[rid] = on_output
            if adopted:
                step_outs: list[StepOutput] = []
                self.scheduler._accept_tokens(req, [int(first_token)], [0.0], step_outs,
                                              advance_seq=False)
                outputs = [self._postprocess(so) for so in step_outs]
            else:
                logger.warning("PD adopt failed for %s; falling back to local prefill", rid)
                try:
                    self.scheduler.add_request(req)
                except Exception:
                    self._callbacks.pop(rid, None)
                    raise
                outputs = []
            self._last_progress = time.monotonic()
            self._wakeup.notify_all()
        self._deliver(outputs)
        return rid

    # ---- stepping ----

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration; returns per-request increments.  The
        callbacks run after the engine lock is released."""
        with self._lock:
            outputs = [self._postprocess(so) for so in self.scheduler.step()]
            self.events.flush()
            if self.config.device_metrics_interval_secs > 0:
                self.metrics.maybe_sample_devices([self.runner.device])
            if self._profile_steps_left is not None:
                self._profile_steps_left -= 1
                if self._profile_steps_left <= 0:
                    try:
                        self._stop_profile_locked()
                        logger.info("profiler stopped (step budget reached)")
                    except Exception:
                        logger.exception("step-bounded profiler stop failed")
        # watchdog progress mark: a step completed end to end, so a flagged
        # stall has cleared
        self._last_progress = time.monotonic()
        if self._stalled:
            self._stalled = False
            logger.warning("engine step progress resumed; stall cleared")
        self._deliver(outputs)
        return outputs

    def _deliver(self, outputs: list[RequestOutput]) -> None:
        """Run the outputs' callbacks in order, outside the engine lock: the
        callback map is read, and a finished request's entry popped, under
        it (``abort`` and ``submit`` write the map from other threads), and
        no callback runs under it, so the locks a callback takes (the
        gateway's) never nest inside the engine's."""
        if not outputs:
            return
        calls = []
        with self._lock:
            for out in outputs:
                cb = self._callbacks.get(out.rid)
                if cb is None:
                    continue
                if out.finished:
                    self._callbacks.pop(out.rid, None)
                calls.append((cb, out))
        for cb, out in calls:
            try:
                cb(out)
            except Exception:
                logger.exception("output callback failed for %s", out.rid)

    def _postprocess(self, so: StepOutput) -> RequestOutput:
        """Detokenise a step's increment and scan it for stop strings token
        by token: a match swallows the stop string, rolls back the tokens
        after it and finishes the request here (``finish_request``); a match
        completed only by the final flush still reports ``stop``."""
        req = so.request
        out = RequestOutput(
            rid=req.rid,
            new_token_ids=list(so.new_token_ids),
            finished=so.finished,
            finish_reason=so.finish.reason if so.finish else None,
            matched_stop=so.finish.matched_stop if so.finish else None,
            prompt_tokens=req.prompt_len,
            output_tokens=len(req.output_ids),
            cached_tokens=req.cached_tokens,
            logprobs=list(so.logprobs),
        )
        if req.detok is None:
            return out
        if req.stop_checker is None:
            text = req.detok.put(so.new_token_ids) if so.new_token_ids else ""
            if so.finished:
                text += req.detok.flush()
            out.text_delta = text
            return out
        parts: list[str] = []
        consumed = 0
        stopped = False
        for tok in so.new_token_ids:
            piece, stopped = req.stop_checker.feed(req.detok.put([tok]))
            consumed += 1
            parts.append(piece)
            if stopped:
                break
        if stopped and consumed < len(so.new_token_ids):
            # roll back the tokens after the stop (their KV lies past
            # seq_len, which never enters the radix cache)
            cut = len(so.new_token_ids) - consumed
            out.new_token_ids = out.new_token_ids[:consumed]
            out.logprobs = out.logprobs[:consumed]
            req.output_ids = req.output_ids[: len(req.output_ids) - cut]
            req.logprobs = req.logprobs[: len(req.logprobs) - cut]
            req.seq_len -= cut
            out.output_tokens = len(req.output_ids)
        if stopped:
            matched = req.stop_checker.matched
            if not so.finished:
                self.scheduler.finish_request(req.rid, "stop", matched_stop=matched)
            out.finished = True
            out.finish_reason = "stop"
            out.matched_stop = matched
        elif so.finished:
            piece, stopped_late = req.stop_checker.feed(req.detok.flush())
            parts.append(piece)
            if stopped_late:
                out.finish_reason = "stop"
                out.matched_stop = req.stop_checker.matched
            else:
                parts.append(req.stop_checker.flush())
        out.text_delta = "".join(parts)
        return out

    # ---- background loop ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._last_progress = time.monotonic()
        self._thread = threading.Thread(target=self._loop, name="smg-torch-engine",
                                        daemon=True)
        self._thread.start()
        if self.config.step_watchdog_secs > 0 and self._watchdog is None:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="smg-torch-engine-watchdog",
                                              daemon=True)
            self._watchdog.start()

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """Stop the loop.  ``drain=True`` first stops admission, ends every
        queued request with a terminal ``abort``, and waits up to ``timeout``
        seconds for the admitted requests to finish streaming."""
        if drain:
            # the black box's "shut down on purpose" record, before the
            # sweep changes the state
            if self.scheduler.flight is not None:
                self.scheduler.flight.auto_dump("drain")
            with self._wakeup:
                self.scheduler.draining = True
                step_outs: list[StepOutput] = []
                self.scheduler.drain_waiting(step_outs)
                outputs = [self._postprocess(so) for so in step_outs]
                self._wakeup.notify_all()
            self._deliver(outputs)
            deadline = time.monotonic() + max(timeout, 0.0)
            while self._thread is not None and time.monotonic() < deadline:
                if not self.has_work():
                    break
                time.sleep(0.01)
            else:
                if self._thread is not None:
                    logger.warning("drain timeout (%.1fs): stopping with work in flight",
                                   timeout)
        with self._wakeup:
            self._stopping = True
            self._wakeup.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None

    def close(self) -> None:
        """``stop()``, then stop a rank-mesh engine's rank processes:
        none outlives the engine.  Idempotent."""
        self.stop()
        if self._leader is not None:
            self._close_ranks()

    def _refuse_under_mesh(self, what: str) -> None:
        """Refuse ``what`` on a rank-mesh engine (LoRA only under tp)."""
        if self._leader is not None and (what != "lora" or self.config.parallel.tp > 1):
            raise refusal(what)

    def _watchdog_loop(self) -> None:
        """Flags the engine unhealthy when no step completes for
        ``step_watchdog_secs`` while work is pending.  Lock-free: a wedged
        step thread usually holds the engine lock, so the watchdog only
        reads scheduler state (racy, but enough for a threshold) and takes
        the lock only if it is free, to drop the in-flight frame."""
        T = self.config.step_watchdog_secs
        poll = max(min(T / 4.0, 1.0), 0.01)
        logger.info("engine step watchdog started (threshold %.1fs)", T)
        while not self._stopping:
            time.sleep(poll)
            if self._stopping:
                break
            try:
                has_work = self.scheduler.has_work()  # unlocked read, see above
            except Exception:
                continue
            stalled_for = time.monotonic() - self._last_progress
            if not has_work or stalled_for <= T:
                continue
            if not self._stalled:
                self._stalled = True
                self.num_watchdog_stalls += 1
                self.metrics.watchdog_stalls.inc()
                logger.error("engine wedged: no step progress for %.1fs with work "
                             "pending; marking unhealthy", stalled_for)
                # takes only the recorder's own lock
                if self.scheduler.flight is not None:
                    self.scheduler.flight.auto_dump("watchdog_stall")
                # a blocking acquire would wait behind the very stall it reports
                if self._lock.acquire(blocking=False):
                    try:
                        self.scheduler.drop_inflight()
                    finally:
                        self._lock.release()
        logger.info("engine step watchdog stopped")

    def _loop(self) -> None:
        """Step while there is work.  With ``overlap_schedule`` each step
        consumes the previous launch and leaves the next in flight, so the
        host's bookkeeping and callbacks here overlap the card's compute;
        ``has_work`` counts the in-flight frame, so the pipeline drains by
        itself, and stop() discards whatever is still in flight."""
        while True:
            with self._wakeup:
                if self._stopping:
                    break
                if not self.scheduler.has_work():
                    self._wakeup.wait(timeout=0.05)
                    continue
            try:
                self.step()
                # the lock is not fair: yield so a submit, abort or stop
                # waiting on it gets in between two steps
                time.sleep(0)
            except Exception:
                # last resort: the scheduler quarantines prefill and decode
                # failures itself, so this one escaped blame.  It counts
                # toward the unhealthy threshold and the loop lives on.
                with self._lock:
                    self.scheduler._count_step_failure("loop")
                    self.scheduler.flush_pending_dumps()
                logger.exception("engine step failed (%d consecutive)",
                                 self.scheduler.consec_step_failures)
                time.sleep(0.1)
        with self._lock:
            self.scheduler.drop_inflight()

    # ---- sync convenience ----

    def generate(self, prompt_ids: list[int], sampling: SamplingParams | None = None,
                 rid: str | None = None, timeout_secs: float = 300.0) -> GenerationResult:
        """Blocking generate: steps the engine inline when no loop thread
        runs, otherwise waits on the stream.  An expired ``timeout_secs``
        comes back as a result with finish ``timeout``; ``TimeoutError``
        is only the backstop for an engine that stops producing outputs."""
        sampling = sampling or SamplingParams()
        done = threading.Event()
        chunks: list[RequestOutput] = []

        def on_output(out: RequestOutput) -> None:
            chunks.append(out)
            if out.finished:
                done.set()

        rid = self.submit(prompt_ids, sampling, rid=rid, on_output=on_output,
                          timeout_secs=timeout_secs)
        backstop = timeout_secs + 30.0
        if self._thread is None:
            deadline = time.monotonic() + backstop
            while not done.is_set():
                self.step()
                if time.monotonic() > deadline:
                    self.abort(rid)
                    raise TimeoutError(f"generation {rid} timed out")
        elif not done.wait(timeout=backstop):
            self.abort(rid)
            raise TimeoutError(f"generation {rid} timed out")
        return collect_result(rid, chunks)


def collect_result(rid: str, chunks: list[RequestOutput]) -> GenerationResult:
    """Fold a request's streamed increments into its final result."""
    token_ids = [t for c in chunks for t in c.new_token_ids]
    last = chunks[-1]
    return GenerationResult(
        rid=rid,
        token_ids=token_ids,
        text="".join(c.text_delta for c in chunks),
        finish_reason=last.finish_reason or "stop",
        matched_stop=last.matched_stop,
        prompt_tokens=last.prompt_tokens,
        output_tokens=last.output_tokens,
        cached_tokens=chunks[0].cached_tokens if chunks else 0,
        logprobs=[x for c in chunks for x in c.logprobs],
    )


def _tree_to(tree, device: torch.device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
