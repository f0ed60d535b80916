"""Decode megasteps replayed from CUDA graphs (``engine/graphs.py``), on the
card only: a graph has no CPU mode.  Tiny float32 model with random weights
from a seed, float32 KV, the decode kernel on every column.

- a replay equals the eager megastep bitwise (tokens, logprobs, steps_run
  and the KV it lands) for several (B bucket, page-table width, horizon);
- a lookahead chained off a frame of the same graph leaves the earlier
  frame's fetched results intact;
- capturing a large bucket after a small one leaves the small graph right
  (the decode kernel's counters are preallocated for the largest bucket);
- replay launch counts add up: L x K decode-kernel launches per launch,
  none at capture;
- the engine with graphs and the overlap pipeline gives the eager
  synchronous engine's streams;
- with penalties (the runner's per-slot count rows, read and written back
  in place) and with a vocab mask, a replay equals the eager megastep
  bitwise, the count rows included, and a re-sync of a slot's rows between
  replays keeps the buffer's address (the graph reads the new rows);
- a speculative verify block replayed from its own graph equals the eager
  block bitwise (emitted rows, logprobs, ``n_emit`` and the accepted KV),
  two frames in flight off one graph keep their own results, and a
  speculative engine with graphs and overlap gives the eager synchronous
  engine's streams and drafted and accepted counts;
- every engine of the card captures on one shared stream: four engines
  built, served, stopped and dropped in a row leave ``memory_allocated``
  where the second left it (the cuBLAS workspaces are not multiplied), and
  an engine that survives another's end replays its graphs to the eager
  streams bitwise.

Run on a GPU: ``python -m pytest tests/test_torch_graphs.py -m cuda -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
from smg_tpu_torch.engine.engine import Engine, collect_result
from smg_tpu_torch.engine.runner import DecodeState, ModelRunner
from smg_tpu_torch.models.config import tiny_test_config
from smg_tpu_torch.models.llama import init_params
from smg_tpu_torch.ops.cuda import decode_attention as dk
from smg_tpu_torch.protocols.sampling import SamplingParams

PS, PAGES, MARK = 16, 200, 5


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def config(graphs: bool, overlap: bool = True, horizon: int = 4) -> EngineConfig:
    return EngineConfig(
        model=tiny_test_config(),
        cache=CacheConfig(page_size=PS, num_pages=PAGES, auto_size=False, dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=256, max_prefill_tokens=64,
                                  decode_batch_buckets=(2, 4, 8), decode_horizon=horizon,
                                  overlap_schedule=overlap),
        decode_graphs=graphs)


@pytest.fixture
def runners(cuda_dev):
    """(graph runner, eager runner) on the same weights and cache contents."""
    params = init_params(tiny_test_config(), torch.Generator(device=cuda_dev).manual_seed(0),
                         cuda_dev)
    g, e = (ModelRunner(config(flag), params=params, device=cuda_dev) for flag in (True, False))
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    for cache in ("k_cache", "v_cache"):
        fill = torch.randn(getattr(g, cache).shape, generator=gen, device=cuda_dev) * 0.5
        getattr(g, cache).copy_(fill)
        getattr(e, cache).copy_(fill)
    return g, e


def case(B_real: int, B: int, mp: int, K: int, seed: int, pen=None):
    """Host inputs of one launch: distinct pages per row, ragged entries, a
    mix of greedy and sampled rows, a stop state whose ids are met, and
    ``pen`` = (slot_idx, freqs, pres, reps) when penalties are on."""
    rng = np.random.default_rng(seed)
    pt = np.zeros((B, mp), np.int32)
    pt[:B_real] = rng.permutation(np.arange(1, PAGES))[: B_real * mp].reshape(B_real, mp)
    pos = np.full(B, mp * PS, np.int32)  # padded rows: the garbage page
    pos[:B_real] = rng.integers(1, mp * PS - K, B_real)
    toks = np.zeros(B, np.int64)
    toks[:B_real] = rng.integers(2, 500, B_real)
    temps = np.zeros(B, np.float32)
    temps[: B_real // 2] = 0.8
    stop = None
    if K > 1:
        stop = (rng.integers(2, 500, (B, 4)), np.full(B, 10_000, np.int64),
                np.arange(B) < B_real)
    ds = DecodeState.of(pt, temps, np.full(B, -1), np.ones(B), np.zeros(B), stop, pen)
    return toks, pos, ds


def launch(runner, toks, pos, ds, K, mask=None):
    runner.rng_restore(MARK)
    return runner.decode_fetch(runner.decode_multi_async(toks, pos, ds, K, mask))


def penalty_rows(runner, B_real: int, B: int, seed: int):
    """Write the real lanes' count and prompt-mask rows (slots 0..B_real-1,
    seeded prompts and outputs with repeats) and return the launch's
    (slot_idx, freqs, pres, reps); padded rows use the garbage row S."""
    rng = np.random.default_rng(seed)
    S = runner.config.scheduler.max_batch_size
    for slot in range(B_real):
        outs = rng.integers(2, 60, 16).tolist()  # small ids: repeats
        runner.sync_slot_penalty_state(slot, rng.integers(2, 500, 30).tolist(), outs)
    slot_idx = np.full(B, S)
    slot_idx[:B_real] = np.arange(B_real)
    freqs, pres, reps = np.zeros(B), np.zeros(B), np.ones(B)
    freqs[:B_real] = rng.uniform(0.0, 1.0, B_real)
    pres[:B_real] = rng.uniform(0.0, 0.5, B_real)
    reps[:B_real] = rng.uniform(1.0, 1.5, B_real)
    return slot_idx, freqs, pres, reps


def vocab_mask(B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = rng.random((B, tiny_test_config().vocab_size)) < 0.3
    mask[:, 2] = True  # never an empty row
    return mask


def assert_same(a, b):
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    assert a[2] == b[2]


@pytest.mark.cuda
@pytest.mark.parametrize("B_real,B,mp,K", [(3, 4, 8, 1), (8, 8, 16, 4), (2, 2, 8, 2),
                                           (5, 8, 32, 4)])
def test_replay_equals_eager_megastep_bitwise(runners, B_real, B, mp, K):
    g, e = runners
    toks, pos, ds = case(B_real, B, mp, K, seed=B * 100 + K)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    launch(g, toks, pos, ds, K)  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    replay = launch(g, toks, pos, ds, K)
    eager = launch(e, toks, pos, ds, K)
    assert g.graphs.num_graphs == 1 and e.graphs.num_graphs == 0
    assert_same(replay, eager)
    # page 0 is the garbage page: which of several padded writes lands there
    # is not defined
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    assert torch.equal(g.v_cache[:, 1:], e.v_cache[:, 1:])


@pytest.mark.cuda
def test_lookahead_off_the_same_graph_keeps_the_earlier_frame(runners):
    g, e = runners
    K = 2
    toks, pos, ds = case(4, 4, 8, K, seed=7)
    launch(g, toks, pos, ds, K)  # capture: both frames below are replays
    g.rng_restore(MARK)
    first = g.decode_multi_async(toks, pos, ds, K)
    second = g.decode_multi_async(first.last_col, pos + K, ds, K)  # same graph
    got1, got2 = g.decode_fetch(first), g.decode_fetch(second)
    e.rng_restore(MARK)
    want1 = e.decode_fetch(e.decode_multi_async(toks, pos, ds, K))
    want2 = e.decode_fetch(e.decode_multi_async(want1[0][:, -1], pos + K, ds, K))
    assert g.graphs.num_graphs == 1
    assert_same(got1, want1)
    assert_same(got2, want2)


@pytest.mark.cuda
def test_large_bucket_captured_after_a_small_one(runners):
    g, e = runners
    small, large = case(2, 2, 8, 2, seed=11), case(8, 8, 16, 2, seed=12)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    for toks, pos, ds in (small, large):
        launch(g, toks, pos, ds, 2)
    assert g.graphs.num_graphs == 2
    g.k_cache.copy_(k0)  # the two warm-ups wrote KV into shared pages
    g.v_cache.copy_(v0)
    assert_same(launch(g, *small, 2), launch(e, *small, 2))
    assert_same(launch(g, *large, 2), launch(e, *large, 2))


@pytest.mark.cuda
def test_replay_launch_counts_add_up(runners):
    g, _ = runners
    L, K = tiny_test_config().num_layers, 4
    toks, pos, ds = case(3, 4, 8, K, seed=3)
    n0 = dk.launches
    launch(g, toks, pos, ds, K)  # eager warm-up runs; the capture adds nothing
    torch.cuda.synchronize()
    assert dk.launches == n0 + L * K
    for i in range(3):
        launch(g, toks, pos, ds, K)
        assert dk.launches == n0 + L * K * (i + 2)
    step = next(iter(g.graphs.steps.values()))
    assert step.replay_launches == L * K
    assert g.stats["decode_columns"] * L == dk.launches - n0


@pytest.mark.cuda
def test_engine_with_graphs_and_overlap_matches_eager_sync(cuda_dev):
    params = init_params(tiny_test_config(), torch.Generator(device=cuda_dev).manual_seed(0),
                         cuda_dev)
    jobs = [(f"r{i}", list(range(5 + 9 * i, 60 + 9 * i)), 10 + 5 * i) for i in range(5)]
    results = {}
    for graphs, overlap in ((True, True), (False, False)):
        eng = Engine(config(graphs, overlap), params=params, device=cuda_dev)
        chunks = {rid: [] for rid, _, _ in jobs}
        for rid, prompt, n in jobs:
            eng.submit(prompt, SamplingParams(temperature=0.0, max_new_tokens=n,
                                              ignore_eos=True),
                       rid=rid, on_output=chunks[rid].append)
        for _ in range(500):
            if not eng.has_work():
                break
            eng.step()
        results[graphs] = {rid: collect_result(rid, c).token_ids for rid, c in chunks.items()}
        loads = eng.loads()
        assert loads["audit"]["clean"] and (loads["decode_graphs"] > 0) == graphs, loads
    assert results[True] == results[False]


@pytest.mark.cuda
@pytest.mark.parametrize("use_pen,use_mask,K", [(True, False, 4), (True, False, 2),
                                                (False, True, 1), (True, True, 1)])
def test_replay_with_penalties_and_mask_equals_eager_bitwise(runners, use_pen, use_mask, K):
    g, e = runners
    B_real, B, mp = 5, 8, 16
    S = g.config.scheduler.max_batch_size
    pen = None
    if use_pen:
        pen = penalty_rows(g, B_real, B, seed=K)
        assert penalty_rows(e, B_real, B, seed=K)[0].tolist() == pen[0].tolist()
    mask = vocab_mask(B, seed=K) if use_mask else None
    toks, pos, ds = case(B_real, B, mp, K, seed=40 + K, pen=pen)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    c0 = g._counts_buf.clone() if use_pen else None
    launch(g, toks, pos, ds, K, mask)  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    if use_pen:
        g._counts_buf.copy_(c0)  # in place: the graph holds the address
    replay = launch(g, toks, pos, ds, K, mask)
    eager = launch(e, toks, pos, ds, K, mask)
    assert g.graphs.num_graphs == 1
    assert_same(replay, eager)
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    assert torch.equal(g.v_cache[:, 1:], e.v_cache[:, 1:])
    if use_mask:
        assert mask[np.arange(B), replay[0][:, 0]].all()
    if use_pen:
        # row S is the padded rows' garbage row: which of them lands is not
        # defined.  The real rows counted the accepted columns only.
        assert torch.equal(g._counts_buf[:S], e._counts_buf[:S])
        grown = (g._counts_buf[:B_real].sum(1) - c0[:B_real].sum(1)).tolist()
        assert grown == [replay[2]] * B_real


@pytest.mark.cuda
def test_penalty_resync_between_replays_keeps_the_buffer(runners):
    g, e = runners
    B_real, B, mp, K = 3, 4, 8, 2
    pen = penalty_rows(g, B_real, B, seed=5)
    penalty_rows(e, B_real, B, seed=5)
    toks, pos, ds = case(B_real, B, mp, K, seed=9, pen=pen)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    launch(g, toks, pos, ds, K)  # warm-up and capture
    ptr = g._counts_buf.data_ptr()
    for seed in (6, 7):  # re-derive the rows as a discard or preemption does
        for r in (g, e):
            r.k_cache.copy_(k0)
            r.v_cache.copy_(v0)
            penalty_rows(r, B_real, B, seed=seed)
        assert_same(launch(g, toks, pos, ds, K), launch(e, toks, pos, ds, K))
        assert torch.equal(g._counts_buf[:B_real], e._counts_buf[:B_real])
    assert g._counts_buf.data_ptr() == ptr and g.graphs.num_graphs == 1


# ---- speculative verify blocks ----


def verify_case(B_real: int, B: int, mp: int, W: int, seed: int):
    """Host inputs of one verify launch: distinct pages per row, ragged
    entries and draft counts (one real lane drafts nothing), greedy and
    sampled lanes; padded rows at the garbage page with no drafts."""
    rng = np.random.default_rng(seed)
    pt = np.zeros((B, mp), np.int32)
    pt[:B_real] = rng.permutation(np.arange(1, PAGES))[: B_real * mp].reshape(B_real, mp)
    pos = np.full(B, mp * PS, np.int32)
    pos[:B_real] = rng.integers(1, mp * PS - W, B_real)
    toks = np.zeros((B, W), np.int64)
    toks[:B_real] = rng.integers(2, 500, (B_real, W))
    draft_n = np.zeros(B, np.int64)
    draft_n[:B_real] = rng.integers(0, W, B_real)
    draft_n[0] = 0
    temps = np.zeros(B, np.float32)
    temps[: B_real // 2] = 0.8
    return (toks, draft_n, pos, pt, temps, np.full(B, -1), np.ones(B, np.float32),
            np.zeros(B, np.float32))


def verify(runner, args):
    runner.rng_restore(MARK)
    return runner.spec_fetch(runner.decode_spec_async(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B_real,B,mp,W", [(3, 4, 8, 7), (8, 8, 16, 9), (2, 2, 8, 2)])
def test_verify_replay_equals_eager_bitwise(runners, B_real, B, mp, W):
    g, e = runners
    args = verify_case(B_real, B, mp, W, seed=B * 10 + W)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    verify(g, args)  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    replay, eager = verify(g, args), verify(e, args)
    stats = g.graphs.stats()
    assert stats["verify_graphs"] == 1 and stats["decode_graphs"] == 0
    assert stats["verify_capture_s"] > 0 and e.graphs.stats()["verify_graphs"] == 0
    for x, y in zip(replay, eager):
        np.testing.assert_array_equal(x, y)
    assert (replay[2] >= 1).all() and (replay[2] <= args[1] + 1).all()
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    assert torch.equal(g.v_cache[:, 1:], e.v_cache[:, 1:])


@pytest.mark.cuda
def test_verify_frames_off_the_same_graph_keep_their_results(runners):
    g, e = runners
    a, b = verify_case(4, 4, 8, 5, seed=21), verify_case(4, 4, 8, 5, seed=22)
    verify(g, a)  # capture: both frames below are replays
    g.rng_restore(MARK)
    first = g.decode_spec_async(*a)
    second = g.decode_spec_async(*b)  # overwrites the graph's inputs and outputs
    got1, got2 = g.spec_fetch(first), g.spec_fetch(second)
    e.rng_restore(MARK)
    want1 = e.spec_fetch(e.decode_spec_async(*a))
    want2 = e.spec_fetch(e.decode_spec_async(*b))
    for got, want in ((got1, want1), (got2, want2)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_speculative_engine_with_graphs_matches_eager_sync(cuda_dev):
    params = init_params(tiny_test_config(), torch.Generator(device=cuda_dev).manual_seed(0),
                         cuda_dev)
    jobs = [("rep", [5, 6, 7, 8] * 8, 0.0), ("nines", [9] * 8, 0.0),
            ("novel", list(range(40, 70)), 0.0), ("hot", [11, 12, 13] * 9, 0.8)]
    results, drafted = {}, {}
    for graphs in (True, False):
        cfg = config(graphs, overlap=graphs, horizon=1)
        cfg.scheduler = dataclasses.replace(cfg.scheduler, speculative=True, spec_max_draft=6)
        engine = Engine(cfg, params=params, device=cuda_dev)
        chunks = {rid: [] for rid, _, _ in jobs}
        for rid, prompt, temp in jobs:
            engine.submit(prompt, SamplingParams(temperature=temp, max_new_tokens=24,
                                                 ignore_eos=True),
                          rid=rid, on_output=chunks[rid].append)
        while engine.has_work():
            engine.step()
        results[graphs] = {rid: (collect_result(rid, c).token_ids, collect_result(rid, c).logprobs)
                           for rid, c in chunks.items()}
        drafted[graphs] = (engine.scheduler.num_spec_drafted, engine.scheduler.num_spec_accepted)
        assert engine.audit()["clean"]
        if graphs:
            assert engine.loads()["verify_graphs"] >= 1
    assert results[True] == results[False]
    assert drafted[True] == drafted[False] and drafted[True][1] > 0


def _serve(eng, jobs) -> dict:
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, n in jobs:
        eng.submit(prompt, SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True),
                   rid=rid, on_output=chunks[rid].append)
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
    return {rid: (collect_result(rid, c).token_ids, collect_result(rid, c).logprobs)
            for rid, c in chunks.items()}


JOBS = [(f"r{i}", list(range(5 + 9 * i, 60 + 9 * i)), 10 + 5 * i) for i in range(5)]


@pytest.mark.cuda
def test_engines_in_a_row_leave_no_workspace_behind(cuda_dev):
    import gc

    params = init_params(tiny_test_config(), torch.Generator(device=cuda_dev).manual_seed(0),
                         cuda_dev)
    allocated = []
    for _ in range(4):
        eng = Engine(config(True), params=params, device=cuda_dev)
        eng.start()  # the loop thread takes a cuBLAS handle of its own
        eng.generate(list(range(5, 60)), SamplingParams(temperature=0.0, max_new_tokens=12,
                                                        ignore_eos=True))
        eng.stop()
        assert eng.loads()["decode_graphs"] > 0
        del eng
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(cuda_dev))
    assert allocated[3] == allocated[1], allocated


@pytest.mark.cuda
def test_a_surviving_engine_replays_bitwise_after_another_ends(cuda_dev):
    import gc

    params = init_params(tiny_test_config(), torch.Generator(device=cuda_dev).manual_seed(0),
                         cuda_dev)
    eager = _serve(Engine(config(False, overlap=False), params=params, device=cuda_dev), JOBS)
    keep = Engine(config(True), params=params, device=cuda_dev)
    assert _serve(keep, JOBS) == eager
    other = Engine(config(True), params=params, device=cuda_dev)
    assert _serve(other, JOBS) == eager
    del other
    gc.collect()
    keep.flush_cache()
    graphs = keep.loads()["decode_graphs"]
    assert _serve(keep, JOBS) == eager
    assert keep.loads()["decode_graphs"] == graphs  # replayed, not captured again


# ---- M-RoPE offsets (image lanes) under graphs ----


def _with_delta(ds: DecodeState, delta) -> DecodeState:
    """``ds``'s inputs with per-row M-RoPE offsets, as a fresh composition."""
    out = DecodeState.of(ds.page_tables, ds.temps, ds.topks, ds.topps, ds.minps,
                         None if ds.stop_ids is None else (ds.stop_ids, ds.limits, ds.live),
                         rope_delta=delta)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B_real,B,mp,K", [(3, 4, 8, 1), (5, 8, 16, 4)])
def test_image_lane_megastep_replay_equals_eager_bitwise(runners, B_real, B, mp, K):
    """A megastep with image lanes (negative offsets) beside text lanes
    (offset 0): the replay equals the eager megastep bit for bit, a second
    composition's offsets reach the captured graph (the buffer is loaded,
    not baked in), and the text lanes' tokens and logprobs equal those of
    the graph without offsets."""
    g, e = runners
    toks, pos, ds = case(B_real, B, mp, K, seed=B * 1000 + K)
    delta = np.zeros(B, np.int32)
    delta[: B_real: 2] = [-(5 + 7 * i) for i in range(len(delta[: B_real: 2]))]
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()

    def fresh():
        for r in (g, e):
            r.k_cache.copy_(k0)
            r.v_cache.copy_(v0)

    launch(g, toks, pos, _with_delta(ds, delta), K)  # warm-up and capture
    for d in (delta, delta * 3):
        fresh()
        replay = launch(g, toks, pos, _with_delta(ds, d), K)
        eager = launch(e, toks, pos, _with_delta(ds, d), K)
        assert_same(replay, eager)
        assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    assert g.graphs.num_graphs == 1
    fresh()
    plain = launch(g, toks, pos, ds, K)  # the graph keyed without offsets
    fresh()
    mixed = launch(g, toks, pos, _with_delta(ds, delta), K)
    assert g.graphs.num_graphs == 2
    text = [i for i in range(B_real) if delta[i] == 0]
    for x, y in zip(mixed[:2], plain[:2]):
        np.testing.assert_array_equal(x[text], y[text])
    assert not np.array_equal(mixed[1][0], plain[1][0])  # the offset moved lane 0


@pytest.mark.cuda
def test_image_lane_verify_replay_equals_eager_bitwise(runners):
    g, e = runners
    args = verify_case(5, 8, 16, 9, seed=97)
    delta = np.array([-12, 0, -3, 0, -40, 0, 0, 0], np.int32)
    k0, v0 = g.k_cache.clone(), g.v_cache.clone()
    verify(g, (*args, delta))  # warm-up and capture
    g.k_cache.copy_(k0)
    g.v_cache.copy_(v0)
    replay, eager = verify(g, (*args, delta)), verify(e, (*args, delta))
    assert g.graphs.stats()["verify_graphs"] == 1
    for x, y in zip(replay, eager):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(g.k_cache[:, 1:], e.k_cache[:, 1:])
    e.k_cache.copy_(k0)
    e.v_cache.copy_(v0)
    plain = verify(e, args)
    text = [1, 3]
    for x, y in zip(replay, plain):
        np.testing.assert_array_equal(x[text], y[text])
