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
  replays keeps the buffer's address (the graph reads the new rows).

Run on a GPU: ``python -m pytest tests/test_torch_graphs.py -m cuda -q``."""

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
