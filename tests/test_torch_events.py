"""KV events of the port's radix cache against ``smg_tpu/engine/radix_cache.py``:
one seeded workload of inserts, prefix hits, pinned and unpinned
evictions, and ``clear`` (``flush_cache``) emits the same
``BlockStored``/``BlockRemoved``/``AllBlocksCleared`` sequence with the same
chain hashes, exactly; and the engines publish the same event batches for
the same requests, so the gateway's positional indexer sees one truth."""

import dataclasses

import numpy as np

import jax
from smg_tpu.engine import config as jconf
from smg_tpu.engine.engine import Engine as JaxEngine
from smg_tpu.engine.radix_cache import RadixCache as RefRadixCache
from smg_tpu.models.config import tiny_test_config
from smg_tpu.models.registry import get_model
from smg_tpu.protocols.sampling import SamplingParams as JaxSamplingParams
from smg_tpu_torch.engine import config as tconf
from smg_tpu_torch.engine.engine import Engine
from smg_tpu_torch.engine.radix_cache import RadixCache
from smg_tpu_torch.kv_index.positional import PositionalIndexer
from smg_tpu_torch.models.config import tiny_test_config as port_tiny
from smg_tpu_torch.models.convert import params_from_jax
from smg_tpu_torch.protocols.sampling import SamplingParams

PS = 4


def _plain(events) -> list:
    """Events as (type name, fields) tuples: the two packages' event classes
    are distinct types with the same fields."""
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


def _workload(cache, seed: int = 0) -> list:
    """Seeded inserts (shared prefixes, duplicates), prefix hits with pins,
    evictions under pins, and a final clear.  Returns what the caller sees
    (matched pages, duplicates, freed pages) so both caches are held to the
    same answers as well as the same events."""
    rng = np.random.default_rng(seed)
    seen = []
    next_page = 1
    bases = [list(rng.integers(0, 50, 12)) for _ in range(3)]
    pinned = []
    for _step in range(40):
        op = rng.integers(0, 4)
        if op <= 1:  # insert a sequence that extends a shared base
            base = bases[rng.integers(0, len(bases))]
            toks = base[: rng.integers(4, 13)] + list(rng.integers(0, 50, rng.integers(0, 9)))
            n_pages = len(toks) // PS
            pages = list(range(next_page, next_page + n_pages))
            next_page += n_pages
            seen.append(("insert", cache.insert([int(t) for t in toks], pages)))
        elif op == 2:  # a prefix hit, pinned for a while
            base = bases[rng.integers(0, len(bases))]
            pages, node = cache.match_prefix([int(t) for t in base])
            seen.append(("match", pages))
            cache.lock(node)
            pinned.append(node)
            if len(pinned) > 2:
                cache.unlock(pinned.pop(0))
        else:  # evict under whatever is pinned
            seen.append(("evict", sorted(cache.evict(int(rng.integers(1, 4))))))
    for node in pinned:
        cache.unlock(node)
    seen.append(("clear", sorted(cache.clear())))
    seen.append(("stats", cache.stats()))
    return seen


def test_radix_cache_events_and_hashes_match_the_reference():
    for seed in range(3):
        got_ev, want_ev = [], []
        got = _workload(RadixCache(PS, got_ev.append), seed)
        want = _workload(RefRadixCache(PS, want_ev.append), seed)
        assert got == want
        kinds = {type(e).__name__ for e in want_ev}
        assert kinds == {"BlockStored", "BlockRemoved", "AllBlocksCleared"}, kinds
        assert _plain(got_ev) == _plain(want_ev)


def test_positional_indexer_follows_the_port_events():
    """The gateway's indexer, fed the port engine's block hashes, finds the
    stored prefix at its depth (the chain is recomputed on the gateway)."""
    events = []
    cache = RadixCache(PS, events.append)
    toks = list(range(10, 22))
    cache.insert(toks, [1, 2, 3])
    from smg_tpu_torch.protocols.events import KvEventBatch

    idx = PositionalIndexer(page_size=PS)
    idx.apply_batch("w0", KvEventBatch(sequence_number=1, events=events))
    assert idx.match(toks + [99]) == {"w0": 12}


def test_engines_publish_the_same_event_batches():
    cfg = tiny_test_config()
    jparams = get_model(cfg.arch).init_params(cfg, jax.random.PRNGKey(0))
    sched = dict(max_batch_size=2, max_seq_len=128, max_prefill_tokens=64,
                 decode_batch_buckets=(2,), decode_horizon=4)
    je = JaxEngine(jconf.EngineConfig(
        model=cfg, cache=jconf.CacheConfig(page_size=16, num_pages=32, auto_size=False,
                                           dtype="float32"),
        scheduler=jconf.SchedulerConfig(prefill_token_buckets=(16, 32, 64), **sched),
        dtype="float32"), params=jparams)
    te = Engine(tconf.EngineConfig(
        model=port_tiny(),
        cache=tconf.CacheConfig(page_size=16, num_pages=32, auto_size=False, dtype="float32"),
        scheduler=tconf.SchedulerConfig(**sched)),
        params=params_from_jax(jax.tree.map(np.asarray, jparams)), device="cpu")
    batches = {}
    for name, eng, cls in (("jax", je, JaxSamplingParams), ("port", te, SamplingParams)):
        got = batches[name] = []
        eng.events.subscribe(lambda b, got=got: got.append(
            (b.sequence_number, _plain(b.events))))
        # a shared 40-token prefix (a radix hit), then a pool too small for
        # the third prompt without evicting, then a flush
        for rid, prompt in (("a", list(range(5, 45))), ("b", list(range(5, 45)) + [7, 8]),
                            ("c", list(range(100, 300)))):
            eng.generate(prompt_ids=prompt, rid=rid, sampling=cls(
                temperature=0.0, max_new_tokens=20, ignore_eos=True))
        assert eng.flush_cache()
        eng.step()  # publishes the flush's batch
    assert batches["port"] == batches["jax"]
    names = {n for _seq, evs in batches["port"] for n, _ in evs}
    assert names == {"BlockStored", "BlockRemoved", "AllBlocksCleared"}, names
