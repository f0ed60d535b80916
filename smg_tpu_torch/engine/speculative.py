"""Speculative decoding: prompt-lookup (n-gram) drafting — the port's copy
of ``smg_tpu/engine/speculative.py`` (JAX-free there too).

The drafting half of the two-tier speculation system
(``Scheduler._spec_phase``).  The default zero-cost tier drafts K tokens by
n-gram lookup over the request's own context — the longest recent suffix
n-gram that occurred earlier proposes the tokens that followed it
("Prompt Lookup Decoding"); ``NgramIndex`` makes the lookup incremental so
the serving loop pays O(1) per accepted token.  A configured draft MODEL
(``engine/draft.py``, ``EngineConfig.draft_model``) replaces n-gram lookup
as the proposer (``SchedulerConfig.speculative_tier`` pins either).

Verification is batched and fused on the device
(``runner.decode_spec_async``): every eligible lane's drafts ride one
verify block that scores all of its positions in a single forward, accepts
on the device (greedy chains at temperature 0, token-identical to plain
greedy decode; distribution-preserving rejection sampling above it,
``engine/sampling.py::spec_accept_sample``), and scatters only the accepted
columns' KV into real cache slots — rejected columns go to the garbage
page, so a bad draft never poisons a slot or the radix cache.  Under the
overlap schedule the verify frame stays in flight across steps
(``Scheduler._step_spec``), and a discarded frame rewinds its sampling
counter like a discarded lookahead.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SpecConfig:
    enabled: bool = False
    max_draft: int = 8       # K: tokens proposed per verify call
    ngram_max: int = 3       # longest suffix n-gram to match
    ngram_min: int = 1       # fall back to shorter n-grams down to this
    #: how far back the lookup scans — bounds the per-token host cost
    #: (O(window) instead of O(context); repetition useful for drafting is
    #: overwhelmingly recent)
    scan_window: int = 1024


def propose_ngram(
    token_ids: "list[int]", cfg: SpecConfig,
    index: "NgramIndex | None" = None,
) -> "list[int]":
    """Prompt-lookup draft: longest suffix n-gram (ngram_max down to
    ngram_min) with an EARLIER occurrence inside the scan window proposes
    the up-to-max_draft tokens that followed it.  Empty list = nothing to
    propose.

    ``index`` (per-request ``NgramIndex``) makes the lookup O(1) per call
    with O(1) incremental updates per accepted token; without it the scan
    is O(scan_window) — fine for tests, not the serving hot loop."""
    L = len(token_ids)
    if index is not None:
        index.extend(token_ids)
        for n in range(min(cfg.ngram_max, L - 1), cfg.ngram_min - 1, -1):
            suffix = tuple(token_ids[L - n:])
            start = index.last_occurrence(suffix, before=L - n)
            if start is not None and start >= L - cfg.scan_window:
                follow = token_ids[start + n:start + n + cfg.max_draft]
                if follow:
                    return list(follow)
        return []
    floor = max(0, L - cfg.scan_window)
    for n in range(min(cfg.ngram_max, L - 1), cfg.ngram_min - 1, -1):
        suffix = tuple(token_ids[L - n:])
        # scan right-to-left for the most recent earlier occurrence
        for start in range(L - n - 1, floor - 1, -1):
            if tuple(token_ids[start:start + n]) == suffix:
                follow = token_ids[start + n:start + n + cfg.max_draft]
                if follow:
                    return list(follow)
    return []


class NgramIndex:
    """Incremental n-gram -> latest-start-position map over a request's
    token stream.  ``extend`` appends only the new tail (O(1) amortized per
    token x ngram orders); ``last_occurrence`` is a dict probe.  The most
    recent PRIOR occurrence is tracked with one level of history so the
    suffix itself (which is also the latest occurrence) never shadows its
    predecessor."""

    def __init__(self, ngram_min: int = 1, ngram_max: int = 3):
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        self._count = 0
        self._last_tok: int | None = None  # content check at _count-1
        # ngram -> (latest_start, previous_start | None)
        self._latest: dict[tuple, tuple] = {}

    def extend(self, token_ids: "list[int]") -> None:
        L = len(token_ids)
        if L < self._count or (
            self._count and self._last_tok != token_ids[self._count - 1]
        ):
            # the stream was trimmed/rewritten (stop-string rollback):
            # indexed positions no longer describe the content — rebuild
            self._latest.clear()
            self._count = 0
        for pos in range(self._count, L):
            for n in range(self.ngram_min, self.ngram_max + 1):
                start = pos - n + 1
                if start < 0:
                    continue
                g = tuple(token_ids[start:start + n])
                cur = self._latest.get(g)
                self._latest[g] = (start, cur[0] if cur else None)
        self._count = L
        self._last_tok = token_ids[L - 1] if L else None

    def last_occurrence(self, gram: tuple, before: int) -> "int | None":
        """Most recent start strictly before ``before``."""
        cur = self._latest.get(gram)
        if cur is None:
            return None
        latest, prev = cur
        if latest < before:
            return latest
        return prev if (prev is not None and prev < before) else None


def accept_greedy(
    proposed: "list[int]", argmaxes: "list[int]"
) -> "tuple[list[int], int]":
    """Greedy acceptance over the verify forward's per-position argmaxes.

    The verify chunk fed ``[y0, p1, .., pK]``; ``argmaxes[i]`` is the
    model's choice after chunk[:i+1].  Accept proposals while they match,
    then append the model's own (always-correct) token at the first
    mismatch — every call yields >= 1 new token.
    Returns (accepted_tokens, n_drafts_accepted)."""
    out: "list[int]" = []
    i = 0
    while i < len(proposed) and argmaxes[i] == proposed[i]:
        out.append(proposed[i])
        i += 1
    out.append(int(argmaxes[i]))  # bonus/correction token
    return out, i
