"""Draft-model speculative proposer — port of ``smg_tpu/engine/draft.py``.

The draft model is a second, smaller decoder that shares the target's
page-table geometry: one paged KV cache of its own
(``[L_draft, P, ps, K_draft*D_draft]``) indexed by the scheduler's per-request
page rows, so no extra allocator or page bookkeeping exists.

Context discipline: the draft cache lazily mirrors the committed token
stream.  ``ensure_context`` prefills whatever committed range the draft has
not seen (``req.draft_len .. seq_len``) through the model's prefill path (the
prefill kernel on the card); ``propose`` then feeds the last committed token
and rolls k greedy single-token forwards (the compat decode, torch attention
ops as in the reference's XLA path).  Draft KV written for rejected
proposals lands past the committed ``seq_len`` and is overwritten by the
next ``ensure_context``.  Draft state never affects correctness (the target
verify gates every token); it only affects the acceptance rate.
"""

from __future__ import annotations

import numpy as np
import torch

from smg_tpu_torch.engine.runner import _to_device, resolve_device
from smg_tpu_torch.models.llama import LlamaModel, torch_dtype


class DraftRunner:
    """Single-device draft proposer, built on the engine's device over
    ``params`` (the port's parameter dict; the engine makes random ones
    from ``draft_seed``).  The target's own weights make every draft the
    target's greedy pick."""

    def __init__(self, model_cfg, num_pages: int, page_size: int, params: dict,
                 dtype: str = "float32", device=None, max_prefill_tokens: int = 256,
                 attention: str = "kernel"):
        self.model_cfg = model_cfg
        self.ps = page_size
        # chunk bound for ensure_context, the engine's prefill budget
        self.max_prefill_tokens = max_prefill_tokens
        self.device = resolve_device(device)
        self.model = LlamaModel(model_cfg, _to_device(params, self.device),
                                attention=attention)
        KD = model_cfg.num_kv_heads * model_cfg.head_dim
        shape = (model_cfg.num_layers, num_pages, page_size, KD)
        self.k_cache = torch.zeros(shape, dtype=torch_dtype(dtype), device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)
        # prefill forward calls (each runs the prefill kernel once per draft
        # layer on the card) and propose calls / their decode steps
        self.stats = dict(prefill_calls=0, prefill_tokens=0, propose_calls=0,
                          propose_steps=0)

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def prefill(self, token_ids: list[int], prefix_len: int, page_table: np.ndarray) -> None:
        """Write the draft KV of ``token_ids`` at ``prefix_len ..``."""
        t = len(token_ids)
        if t == 0:
            return
        self.model.forward_prefill(
            self._i32(token_ids), self._i32([prefix_len]), self._i32([t]),
            self.k_cache, self.v_cache, self._i32(page_table), compute_logits=False)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += t

    def ensure_context(self, req, page_table: np.ndarray) -> None:
        """Mirror the committed stream [req.draft_len, req.seq_len) into the
        draft cache, in chunks of at most ``max_prefill_tokens``."""
        all_ids = req.all_token_ids
        start = req.draft_len
        while start < req.seq_len:
            chunk = all_ids[start: min(start + self.max_prefill_tokens, req.seq_len)]
            self.prefill(chunk, start, page_table)
            start += len(chunk)
        req.draft_len = req.seq_len

    def propose(self, last_token: int, position: int, page_table: np.ndarray,
                k: int) -> list[int]:
        """k greedy draft tokens continuing after ``last_token`` (fed at
        ``position``, writing draft KV for it and the first k - 1 drafts).
        The tokens chain on the device; one fetch at the end."""
        if k <= 0:
            return []
        tok = torch.tensor([last_token], dtype=torch.int64, device=self.device)
        pos = torch.tensor([position], dtype=torch.int32, device=self.device)
        pt = self._i32(page_table)[None]
        drafts = []
        for _ in range(k):
            logits = self.model.forward_decode(tok, pos, self.k_cache, self.v_cache, pt)
            tok = torch.argmax(logits, dim=-1)
            drafts.append(tok)
            pos = pos + 1
        self.stats["propose_calls"] += 1
        self.stats["propose_steps"] += k
        return torch.cat(drafts).tolist()
