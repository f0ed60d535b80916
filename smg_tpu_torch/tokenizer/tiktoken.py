"""Tiktoken-format BPE tokenizer — the port's copy of
``smg_tpu/tokenizer/tiktoken.py``, a byte-pair encoder written out in full
(no tiktoken library is used):

- rank file: one ``<base64 token bytes> <rank>`` per line (the published
  ``*.tiktoken`` format, e.g. cl100k_base.tiktoken);
- pre-tokenization by the model's regex split pattern (``regex`` module for
  unicode property classes);
- per-piece byte-pair merging: repeatedly merge the adjacent pair with the
  lowest rank (tiktoken's algorithm — ranks ARE merge priorities).

Special tokens are atomic: they are matched before pre-tokenization and
never split, which is also what makes them safe L1 prefix-cache boundaries
(``cache.py``).
"""

from __future__ import annotations

import base64

# cl100k_base / o200k_base split patterns (published in tiktoken)
CL100K_PATTERN = (
    r"'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
)
O200K_PATTERN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
    r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def load_ranks(path: str) -> dict[bytes, int]:
    ranks: dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def bpe_merge(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Tiktoken merge: start from bytes, repeatedly merge the adjacent pair
    with the smallest rank until no mergeable pair remains."""
    if piece in ranks:
        return [ranks[piece]]
    parts = [piece[i:i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    out = []
    for p in parts:
        if p not in ranks:
            raise ValueError(f"byte sequence {p!r} not in vocabulary")
        out.append(ranks[p])
    return out


class TiktokenTokenizer:
    def __init__(self, ranks_path: str, pattern: str = CL100K_PATTERN,
                 special_tokens: dict[str, int] | None = None,
                 eos_token: str | None = "<|endoftext|>"):
        import regex

        self.ranks = load_ranks(ranks_path)
        self.pattern = regex.compile(pattern)
        self.special_tokens = dict(special_tokens or {})
        self._decode_table: dict[int, bytes] = {
            rank: tok for tok, rank in self.ranks.items()
        }
        for s, tid in self.special_tokens.items():
            self._decode_table[tid] = s.encode()
        self.vocab_size = (
            max(self._decode_table) + 1 if self._decode_table else 0
        )
        self.eos_token = eos_token if eos_token in self.special_tokens else None
        self.eos_token_id = self.special_tokens.get(eos_token)
        self.bos_token_id = None
        self.chat_template = None
        self._special_sorted = sorted(self.special_tokens, key=len, reverse=True)

    # registry surface (mirrors HFTokenizer)

    @property
    def all_special_tokens(self) -> list[str]:
        return list(self.special_tokens)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        out: list[int] = []
        for segment, special in self._split_specials(text):
            if special:
                out.append(self.special_tokens[segment])
                continue
            for piece in self.pattern.findall(segment):
                out.extend(bpe_merge(piece.encode("utf-8"), self.ranks))
        return out

    def _split_specials(self, text: str):
        """Yield (segment, is_special) with special tokens atomic."""
        if not self.special_tokens:
            if text:
                yield text, False
            return
        i = 0
        while i < len(text):
            next_pos = None
            next_tok = None
            for s in self._special_sorted:
                p = text.find(s, i)
                if p != -1 and (next_pos is None or p < next_pos):
                    next_pos, next_tok = p, s
            if next_pos is None:
                yield text[i:], False
                return
            if next_pos > i:
                yield text[i:next_pos], False
            yield next_tok, True
            i = next_pos + len(next_tok)

    def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        special_ids = set(self.special_tokens.values())
        parts = []
        for t in token_ids:
            if skip_special_tokens and t in special_ids:
                continue
            b = self._decode_table.get(int(t))
            if b is not None:
                parts.append(b)
        return b"".join(parts).decode("utf-8", "replace")

    def token_to_id(self, token: str) -> int | None:
        if token in self.special_tokens:
            return self.special_tokens[token]
        return self.ranks.get(token.encode())
