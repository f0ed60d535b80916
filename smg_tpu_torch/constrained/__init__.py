"""Grammar-constrained decoding (structured output) — the port's own copy
of ``smg_tpu/constrained`` (pure Python, semantics unchanged).

Reference capability: ``json_schema`` / ``regex`` / ``ebnf`` sampling params
(``sglang_scheduler.proto``; enforced by the engines the reference routes to).
Here: incremental acceptors (JSON machine, regex NFA, EBNF Earley) + vocab
-mask computation.  The engine applies the mask on the single-step decode
path for constrained requests (constraints are inherently sequential — each
step's mask depends on the previous token).
"""

from functools import lru_cache

from smg_tpu_torch.constrained.json_fsm import JsonMachine
from smg_tpu_torch.constrained.token_filter import TokenFilter

__all__ = ["JsonMachine", "TokenFilter", "validate_grammar"]


@lru_cache(maxsize=256)
def _check_regex(pattern: str) -> None:
    from smg_tpu_torch.constrained.regex_fsm import RegexMachine

    RegexMachine(pattern)


@lru_cache(maxsize=256)
def _check_ebnf(grammar: str) -> None:
    from smg_tpu_torch.constrained.ebnf import EbnfMachine

    EbnfMachine(grammar)


def validate_grammar(regex: str | None, ebnf: str | None) -> None:
    """Gateway-side pattern validation: a malformed user pattern must be a
    400 at the front door, not a retried 502 when the worker's submit
    raises.  Raises ValueError (GrammarError is one)."""
    if regex:
        _check_regex(regex)
    if ebnf:
        _check_ebnf(ebnf)
