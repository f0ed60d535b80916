"""Tokenization layer of the port: the mock tokenizer and the registry.
The HF and tiktoken tokenizers wait for a tokenizer file in the repository."""

from smg_tpu_torch.tokenizer.mock import MockTokenizer

__all__ = ["MockTokenizer"]
