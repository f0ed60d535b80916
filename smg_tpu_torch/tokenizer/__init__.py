"""Tokenization layer of the port: the HF tokenizer with chat templates
(``hf.py``), the tiktoken-format BPE (``tiktoken.py``), the registry with
its exact and prefix caches, and the mock tokenizer of preset models.  The
gRPC tokenizer bundle (``smg_tpu/tokenizer/bundle.py``) waits for the gRPC
worker."""

from smg_tpu_torch.tokenizer.mock import MockTokenizer

__all__ = ["MockTokenizer"]
