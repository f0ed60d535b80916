"""HF-format tokenizer wrapper + chat templating — the port's copy of
``smg_tpu/tokenizer/hf.py``: the ``tokenizers`` runtime over
``tokenizer.json`` and jinja2 chat templating, the template read from
``chat_template.jinja`` or ``tokenizer_config.json``.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

from smg_tpu_torch.utils import get_logger

logger = get_logger("tokenizer.hf")


class HFTokenizer:
    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self.path = path
        tok_file = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        self._tok = Tokenizer.from_file(tok_file)
        self._config = {}
        cfg_file = os.path.join(os.path.dirname(tok_file), "tokenizer_config.json")
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                self._config = json.load(f)
        self.chat_template = self._load_chat_template(os.path.dirname(tok_file))
        self.eos_token = self._config.get("eos_token")
        if isinstance(self.eos_token, dict):
            self.eos_token = self.eos_token.get("content")
        self.bos_token = self._config.get("bos_token")
        if isinstance(self.bos_token, dict):
            self.bos_token = self.bos_token.get("content")
        self.eos_token_id = self.token_to_id(self.eos_token) if self.eos_token else None
        self.bos_token_id = self.token_to_id(self.bos_token) if self.bos_token else None
        self._special_ids = {
            tid for tid, tok in enumerate_added_special(self._tok)
        }
        #: special-token strings — atomic in BPE, the safe L1 prefix-cache
        #: boundaries (reference: cache/l1.rs)
        self.all_special_tokens = [
            tok for _, tok in enumerate_added_special(self._tok)
        ]

    def _load_chat_template(self, dirname: str) -> str | None:
        jinja_file = os.path.join(dirname, "chat_template.jinja")
        if os.path.exists(jinja_file):
            with open(jinja_file) as f:
                return f.read()
        t = self._config.get("chat_template")
        if isinstance(t, list):  # multiple named templates
            for entry in t:
                if entry.get("name") == "default":
                    return entry.get("template")
            return t[0].get("template") if t else None
        return t

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def token_to_id(self, token: str) -> int | None:
        return self._tok.token_to_id(token)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(token_ids), skip_special_tokens=skip_special_tokens)

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
        **extra,
    ) -> str:
        if not self.chat_template:
            # simple fallback template
            parts = [f"<|{m['role']}|>\n{_content_to_text(m.get('content'))}" for m in messages]
            if add_generation_prompt:
                parts.append("<|assistant|>\n")
            return "\n".join(parts)
        env = _jinja_env()
        tmpl = env.from_string(self.chat_template)
        msgs = [normalize_message_content(dict(m)) for m in messages]
        return tmpl.render(
            messages=msgs,
            add_generation_prompt=add_generation_prompt,
            tools=tools,
            bos_token=self.bos_token or "",
            eos_token=self.eos_token or "",
            **extra,
        )


def enumerate_added_special(tok) -> list[tuple[int, str]]:
    out = []
    try:
        # tokenizers >= 0.20 exposes the added tokens decoder
        for added in tok.get_added_tokens_decoder().items():
            tid, tok_obj = added
            if getattr(tok_obj, "special", False):
                out.append((tid, tok_obj.content))
    except Exception:
        pass
    return out


@lru_cache(maxsize=1)
def _jinja_env():
    import jinja2

    env = jinja2.Environment(
        loader=jinja2.BaseLoader(),
        trim_blocks=True,
        lstrip_blocks=True,
        extensions=["jinja2.ext.loopcontrols"],
    )
    env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
    env.globals["raise_exception"] = _raise_exception
    env.policies["json.dumps_kwargs"] = {"ensure_ascii": False, "sort_keys": False}
    return env


def _raise_exception(msg: str):
    raise ValueError(f"chat template error: {msg}")


def _content_to_text(content) -> str:
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    # list of parts: join text parts (SGLang "string" content-format detection,
    # reference chat_template.rs:9-116)
    return "".join(
        p.get("text", "") for p in content if isinstance(p, dict) and p.get("type") == "text"
    )


def normalize_message_content(msg: dict) -> dict:
    """Templates written for string content get strings; multimodal part
    lists are preserved for templates that iterate parts."""
    content = msg.get("content")
    if isinstance(content, list):
        if all(isinstance(p, dict) and p.get("type") == "text" for p in content):
            msg["content"] = _content_to_text(content)
    return msg
