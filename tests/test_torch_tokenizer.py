"""Parity: the port's tokenizers (``smg_tpu_torch/tokenizer/{hf,cache,
registry,tiktoken}.py``) against ``smg_tpu.tokenizer`` on files the test
writes: a byte-level BPE ``tokenizer.json`` trained here with ``tokenizers``
(Llama-3's special-token names added), Llama-3-style chat templates in
``tokenizer_config.json``, in a named-template list and in
``chat_template.jinja``, and the reference tests' tiktoken ranks file.
Encodings, decodings, rendered templates, L1 boundaries, hits and the
registry's counters must be identical."""

import base64
import json

import numpy as np
import pytest

from smg_tpu.tokenizer import cache as jcache
from smg_tpu.tokenizer import hf as jhf
from smg_tpu.tokenizer import registry as jregistry
from smg_tpu.tokenizer import tiktoken as jtiktoken
from smg_tpu_torch.tokenizer import cache as tcache
from smg_tpu_torch.tokenizer import hf as thf
from smg_tpu_torch.tokenizer import registry as tregistry
from smg_tpu_torch.tokenizer import tiktoken as ttiktoken

SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>", "<|python_tag|>"]
LLAMA3_TEMPLATE = (
    "{{- bos_token }}"
    "{%- if tools %}{{- '<|start_header_id|>system<|end_header_id|>\\n\\nTools: ' "
    "+ (tools | tojson) + '<|eot_id|>' }}{%- endif %}"
    "{%- for message in messages %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n' }}"
    "{%- if message['content'] is string %}{{- message['content'] | trim }}"
    "{%- else %}{%- for part in message['content'] %}{{- '[' + part['type'] + ']' }}"
    "{%- endfor %}{%- endif %}"
    "{{- '<|eot_id|>' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{%- endif %}"
)
CORPUS = [
    "the quick brown fox jumps over the lazy dog", "hello world, how are you today?",
    "tokenizers split text into pieces; pieces map to ids", "système résumé naïve café",
    "def add(a, b):\n    return a + b\n", "numbers 0123456789 and symbols {}[]()<>!?",
] * 4
TINY_RANKS = {  # the reference tests' tiktoken ranks (tests/test_sdk_tokenizer_tiers.py)
    b"h": 0, b"e": 1, b"l": 2, b"o": 3, b" ": 4, b"w": 5, b"r": 6, b"d": 7,
    b"he": 8, b"ll": 9, b"llo": 10, b"hello": 11, b" w": 12, b"or": 13,
    b"ord": 14, b"!": 15, b"a": 16, b"b": 17, b"c": 18,
}


def build_tokenizer_json(path) -> None:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.add_special_tokens(SPECIALS)
    tok.save(str(path / "tokenizer.json"))


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    """Three directories on one tokenizer.json: the template in
    tokenizer_config.json, as a named-template list, and in
    chat_template.jinja (which wins over the config's)."""
    root = tmp_path_factory.mktemp("tok")
    dirs = {}
    for kind in ("config", "named", "jinja"):
        d = root / kind
        d.mkdir()
        build_tokenizer_json(d)
        cfg = {"bos_token": "<|begin_of_text|>",
               "eos_token": {"content": "<|eot_id|>", "special": True}}
        if kind == "config":
            cfg["chat_template"] = LLAMA3_TEMPLATE
        elif kind == "named":
            cfg["chat_template"] = [{"name": "tool_use", "template": "{{ 'tools' }}"},
                                    {"name": "default", "template": LLAMA3_TEMPLATE}]
        else:
            cfg["chat_template"] = "{{ 'overridden by chat_template.jinja' }}"
            (d / "chat_template.jinja").write_text(LLAMA3_TEMPLATE)
        (d / "tokenizer_config.json").write_text(json.dumps(cfg))
        dirs[kind] = d
    return dirs


TEXTS = ["hello world", "the quick brown fox", " leading space and  double", "",
         "système résumé 0123", "<|begin_of_text|>hello<|eot_id|>world<|python_tag|>",
         "def f(x):\n\treturn {x: [1, 2]}\n", "emoji 🦊 and 漢字"]
MESSAGES = [
    [{"role": "user", "content": "hello world"}],
    [{"role": "system", "content": "  be brief  "},
     {"role": "user", "content": [{"type": "text", "text": "what is "},
                                  {"type": "text", "text": "a fox?"}]},
     {"role": "assistant", "content": "an animal"},
     {"role": "user", "content": "and a dog?"}],
    [{"role": "user", "content": [{"type": "text", "text": "see"},
                                  {"type": "image_url", "image_url": {"url": "x"}}]}],
]
TOOLS = [{"type": "function", "function": {"name": "get_weather",
                                           "parameters": {"city": "Zürich"}}}]


@pytest.mark.parametrize("kind", ["config", "named", "jinja"])
def test_hf_tokenizer_is_identical_to_the_reference(tok_dirs, kind):
    d = str(tok_dirs[kind])
    ref, got = jhf.HFTokenizer(d), thf.HFTokenizer(d)
    for attr in ("chat_template", "eos_token", "bos_token", "eos_token_id", "bos_token_id",
                 "all_special_tokens", "vocab_size"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got._special_ids == ref._special_ids
    assert thf.enumerate_added_special(got._tok) == jhf.enumerate_added_special(ref._tok)
    for text in TEXTS:
        for special in (False, True):
            ids = got.encode(text, add_special_tokens=special)
            assert ids == ref.encode(text, add_special_tokens=special)
            for skip in (False, True):
                assert got.decode(ids, skip_special_tokens=skip) == ref.decode(
                    ids, skip_special_tokens=skip)
    for msgs in MESSAGES:
        for gen in (False, True):
            for tools in (None, TOOLS):
                text = got.apply_chat_template(msgs, add_generation_prompt=gen, tools=tools)
                assert text == ref.apply_chat_template(msgs, add_generation_prompt=gen,
                                                       tools=tools)
    # the template error surface and the file path form
    bad = thf.HFTokenizer(d)
    bad.chat_template = "{{ raise_exception('no system role') }}"
    with pytest.raises(ValueError, match="chat template error: no system role"):
        bad.apply_chat_template(MESSAGES[0])
    single = thf.HFTokenizer(str(tok_dirs[kind] / "tokenizer.json"))
    assert single.chat_template == ref.chat_template


def test_fallback_template_and_content_normalisation(tok_dirs, tmp_path):
    d = tmp_path / "plain"
    d.mkdir()
    build_tokenizer_json(d)
    ref, got = jhf.HFTokenizer(str(d)), thf.HFTokenizer(str(d))
    assert got.chat_template is None and got.eos_token is None
    for msgs in MESSAGES + [[{"role": "user", "content": None}]]:
        assert got.apply_chat_template(msgs) == ref.apply_chat_template(msgs)
    for m in MESSAGES[1] + MESSAGES[2]:
        assert thf.normalize_message_content(dict(m)) == jhf.normalize_message_content(dict(m))


@pytest.mark.parametrize("seed", range(4))
def test_l1_boundaries_lookup_and_seed_are_identical(seed):
    rng = np.random.default_rng(seed)
    specials = ["<|eot_id|>", "<|start_header_id|>", "<s>", ""]
    pieces = ["<|eot_id|>", "<|start_header_id|>", "<s>", "ab", "c", " ", "xyz<", "|"]
    texts = ["".join(rng.choice(pieces, size=rng.integers(1, 30))) for _ in range(30)]
    for text in texts:
        assert tcache.find_boundaries(text, specials) == jcache.find_boundaries(text, specials)
    encode = lambda s: [ord(c) for c in s]  # noqa: E731 — splice-safe everywhere
    caches = (jcache.L1PrefixCache(specials, max_entries=8, min_prefix_chars=4),
              tcache.L1PrefixCache(specials, max_entries=8, min_prefix_chars=4))
    for text in texts + texts[::-1]:
        hits = [c.lookup(text) for c in caches]
        assert hits[0] == hits[1]
        for c in caches:
            c.seed(text, encode, full_ids=encode(text))
        assert caches[0].stats() == caches[1].stats()
    assert caches[1].stats()["hits"] > 0


def test_l1_poisons_itself_on_an_unsafe_boundary():
    """A tokenizer whose pieces cross a special token's end: the splice
    check fails once and the cache disables itself, in both."""
    def encode(s):
        return [ord(c) for c in s.replace("<s>x", "\x01")]

    text = "a long system prompt<s>x and the rest"
    for mod in (jcache, tcache):
        c = mod.L1PrefixCache(["<s>"], min_prefix_chars=4)
        c.seed(text, encode, full_ids=encode(text))
        assert not c.active and c.stats()["entries"] == 0


class _SpecialsTok:
    """A splice-safe character tokenizer declaring Llama-3's specials."""

    all_special_tokens = SPECIALS

    def encode(self, text, add_special_tokens=False):
        out, i = [], 0
        while i < len(text):
            for j, s in enumerate(SPECIALS):
                if text.startswith(s, i):
                    out.append(1000 + j)
                    i += len(s)
                    break
            else:
                out.append(ord(text[i]))
                i += 1
        return out


@pytest.mark.parametrize("tok_kind", ["hf", "specials", "none"])
def test_registry_l0_and_l1_tiers_are_identical(tok_dirs, tok_kind):
    if tok_kind == "hf":
        toks = (jhf.HFTokenizer(str(tok_dirs["config"])),
                thf.HFTokenizer(str(tok_dirs["config"])))
    elif tok_kind == "specials":
        toks = (_SpecialsTok(), _SpecialsTok())
    else:
        from smg_tpu.tokenizer import MockTokenizer as JMock
        from smg_tpu_torch.tokenizer import MockTokenizer as TMock

        toks = (JMock(), TMock())  # no special tokens: no L1 tier
    regs = (jregistry.TokenizerRegistry(l0_cache_size=4, l1_cache_size=2),
            tregistry.TokenizerRegistry(l0_cache_size=4, l1_cache_size=2))
    for reg, tok in zip(regs, toks):
        reg.register("m", tok, default=True)
    system = "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\nbe brief<|eot_id|>"
    turns = [system + f"<|start_header_id|>user<|end_header_id|>\n\nw{i} hello<|eot_id|>"
             for i in range(6)]
    if tok_kind == "none":
        turns = [f"w{i} w{i + 1} w5" for i in range(6)]
    for text in turns + turns[:2] + turns[::-1]:
        for model in ("m", None, "other"):
            assert regs[1].encode_cached(model, text) == regs[0].encode_cached(model, text)
    assert (regs[1].cache_hits, regs[1].cache_misses) == (regs[0].cache_hits,
                                                         regs[0].cache_misses)
    l1 = [reg._l1_for(tok) for reg, tok in zip(regs, toks)]
    assert (l1[1] is None) == (l1[0] is None) == (tok_kind == "none")
    if l1[0] is not None:
        assert l1[1].stats() == l1[0].stats() and l1[1].stats()["hits"] > 0


@pytest.fixture()
def ranks_file(tmp_path):
    p = tmp_path / "tiny.tiktoken"
    with open(p, "wb") as f:
        for tok, rank in TINY_RANKS.items():
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")
    return str(p)


@pytest.mark.parametrize("pattern", ["CL100K_PATTERN", "O200K_PATTERN"])
def test_tiktoken_is_identical_to_the_reference(ranks_file, pattern):
    specials = {"<|endoftext|>": 100, "<|sep|>": 101}
    ref = jtiktoken.TiktokenTokenizer(ranks_file, getattr(jtiktoken, pattern), specials)
    got = ttiktoken.TiktokenTokenizer(ranks_file, getattr(ttiktoken, pattern), specials)
    assert getattr(ttiktoken, pattern) == getattr(jtiktoken, pattern)
    assert got.ranks == ref.ranks and got.vocab_size == ref.vocab_size
    assert (got.eos_token, got.eos_token_id) == (ref.eos_token, ref.eos_token_id)
    assert got.all_special_tokens == ref.all_special_tokens
    for text in ["hello world!", "held", "hello<|sep|>world", "<|endoftext|>", "abc cab",
                 "word order!<|sep|><|endoftext|>hello", ""]:
        ids = got.encode(text)
        assert ids == ref.encode(text)
        for skip in (False, True):
            assert got.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip)
    for piece in (b"hello", b"held", b"worldd", b"ab"):
        assert ttiktoken.bpe_merge(piece, got.ranks) == jtiktoken.bpe_merge(piece, ref.ranks)
    for t in ("hello", "<|sep|>", "zz"):
        assert got.token_to_id(t) == ref.token_to_id(t)
    with pytest.raises(ValueError, match="not in vocabulary"):
        got.encode("xyz")
    with pytest.raises(ValueError, match="not in vocabulary"):
        ref.encode("xyz")
