"""The port's stdlib HuggingFace tokenizer (dynamo_tpu_torch/frontend/
hf_tokenizer.py, unicode_regex.py, chat_template.py) against the
reference's transformers-backed ``HFTokenizer`` on the same directories.

Each directory is built here with the ``tokenizers`` library: a small BPE
trained on an in-test corpus, one per component set of a published
tokenizer family (llama-3, GPT-2, DeepSeek-V3, Qwen2, Mixtral, o200k, and
a Metaspace + Digits set), saved with a ``tokenizer_config.json`` and a
chat template. Ids, text, ``vocab_size``, ``eos_token_id``, rendered chat
prompts, IncrementalDecoder deltas and guided TokenVocab tables must be
equal: they are integers and strings, so there is no tolerance."""

import json
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models
from tokenizers import normalizers, pre_tokenizers, trainers

from dynamo_tpu.frontend.tokenizer import HFTokenizer as RefTokenizer
from dynamo_tpu.frontend.tokenizer import IncrementalDecoder as RefDecoder
from dynamo_tpu.guided import TokenVocab as RefVocab
from dynamo_tpu_torch.frontend import unicode_regex
from dynamo_tpu_torch.frontend.tokenizer import HFTokenizer, IncrementalDecoder, load_tokenizer
from dynamo_tpu_torch.guided.vocab import TokenVocab

pytestmark = pytest.mark.unit

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                  r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
O200K_PATTERN = "|".join([
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"\p{N}{1,3}", r" ?[^\s\p{L}\p{N}]+[\r\n/]*", r"\s*[\r\n]+", r"\s+(?!\S)", r"\s+"])
DEEPSEEK_PATTERN = (r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+"
                    r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*"
                    r"|\s*[\r\n]+|\s+(?!\S)|\s+")
DEEPSEEK_CJK = "[一-龥\u3040-ゟ゠-ヿ]+"

LLAMA3_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}{% endif %}"
    "{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
# tools, tojson with arguments, raise_exception, {% break %}, {% generation %}
TOOLS_TEMPLATE = """{%- if tools %}
<|system|>Tools:
{%- for tool in tools %}
{{ tool | tojson(indent=2, sort_keys=true) }}
{%- endfor %}
{% endif %}
{%- for m in messages %}
  {%- if m['role'] not in ['system', 'user', 'assistant', 'tool'] %}
    {{- raise_exception('unknown role ' + m['role']) }}
  {%- endif %}
  {%- if m['content'] == 'STOP' %}{% break %}{% endif %}
  {%- if m['role'] == 'assistant' %}
<|assistant|>{% generation %}{{ m['content'] }}{% endgeneration %}{{ eos_token }}
  {%- else %}
<|{{ m['role'] }}|>{{ m['content'] | tojson(separators=(',', ':')) }}
  {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
<|assistant|>
{%- endif %}"""
CHATML_TEMPLATE = """{%- if tools %}
{{- '<|im_start|>system\\n# Tools\\n<tools>' }}
{%- for tool in tools %}
{{- '\\n' }}{{- tool | tojson }}
{%- endfor %}
{{- '\\n</tools><|im_end|>\\n' }}
{%- endif %}
{%- for message in messages %}
{{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
{%- endfor %}
{%- if add_generation_prompt %}
{{- '<|im_start|>assistant\\n' }}
{%- endif %}"""
MIXTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ message['content'] + eos_token}}"
    "{% else %}{{ raise_exception('Only user and assistant roles are supported!') }}"
    "{% endif %}{% endfor %}")
DEEPSEEK_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}{% if m['role'] == 'user' %}"
    "{{ '<｜User｜>' + m['content'] }}{% elif m['role'] == 'assistant' %}"
    "{{ '<｜Assistant｜>' + m['content'] + eos_token }}{% else %}{{ m['content'] }}"
    "{% endif %}{% endfor %}{% if add_generation_prompt %}{{ '<｜Assistant｜><think>\\n' }}"
    "{% endif %}")

TRAIN = [
    "The quick brown fox jumps over the lazy dog. It isn't the dog's fault; "
    "they're tired and we'll see what you've done.",
    "def encode(self, text: str) -> list[int]:\n    return [b + 16 for b in "
    "text.encode('utf-8')]\n\nclass Tokenizer:\n    pass\n",
    "for (int i = 0; i < 1024; ++i) { total += values[i] * 3.14159; }",
    "Numbers 1234567890 and 2024-10-17, prices $19.99 and 100%, ids 0x1F600.",
    "机器学习是人工智能的一个分支。日本語のテキストもあります。カタカナとひらがな。",
    "مرحبا بالعالم، هذه جملة عربية. Ελληνικά κείμενα. Кириллица тоже есть.",
    "Café naïve résumé coöperate — “quotes” and ‘single’ … ellipsis.",
    "Emoji: 😀 👍🏽 👩‍💻 🇯🇵 and ✨ sparkles ✨.",
    "   leading spaces and trailing spaces   \n\n\ttabs\tand\nnewlines\r\n",
    "JSON: {\"name\": \"value\", \"list\": [1, 2, 3], \"nested\": {\"a\": null}}",
    "UPPER CASE WORDS DON'T SHOUT; I'M FINE, YOU'RE FINE, WE'VE LEFT, HE'LL GO, SHE'D SAY.",
] * 3

CORPUS = [
    "", " ", "a", "Hello world", "Hello, world! How are you?",
    "The quick brown fox jumps over the lazy dog.",
    "def f(x):\n    return x ** 2  # square\n",
    "for (int i = 0; i < n; i++) {\n\tsum += a[i];\n}",
    "123 4567 89012345 3.14159 1e-9 0xDEADBEEF",
    "    indented\n\n\n  spaces   ", "trailing spaces   ", "tabs\t\there",
    "a\x1c  b", "\x1c\x1d\x1e\x1f mixed \x1f\n", "non\xa0breaking\xa0space", "\u2003em\u3000ideo",
    "DON'T I'M YOU'RE WE'VE HE'LL SHE'D IT'S", "don't i'm you're",
    "机器学习是人工智能的一个分支", "日本語のテキスト、カタカナ", "한국어 텍스트",
    "مرحبا بالعالم", "e\u0301 combining a\u0308 o\u0302", "Ⓐⓑ circled ¹²³ ½",
    "👩‍💻 👍🏽 🇯🇵 😀😀", "mixed 中文 and English 123",
    "Text with <|eot_id|> inside and <|begin_of_text|>start",
    "<|im_start|>user\nhi<|im_end|>", "<s>[INST] hello [/INST]</s>",
    "<|endoftext|>", "<｜begin▁of▁sentence｜>hello", "<|start|>x<|message|>y<|end|>",
    "a <tool> call </tool>  here", "word<tool>glued", "the cat sat", "catalog scat",
    "then the <extra>  end", "the",
    "\n", "\r\n\r\n", "x" * 300, "ab " * 50, "replacement \ufffd char", "\U0001f600" * 5,
]
MESSAGES = [
    [{"role": "user", "content": "Hello!"}],
    [{"role": "system", "content": "You are terse."},
     {"role": "user", "content": "What is 2+2? Answer with “four”."},
     {"role": "assistant", "content": "four"},
     {"role": "user", "content": "  And 机器学习? 👩‍💻  "}],
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city (°C)",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]


def _bpe(normalizer=None, pre=None, decoder=None, *, byte_level=True, vocab=900,
         specials=(), limit_alphabet=None, **model_kw):
    tok = Tokenizer(models.BPE(**model_kw))
    if normalizer is not None:
        tok.normalizer = normalizer
    if pre is not None:
        tok.pre_tokenizer = pre
    if decoder is not None:
        tok.decoder = decoder
    kw = dict(vocab_size=vocab, show_progress=False, special_tokens=list(specials))
    if byte_level:
        kw["initial_alphabet"] = pre_tokenizers.ByteLevel.alphabet()
    if limit_alphabet:
        kw["limit_alphabet"] = limit_alphabet
    tok.train_from_iterator(TRAIN, trainers.BpeTrainer(**kw))
    return tok


def _save(path, tok, config, *, edit=None, files=()):
    path.mkdir(parents=True, exist_ok=True)
    spec = json.loads(tok.to_str())
    if edit:
        edit(spec)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(config, ensure_ascii=False))
    for name, text in files:
        (path / name).parent.mkdir(parents=True, exist_ok=True)
        (path / name).write_text(text)
    return str(path)


def _llama3(path):
    tok = _bpe(pre=pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        decoder=decoders.ByteLevel())
    names = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
             "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
             "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
             "<|eom_id|>", "<|eot_id|>"]
    tok.add_special_tokens([AddedToken(n, normalized=False, special=True) for n in names])

    def edit(spec):
        spec["model"]["ignore_merges"] = True
    return _save(path, tok, {
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>", "clean_up_tokenization_spaces": True,
        "chat_template": LLAMA3_TEMPLATE}, edit=edit)


def _gpt2(path):
    tok = _bpe(pre=pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True),
               decoder=decoders.ByteLevel())
    tok.add_special_tokens([AddedToken("<|endoftext|>", normalized=False, special=True)])
    # non-special added tokens: stripped, single-word and normalized forms
    tok.add_tokens([AddedToken("<tool>", lstrip=True, rstrip=True, normalized=False),
                    AddedToken("</tool>", single_word=True, normalized=False),
                    AddedToken("cat", single_word=True, normalized=True)])
    return _save(path, tok, {
        "tokenizer_class": "GPT2Tokenizer", "add_prefix_space": False,
        "eos_token": {"__type": "AddedToken", "content": "<|endoftext|>",
                      "lstrip": False, "rstrip": False, "normalized": False,
                      "special": True},
        "chat_template": TOOLS_TEMPLATE})


def _deepseek(path):
    tok = _bpe(pre=pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"\p{N}{1,3}"), "isolated"),
        pre_tokenizers.Split(Regex(DEEPSEEK_CJK), "isolated"),
        pre_tokenizers.Split(Regex(DEEPSEEK_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        decoder=decoders.ByteLevel())
    bos, eos = "<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in (bos, eos)])
    tok.add_tokens([AddedToken(t, normalized=True) for t in ("<｜User｜>", "<｜Assistant｜>")])
    return _save(path, tok, {
        "tokenizer_class": "LlamaTokenizerFast", "bos_token": bos, "eos_token": eos,
        "clean_up_tokenization_spaces": False},
        files=[("chat_template.jinja", DEEPSEEK_TEMPLATE)])


def _qwen2(path):
    tok = _bpe(normalizer=normalizers.NFC(), pre=pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        decoder=decoders.ByteLevel())
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in ("<|endoftext|>", "<|im_start|>", "<|im_end|>")])
    return _save(path, tok, {
        "tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>", "bos_token": None,
        "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
        "chat_template": CHATML_TEMPLATE})


def _mixtral(path):
    tok = _bpe(normalizer=normalizers.Sequence([normalizers.Prepend("▁"),
                                                normalizers.Replace(" ", "▁")]),
               decoder=decoders.Sequence([decoders.Replace("▁", " "),
                                          decoders.ByteFallback(), decoders.Fuse(),
                                          decoders.Strip(" ", 1, 0)]),
               byte_level=False, vocab=500, limit_alphabet=120,
               specials=("<unk>", "<s>", "</s>"), byte_fallback=True,
               unk_token="<unk>", fuse_unk=True)

    def edit(spec):
        # the byte-fallback tokens <0x00>..<0xFF> sit after the specials, as
        # in Mixtral's vocab; <0xF0> is left out so 4-byte characters take
        # the (fused) unk path
        vocab = spec["model"]["vocab"]
        order = sorted(vocab, key=vocab.get)
        byte_toks = [f"<0x{b:02X}>" for b in range(256) if b != 0xF0]
        toks = order[:3] + byte_toks + [t for t in order[3:] if t not in byte_toks]
        spec["model"]["vocab"] = {t: i for i, t in enumerate(toks)}
        spec["pre_tokenizer"] = None
    return _save(path, tok, {
        "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "clean_up_tokenization_spaces": False,
        "chat_template": MIXTRAL_TEMPLATE}, edit=edit)


def _o200k(path):
    tok = _bpe(pre=pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(O200K_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        decoder=decoders.ByteLevel())
    names = ["<|endoftext|>", "<|start|>", "<|end|>", "<|message|>", "<|channel|>",
             "<|return|>", "<|call|>"]
    tok.add_special_tokens([AddedToken(n, normalized=False, special=True) for n in names])
    return _save(path, tok, {
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|return|>",
        "chat_template": [{"name": "default", "template": LLAMA3_TEMPLATE.replace(
            "bos_token + ", "")}, {"name": "tool_use", "template": TOOLS_TEMPLATE}]})


def _metaspace(path):
    tok = _bpe(pre=pre_tokenizers.Sequence([
        pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first", split=True),
        pre_tokenizers.Digits(individual_digits=True)]),
        decoder=decoders.Sequence([decoders.Metaspace(replacement="▁", prepend_scheme="first"),
                                   decoders.ByteFallback(), decoders.Fuse()]),
        byte_level=False, vocab=500, specials=("<unk>", "<s>", "</s>"),
        unk_token="<unk>")
    return _save(path, tok, {
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "chat_template": MIXTRAL_TEMPLATE})


def _gpt2_quirks(path):
    """transformers' own layer: a top-level ByteLevel's add_prefix_space is
    reset to the config's, tokenizer_config.json's added_tokens_decoder
    adds a token, and a named special token that is a plain vocab word
    ("the") becomes a special added token."""
    tok = _bpe(pre=pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True),
               decoder=decoders.ByteLevel(), vocab=700)
    tok.add_special_tokens([AddedToken("<|endoftext|>", normalized=False, special=True)])
    return _save(path, tok, {
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>",
        "bos_token": "the", "added_tokens_decoder": {"700": {
            "content": "<extra>", "lstrip": False, "rstrip": True, "normalized": False,
            "single_word": False, "special": False}}})


SETS = {"llama3": _llama3, "gpt2": _gpt2, "deepseek": _deepseek, "qwen2": _qwen2,
        "mixtral": _mixtral, "o200k": _o200k, "metaspace": _metaspace,
        "gpt2_quirks": _gpt2_quirks}


def build_tokenizer_dir(name, path):
    """Write component set ``name``'s tokenizer files into ``path``."""
    return SETS[name](path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {name: build(root / name) for name, build in SETS.items()}


@pytest.fixture(scope="module")
def pairs(dirs):
    return {name: (RefTokenizer(d), HFTokenizer(d)) for name, d in dirs.items()}


# -------------------------------------------------------------- the regexes


def _lib_members(pattern, text):
    """The characters of ``text`` that the library's engine matches (runs
    of them, so the pieces between stay few)."""
    split = pre_tokenizers.Split(Regex(f"(?:{pattern})+"), behavior="removed")
    kept = set("".join(p for p, _ in split.pre_tokenize_str(text)))
    return set(text) - kept


def test_class_escapes_match_the_library_on_every_codepoint():
    """Every class escape the translator writes holds exactly the library's
    members over every assigned plane (its engine has Unicode 16.0;
    Python's unicodedata 15.0 plus the kept delta). Planes 4-13 are
    unassigned and 15-16 private use: their edges stand for them."""
    cps = [*range(0x40000), *range(0xE0000, 0xE1000), *range(0xF0000, 0xF0100),
           *range(0x10FF00, 0x110000)]
    text = "".join(chr(c) for c in cps if not 0xD800 <= c < 0xE000)
    for pat in (r"\s", r"\d", r"\w", r"\p{L}", r"\p{N}", r"\p{Lu}", r"\p{Ll}", r"\p{Lt}",
                r"\p{Lm}", r"\p{Lo}", r"\p{M}", r"\p{Mn}", r"\p{Mc}", r"\p{P}", r"\p{S}",
                r"\p{Zs}", r"\p{Cc}", r"\p{Co}", r"[^\s\p{L}\p{N}]", r"[\P{N}x]", r"\p{^L}"):
        ours = set("".join(unicode_regex.compile_pattern(f"(?:{pat})+").findall(text)))
        assert ours == _lib_members(pat, text), pat


def test_category_runs_equal_a_full_scan():
    delta = {cp: cat for lo, hi, cat in unicode_regex._UNICODE_16
             for cp in range(lo, hi + 1)}
    runs = []
    for cp in range(0x110000):
        cat = delta.get(cp) or unicodedata.category(chr(cp))
        if runs and runs[-1][2] == cat:
            runs[-1][1] = cp
        else:
            runs.append([cp, cp, cat])
    assert tuple(map(tuple, runs)) == unicode_regex._runs()


@pytest.mark.parametrize("pattern", [LLAMA3_PATTERN, QWEN2_PATTERN, O200K_PATTERN,
                                     DEEPSEEK_PATTERN, DEEPSEEK_CJK])
def test_split_patterns_pre_tokenize_as_the_library(pattern):
    lib = pre_tokenizers.Split(Regex(pattern), "isolated")
    regex = unicode_regex.compile_pattern(pattern)
    for text in CORPUS + TRAIN[:11]:
        want = [p for p, _ in lib.pre_tokenize_str(text)]
        got = [m.group() for m in regex.finditer(text) if m.group()]
        if "".join(got) != text:  # the gaps are pieces too (Isolated)
            got, prev = [], 0
            for m in regex.finditer(text):
                got += [text[prev:m.start()], m.group()]
                prev = m.end()
            got = [g for g in got + [text[prev:]] if g]
        assert got == want, text


def test_the_whitespace_trap():
    """Python's \\s holds U+001C..U+001F; the library's does not."""
    regex = unicode_regex.compile_pattern(LLAMA3_PATTERN)
    assert [m.group() for m in regex.finditer("a\x1c  b")] == ["a", "\x1c", " ", " b"]


@pytest.mark.parametrize("pattern", [r"\p{Han}", r"[[:alpha:]]", r"[a-z&&[^aeiou]]",
                                     r"\X", r"a(?m)b", r"\p{Greek}"])
def test_untranslatable_patterns_raise(pattern):
    with pytest.raises(NotImplementedError):
        unicode_regex.translate(pattern)


# ------------------------------------------------------------ the tokenizers


@pytest.mark.parametrize("name", list(SETS))
def test_encode_decode_and_attributes_match(pairs, name):
    ref, tok = pairs[name]
    assert tok.vocab_size == ref.vocab_size
    assert tok.eos_token_id == ref.eos_token_id
    for text in CORPUS:
        ids = ref.encode(text)
        assert tok.encode(text) == ids, (name, text)
        assert tok.decode(ids) == ref.decode(ids), (name, text)
    # every id alone and past the vocabulary, special ids included; a
    # stream of raw ids with split multi-byte characters
    n = ref.vocab_size + len(ref._tok.get_added_vocab()) + 3
    for i in range(n):
        assert tok.decode([i]) == ref.decode([i]), (name, i)
    ids = list(range(0, n, 7)) + list(range(n - 1, 0, -13))
    assert tok.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("name", list(SETS))
def test_chat_templates_render_equal(pairs, name):
    ref, tok = pairs[name]
    if name == "gpt2_quirks":  # no template: both refuse alike
        with pytest.raises(ValueError, match="chat_template is not set"):
            ref.apply_chat_template(MESSAGES[0])
        with pytest.raises(ValueError, match="chat_template is not set"):
            tok.apply_chat_template(MESSAGES[0])
        return
    convs = MESSAGES if name not in ("mixtral", "metaspace") else [
        MESSAGES[0], MESSAGES[1][1:]]
    for msgs in convs:
        for gen in (True, False):
            for tools in (None, TOOLS):
                want = ref.apply_chat_template(msgs, add_generation_prompt=gen, tools=tools)
                assert tok.apply_chat_template(msgs, add_generation_prompt=gen,
                                               tools=tools) == want
                assert tok.encode(want) == ref.encode(want)


def test_template_exceptions_and_break(pairs):
    import jinja2

    ref, tok = pairs["gpt2"]
    bad = [{"role": "robot", "content": "x"}]
    for t in (ref, tok):
        with pytest.raises(jinja2.exceptions.TemplateError, match="unknown role robot"):
            t.apply_chat_template(bad)
    cut = [{"role": "user", "content": "a"}, {"role": "user", "content": "STOP"},
           {"role": "user", "content": "never"}]
    assert tok.apply_chat_template(cut) == ref.apply_chat_template(cut)
    assert "never" not in tok.apply_chat_template(cut)
    ref, tok = pairs["mixtral"]
    for t in (ref, tok):
        with pytest.raises(jinja2.exceptions.TemplateError, match="alternate"):
            t.apply_chat_template(MESSAGES[1])


@pytest.mark.parametrize("name", list(SETS))
def test_incremental_decoder_streams_the_reference_deltas(pairs, name):
    ref, tok = pairs[name]
    for text in CORPUS[:: 3] + ["é👩‍💻中 " * 3]:
        ids = ref.encode(text)
        for chunk in (1, 2, 5):
            a, b = RefDecoder(ref), IncrementalDecoder(tok)
            for k in range(0, len(ids), chunk):
                assert b.push(ids[k:k + chunk]) == a.push(ids[k:k + chunk]), (name, text)
            assert b.flush() == a.flush()
            assert b.text == a.text


@pytest.mark.parametrize("name", list(SETS))
def test_guided_vocab_tables_equal(pairs, name):
    ref, tok = pairs[name]
    n = ref.vocab_size + 16  # the model's logits may exceed the tokenizer
    want = RefVocab.from_tokenizer(ref, n)
    got = TokenVocab.from_tokenizer(tok, n)
    assert got.tokens == want.tokens and got.digest == want.digest


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(text=st.text(max_size=40))
def test_llama3_any_text_round_trips_as_the_reference(pairs, text):
    ref, tok = pairs["llama3"]
    ids = ref.encode(text)
    assert tok.encode(text) == ids
    assert tok.decode(ids) == ref.decode(ids)


def test_load_tokenizer_resolves_paths_and_mock(dirs):
    assert isinstance(load_tokenizer(dirs["llama3"]), HFTokenizer)
    assert load_tokenizer("mock").vocab_size == 272
    assert not hasattr(HFTokenizer(dirs["llama3"]), "decode_bytes")


@pytest.mark.parametrize("part,value", [
    ("normalizer", {"type": "Lowercase"}),
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": ""}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Han}+"},
                       "behavior": "Isolated", "invert": False}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("model", {"type": "Unigram", "vocab": [["a", 0.0]], "unk_id": 0}),
    ("dropout", 0.1),
])
def test_unread_components_raise(dirs, tmp_path, part, value):
    with open(f"{dirs['llama3']}/tokenizer.json") as f:
        spec = json.load(f)
    if part == "dropout":
        spec["model"]["dropout"] = value
    else:
        spec[part] = value
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError):
        HFTokenizer(str(tmp_path))


def test_sentencepiece_only_directory_raises(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x0a\x00")
    (tmp_path / "tokenizer_config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="tokenizer.model"):
        HFTokenizer(str(tmp_path))
