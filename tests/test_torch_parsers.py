"""The port's parsers/ and the preprocessor's parser wiring against the JAX
package's.

Every ``TOOL_PARSERS`` and ``REASONING_PARSERS`` key parses the same crafted
texts (the JAX ``tests/test_parsers.py`` cases, plain text, malformed
regions) to the same calls and content; the jail and the reasoning split
give the same ``(kind, payload)`` events when the text arrives in two
chunks split at every character boundary, one character at a time, and in
hypothesis-drawn splits. Tool calls compare by name and arguments (their
ids are random uuids in both packages). Exact equality throughout: the
parsers are string code, there is no tolerance.

The preprocessor: one scripted delta stream (text, token ids, logprobs)
goes through both ``postprocess_chat_stream``s and both ``aggregate_chat``s
with parsers on and off; chunks compare minus ``id``/``created``/tool-call
ids, exactly.
"""

import asyncio
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu import parsers as jparsers
from dynamo_tpu.frontend.preprocessor import OpenAIPreprocessor as JaxPre
from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxTok
from dynamo_tpu_torch import parsers as tparsers
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer

pytestmark = pytest.mark.unit

WEATHER = '{"name": "get_weather", "arguments": {"city": "SF"}}'
# texts every tool parser sees: the reference test cases, each parser's own
# markup, plain text, a malformed region and an unclosed one
TOOL_TEXTS = [
    "just an answer",
    "",
    f"I will check. <tool_call>{WEATHER}</tool_call> done",
    '<TOOLCALL>[{"name": "a", "arguments": {"x": 1}}, '
    '{"name": "b", "parameters": {"y": 2}}]</TOOLCALL>',
    '{"name": "f", "arguments": {"q": "hi"}}',
    '<|python_tag|>{"name": "g", "arguments": {}}',
    '[TOOL_CALLS][{"name": "f", "arguments": {"a": 1}}]',
    '[get_weather(city="SF", unit="F"), refresh()]',
    "[f(a=[1, 2, 3], b=2)]",
    "a <tool_call>not json</tool_call> b",
    '\n  [{"name": "f", "arguments": {}}]',
    '<tool_call>{"name": "f", "arguments": {}}',
    '<|tool_call|>[{"name": "p", "arguments": {"k": "v"}}]<|/tool_call|> tail',
    "<|start|>assistant<|channel|>commentary to=functions.get_weather "
    '<|constrain|>json<|message|>{"city": "SF"}<|call|>',
    f"<tool_call>{WEATHER}</tool_call><tool_call>"
    '{"name": "second", "arguments": {"n": 2}}</tool_call>',
    "text with a < sign and <tool but no call",
]
REASONING_TEXTS = [
    "<think>step one step two</think>the answer",
    "thinking...</think>done",
    "no reasoning at all",
    "<think>unclosed thought",
    "Here is my thought process: hmm. Here is my response: ok",
    "<|channel|>analysis<|message|>think hard<|end|><|start|>assistant"
    "<|channel|>final<|message|>the answer<|return|>",
    "a<think>b</think>c<think>d</think>e",
]


def _calls(calls):
    return [(c.name, c.arguments) for c in calls]


def _events(events):
    return [(k, _calls(p) if k == "tool_calls" else p) for k, p in events]


def _drain_jail(pkg, name, chunks):
    jail = pkg.JailedStream(pkg.make_tool_config(name))
    out = []
    for c in chunks:
        out.extend(jail.feed(c))
    out.extend(jail.finish())
    return _events(out)


def _drain_reasoning(pkg, name, chunks):
    rp = pkg.make_reasoning_parser(name)
    out = [rp.feed(c) for c in chunks]
    out.append(rp.finish())
    return out


def _splits(text):
    """Two chunks at every character boundary, then one char at a time."""
    yield from ([text[:i], text[i:]] for i in range(len(text) + 1))
    yield list(text)


def test_registries_and_exports_match():
    assert list(tparsers.TOOL_PARSERS) == list(jparsers.TOOL_PARSERS)
    assert list(tparsers.REASONING_PARSERS) == list(jparsers.REASONING_PARSERS)
    assert tparsers.__all__ == jparsers.__all__
    for name in jparsers.TOOL_PARSERS:
        assert vars(tparsers.make_tool_config(name)) == vars(
            jparsers.make_tool_config(name))
    assert tparsers.make_tool_config(None) is jparsers.make_tool_config(None) is None
    assert tparsers.make_reasoning_parser(None) is None


@pytest.mark.parametrize("name", list(jparsers.TOOL_PARSERS))
def test_parse_tool_calls_matches(name):
    jcfg, tcfg = jparsers.make_tool_config(name), tparsers.make_tool_config(name)
    for text in TOOL_TEXTS:
        jc, jn = jparsers.parse_tool_calls(text, jcfg)
        tc, tn = tparsers.parse_tool_calls(text, tcfg)
        assert (_calls(tc), tn) == (_calls(jc), jn), (name, text)
        for i, (a, b) in enumerate(zip(tc, jc)):
            ta, ja = a.to_openai(i), b.to_openai(i)
            assert {**ta, "id": None} == {**ja, "id": None}
            assert ta["id"].startswith("call-") and len(ta["id"]) == len(ja["id"])


@pytest.mark.parametrize("name", list(jparsers.TOOL_PARSERS))
def test_jail_events_match_at_every_split(name):
    for text in TOOL_TEXTS:
        for chunks in _splits(text):
            assert _drain_jail(tparsers, name, chunks) == _drain_jail(
                jparsers, name, chunks), (name, chunks)


@pytest.mark.parametrize("name", list(jparsers.REASONING_PARSERS))
def test_reasoning_events_match_at_every_split(name):
    for text in REASONING_TEXTS:
        for chunks in _splits(text):
            assert _drain_reasoning(tparsers, name, chunks) == _drain_reasoning(
                jparsers, name, chunks), (name, chunks)


@given(st.sampled_from(TOOL_TEXTS + REASONING_TEXTS),
       st.lists(st.integers(0, 200), max_size=8),
       st.sampled_from(list(jparsers.TOOL_PARSERS)),
       st.sampled_from(list(jparsers.REASONING_PARSERS)))
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_drawn_splits_match(text, cuts, tool, reasoning):
    cuts = sorted({c % (len(text) + 1) for c in cuts})
    chunks = [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]
    assert _drain_jail(tparsers, tool, chunks) == _drain_jail(jparsers, tool, chunks)
    assert _drain_reasoning(tparsers, reasoning, chunks) == _drain_reasoning(
        jparsers, reasoning, chunks)


def test_marker_matcher_matches():
    for markers in (["<tool_call>"], ["<a>", "<ab>", "</x>"], [""], []):
        for text in ("hello <tool_call>{x}", "abc <tool_", "a <to" "ast", "<a<ab>b</x",
                     "<ab"):
            for chunks in _splits(text):
                jm, tm = jparsers.MarkerMatcher(markers), tparsers.MarkerMatcher(markers)
                assert [tm.feed(c) for c in chunks] == [jm.feed(c) for c in chunks]
                assert tm.flush() == jm.flush()


def test_unknown_names_raise_in_both():
    for make in ("make_tool_config", "make_reasoning_parser"):
        msgs = []
        for pkg in (jparsers, tparsers):
            with pytest.raises(ValueError, match="unknown .* parser 'nope'") as e:
                getattr(pkg, make)("nope")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for pre, tok in ((JaxPre, JaxTok), (OpenAIPreprocessor, MockTokenizer)):
        with pytest.raises(ValueError, match="typo"):
            pre(tok(), model_name="m", tool_call_parser="typo")
        with pytest.raises(ValueError, match="typo"):
            pre(tok(), model_name="m", reasoning_parser="typo")


# ------------------------------------------------------------- preprocessor

TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]
STREAM_TEXT = ("<think>Let me think about the weather.</think>I will check. "
               f"<tool_call>{WEATHER}</tool_call> then done")
# (tool parser, reasoning parser, request extras)
PRE_CASES = {
    "off": (None, None, {}),
    "hermes-tools": ("hermes", None, {"tools": TOOLS}),
    "hermes-no-tools": ("hermes", None, {}),
    "hermes-tool-choice-none": ("hermes", None, {"tools": TOOLS, "tool_choice": "none"}),
    "reasoning": (None, "basic", {}),
    "both": ("hermes", "basic", {"tools": TOOLS}),
    "deepseek-mistral": ("mistral", "deepseek_r1", {"tools": TOOLS}),
}


def _deltas(text, seed, finish="stop"):
    """A scripted backend stream: text cut at seeded points, one to three
    token ids and one logprob entry per token on each delta."""
    rng = random.Random(seed)
    cuts = sorted(rng.sample(range(1, len(text)), 12))
    parts = [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]
    out = []
    for i, part in enumerate(parts):
        n = rng.randint(1, 3)
        ids = [rng.randint(16, 271) for _ in range(n)]
        lps = [{"token": f"t{t}", "logprob": -rng.random(),
                "top": [{"token": "x", "logprob": -0.5}]} for t in ids]
        d = {"text": part, "token_ids": ids, "logprobs": lps}
        if i == len(parts) - 1:
            d["finish_reason"] = finish
        out.append(d)
    return out


async def _aiter(items):
    for x in items:
        yield dict(x)


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


async def _run_pre(pre, deltas, request):
    chunks = [c async for c in pre.postprocess_chat_stream(
        _aiter(deltas), include_usage=True, prompt_tokens=7, request=request)]
    agg = await pre.aggregate_chat(_aiter(deltas), prompt_tokens=7, request=request)
    return _strip(chunks), _strip(agg)


@pytest.mark.parametrize("case", list(PRE_CASES))
@pytest.mark.parametrize("finish", ["stop", "length"])
def test_preprocessor_streams_and_aggregates_match(case, finish):
    tool, reasoning, extra = PRE_CASES[case]
    request = {"messages": [{"role": "user", "content": "hi"}], **extra}
    jpre = JaxPre(JaxTok(), model_name="m", tool_call_parser=tool,
                  reasoning_parser=reasoning)
    tpre = OpenAIPreprocessor(MockTokenizer(), model_name="m", tool_call_parser=tool,
                              reasoning_parser=reasoning)
    text = STREAM_TEXT if case != "deepseek-mistral" else (
        'thinking</think>[{"name": "f", "arguments": {"a": 1}}]')
    for seed in range(4):
        deltas = _deltas(text, seed, finish)
        want = asyncio.run(_run_pre(jpre, deltas, request))
        got = asyncio.run(_run_pre(tpre, deltas, request))
        assert got == want, (case, seed)
        chunks, agg = got
        # no logprob entry is dropped, jailed deltas included
        n_lp = sum(len(c["choices"][0].get("logprobs", {}).get("content", ()))
                   for c in chunks if c["choices"])
        assert n_lp == sum(len(d["token_ids"]) for d in deltas)
        assert chunks[-1]["usage"]["completion_tokens"] == n_lp
    calls = agg["choices"][0]["message"].get("tool_calls")
    if tool is not None and extra.get("tools") and extra.get("tool_choice") != "none":
        assert calls and agg["choices"][0]["finish_reason"] == (
            "tool_calls" if finish == "stop" else "length")
    else:
        assert calls is None


@pytest.mark.parametrize("choice", ["required",
                                    {"type": "function",
                                     "function": {"name": "get_weather"}}])
def test_forced_tool_choice_is_guided_or_refused_like_jax(choice):
    """A forced tool call is a guided request (the engine refuses it with
    the reference's 400 until guided decoding is ported); without a
    tool-call parser, or with a parser of another format, both packages
    raise the same grammar error at preprocessing."""
    body = {"messages": [{"role": "user", "content": "hi"}], "tools": TOOLS,
            "tool_choice": choice}
    for tool in (None, "pythonic"):
        msgs = []
        for pre in (JaxPre(JaxTok(), model_name="m", tool_call_parser=tool),
                    OpenAIPreprocessor(MockTokenizer(), model_name="m",
                                       tool_call_parser=tool)):
            with pytest.raises(ValueError) as e:
                pre.preprocess(body)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs
    want = JaxPre(JaxTok(), model_name="m", tool_call_parser="hermes").preprocess(body)
    got = OpenAIPreprocessor(MockTokenizer(), model_name="m",
                             tool_call_parser="hermes").preprocess(body)
    assert got["guided"] == {"kind": "tool_call",
                             "prompt_len": want["guided"]["prompt_len"]}
    assert want["guided"]["kind"] == "tool_call"
