"""The port's frontend operators (dynamo_tpu_torch/frontend/) against the
JAX package's on the same inputs: request preprocessing, edge validation,
the Backend operator's detokenized deltas and stop handling, the migration
operator's resume requests; plus the features this slice refuses."""

import random

import pytest

from dynamo_tpu.frontend.backend_op import Backend as JaxBackend
from dynamo_tpu.frontend.migration import STATS as JAX_STATS
from dynamo_tpu.frontend.migration import Migration as JaxMigration
from dynamo_tpu.frontend.preprocessor import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.frontend.tokenizer import IncrementalDecoder as JaxDecoder
from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxTokenizer
from dynamo_tpu.frontend.validation import RequestValidationError as JaxValidationError
from dynamo_tpu.frontend.validation import validate_request as jax_validate
from dynamo_tpu.frontend.validation import validate_tenancy as jax_tenancy
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.context import StreamError as JaxStreamError
from dynamo_tpu_torch.frontend.backend_op import Backend
from dynamo_tpu_torch.frontend.migration import STATS
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.model_card import ModelDeploymentCard
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.tokenizer import IncrementalDecoder, MockTokenizer, load_tokenizer
from dynamo_tpu_torch.frontend.validation import RequestValidationError
from dynamo_tpu_torch.frontend.validation import validate_request, validate_tenancy
from dynamo_tpu_torch.frontend.watcher import build_pipeline
from dynamo_tpu_torch.runtime.context import Context, StreamError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.hub import InMemoryHub

pytestmark = pytest.mark.unit

CTX_LEN = 64
MSG = [{"role": "user", "content": "hello"}]


def _preprocessors():
    return (JaxPreprocessor(JaxTokenizer(), model_name="m", context_length=CTX_LEN),
            OpenAIPreprocessor(MockTokenizer(), model_name="m", context_length=CTX_LEN))


# --------------------------------------------------------- preprocessing


@pytest.mark.parametrize("body", [
    {"messages": MSG},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": [{"type": "text", "text": "a"},
                                               {"type": "text", "text": "é"}]}],
     "max_tokens": 5},
    {"prompt": "once upon"},
    {"prompt": ["once ", "upon"], "max_tokens": 3},
    {"prompt": "x", "max_tokens": 10_000},  # over the context: clamped
    {"messages": MSG, "max_completion_tokens": 7, "max_tokens": 9},
    {"prompt": "x", "stop": "\n"},
    {"prompt": "x", "stop": ["a", "bc"], "stop_token_ids": [5]},
    {"messages": MSG, "temperature": 0.8, "top_p": 0.9, "top_k": 4, "seed": 11},
    {"messages": MSG, "logprobs": True, "top_logprobs": 3},
    {"messages": MSG, "logprobs": True},
    {"prompt": "x", "logprobs": 2},
    {"prompt": "x", "ignore_eos": True, "min_tokens": 4},
    {"messages": MSG, "nvext": {"annotations": ["a1"]}},
    {"messages": MSG, "response_format": {"type": "text"}, "tool_choice": "auto"},
])
def test_preprocess_matches_jax(body):
    jp, tp = _preprocessors()
    assert tp.preprocess(body) == jp.preprocess(body)


@pytest.mark.parametrize("body", [
    {"prompt": "x" * CTX_LEN},
    {"messages": MSG, "logprobs": True, "top_logprobs": 25},
    {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:x"}}]}]},
    {"messages": [{"role": "user", "content": [{"type": "audio"}]}]},
])
def test_preprocess_refusals_match_jax(body):
    jp, tp = _preprocessors()
    with pytest.raises(ValueError) as want:
        jp.preprocess(body)
    with pytest.raises(ValueError) as got:
        tp.preprocess(body)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("body", [
    {"messages": MSG, "response_format": {"type": "json_object"}},
    {"messages": MSG, "response_format": {
        "type": "json_schema",
        "json_schema": {"name": "t", "schema": {
            "type": "object", "properties": {"a": {"type": "boolean"}}}}}},
    {"prompt": "x", "nvext": {"guided_regex": "[ab]+"}},
])
def test_guided_requests_marked_on_jax_triggers(body):
    """Guided requests are marked with the reference's kind and prompt end;
    no grammar is compiled (the port's engine refuses them)."""
    jp, tp = _preprocessors()
    want, got = jp.preprocess(body), tp.preprocess(body)
    assert got["guided"] == {"kind": want["guided"]["kind"],
                             "prompt_len": want["guided"]["prompt_len"]}
    assert {**got, "guided": None} == {**want, "guided": None}
    forced = {"messages": MSG, "tools": [{"type": "function", "function": {"name": "f"}}],
              "tool_choice": "required"}
    assert tp.preprocess(forced)["guided"]["kind"] == "tool_call"


def test_token_id_prompt_equals_its_text_prompt():
    """A completions prompt of token ids goes to the engine as is: the same
    request as the text whose encoding those ids are."""
    jp, tp = _preprocessors()
    ids = MockTokenizer().encode("the prompt")
    body = {"prompt": ids, "max_tokens": 4, "temperature": 0.5}
    validate_request(body, "completions")
    with pytest.raises(JaxValidationError):
        jax_validate(body, "completions")  # the reference takes text only
    assert tp.preprocess(body) == jp.preprocess({**body, "prompt": "the prompt"})
    with pytest.raises(ValueError, match="context length"):
        tp.preprocess({"prompt": [20] * CTX_LEN})


# ------------------------------------------------------------ validation

_REJECTS = [
    ("chat", {"messages": "hi"}),
    ("chat", {"messages": []}),
    ("chat", {"messages": ["hi"]}),
    ("chat", {"messages": [{"content": "x"}]}),
    ("chat", {"messages": [{"role": "emperor", "content": "x"}]}),
    ("chat", {"messages": [{"role": "user"}]}),
    ("chat", {"messages": [{"role": "user", "content": 7}]}),
    ("chat", {"messages": [{"role": "user", "content": [{"type": "video"}]}]}),
    ("chat", {"messages": [{"role": "user", "content": [{"type": "image_url"}]}]}),
    ("chat", {"messages": MSG, "tools": {}}),
    ("chat", {"messages": MSG, "tools": [{"type": "function", "function": {}}]}),
    ("chat", {"messages": MSG, "temperature": "hot"}),
    ("chat", {"messages": MSG, "temperature": 9.0}),
    ("chat", {"messages": MSG, "max_tokens": 0}),
    ("chat", {"messages": MSG, "top_p": 1.5}),
    ("chat", {"messages": MSG, "stop": ["a", "b", "c", "d", "e"]}),
    ("chat", {"messages": MSG, "stream": "yes"}),
    ("chat", {"messages": MSG, "top_logprobs": 30}),
    ("chat", {"messages": MSG, "logprobs": 3}),
    ("chat", {"messages": MSG, "response_format": {"type": "jsonish"}}),
    ("chat", {"messages": MSG, "response_format": {"type": "json_schema"}}),
    ("chat", {"messages": MSG, "tool_choice": "always"}),
    ("chat", {"messages": MSG, "tool_choice": {"type": "function", "function": {"name": "g"}},
              "tools": [{"type": "function", "function": {"name": "real"}}]}),
    ("completions", {}),
    ("completions", {"prompt": 5}),
    ("completions", {"prompt": ["a", 3]}),
    ("completions", {"prompt": [1, -2]}),
    ("completions", {"prompt": [True]}),
    ("completions", {"prompt": "x", "logprobs": True}),
    ("completions", [1, 2]),
]


@pytest.mark.parametrize("kind,body", _REJECTS)
def test_validation_rejects_like_jax(kind, body):
    with pytest.raises(JaxValidationError) as want:
        jax_validate(body, kind)
    with pytest.raises(RequestValidationError) as got:
        validate_request(body, kind)
    assert (got.value.param, str(got.value)) == (want.value.param, str(want.value))


@pytest.mark.parametrize("headers", [
    {"x-dyn-tenant": "bad tenant!"},
    {"x-dyn-priority": "urgent"},
    {"x-dyn-tenant": "a" * 65},
    {"x-dyn-tenant": "team.a", "x-dyn-priority": "Batch"},
    {"authorization": "Bearer sk-123"},
    {},
])
def test_tenancy_like_jax(headers):
    try:
        want = jax_tenancy(headers)
    except JaxValidationError as e:
        with pytest.raises(RequestValidationError) as got:
            validate_tenancy(headers)
        assert (got.value.param, str(got.value)) == (e.param, str(e))
    else:
        assert validate_tenancy(headers) == want


# ------------------------------------------------- backend and decoder


class _Scripted:
    """A downstream engine replaying scripted items."""

    def __init__(self, items):
        self.items = items

    async def generate(self, request, context):
        for item in self.items:
            yield {k: (list(v) if isinstance(v, list) else v) for k, v in item.items()}


def _ids(text: str) -> list[int]:
    return MockTokenizer().encode(text)


_EURO = _ids("€")  # 3 bytes: split across items below
_BACKEND_CASES = {
    "multibyte split": ([{"token_ids": _ids("a") + _EURO[:1]},
                         {"token_ids": _EURO[1:2]},
                         {"token_ids": _EURO[2:] + _ids("é")[:1]},
                         {"token_ids": _ids("é")[1:], "finish_reason": "length"}], {}),
    "stop string across deltas": ([{"token_ids": _ids("hel")}, {"token_ids": _ids("lo wo")},
                                   {"token_ids": _ids("rld")}, {"token_ids": _ids("!"),
                                                                "finish_reason": "length"}],
                                  {"stop": ["o w", "zz"]}),
    "stop string never hit": ([{"token_ids": _ids("abc")}, {"token_ids": _ids("def"),
                                                            "finish_reason": "length"}],
                              {"stop": ["xyz"]}),
    "eos": ([{"token_ids": _ids("ab")}, {"token_ids": [2] + _ids("c")},
             {"token_ids": _ids("d"), "finish_reason": "length"}], {}),
    "eos ignored": ([{"token_ids": _ids("ab")}, {"token_ids": [2] + _ids("c"),
                                                 "finish_reason": "length"}],
                    {"ignore_eos": True}),
    "stop token id": ([{"token_ids": _ids("xy")}, {"token_ids": _ids("z!q")}],
                      {"stop_token_ids": _ids("!")}),
    "logprobs": ([{"token_ids": _ids("h"), "logprobs": [
                      {"id": _ids("h")[0], "logprob": -0.5,
                       "top": [{"id": _ids("h")[0], "logprob": -0.5},
                               {"id": _ids("j")[0], "logprob": -1.5}]}]},
                  {"token_ids": _ids("i") + [2], "logprobs": [
                      {"id": _ids("i")[0], "logprob": -0.1, "top": []},
                      {"id": 2, "logprob": -3.0, "top": []}]}], {}),
    "error item": ([{"token_ids": _ids("a")},
                    {"token_ids": [], "finish_reason": "error", "error": "boom"}], {}),
}


@pytest.mark.parametrize("case", sorted(_BACKEND_CASES))
async def test_backend_deltas_match_jax(case):
    items, stop = _BACKEND_CASES[case]
    request = {"token_ids": [20], "eos_token_ids": [2],
               "stop_conditions": {"max_tokens": 50, **stop}}

    async def run(backend_cls, tok, ctx):
        out = []
        async for d in backend_cls(tok, _Scripted(items)).generate(dict(request), ctx):
            out.append(d)
        return out

    jctx, tctx = JaxContext(), Context()
    want = await run(JaxBackend, JaxTokenizer(), jctx)
    got = await run(Backend, MockTokenizer(), tctx)
    assert got == want
    assert tctx.is_stopped == jctx.is_stopped  # a stop string stops the request


def test_incremental_decoder_matches_jax():
    text = "naïve €uro 𝄞 clef — done"
    ids = MockTokenizer().encode(text)
    rng = random.Random(0)
    cuts = sorted(rng.sample(range(1, len(ids)), 12))
    pieces = [ids[a:b] for a, b in zip([0, *cuts], [*cuts, len(ids)])]
    jd, td = JaxDecoder(JaxTokenizer()), IncrementalDecoder(MockTokenizer())
    got = [td.push(p) for p in pieces] + [td.flush()]
    assert got == [jd.push(p) for p in pieces] + [jd.flush()]
    assert td.text == text and "�" not in "".join(got)


# -------------------------------------------------------------- migration


class _Flaky:
    """Downstream that dies after ``emit`` tokens on its first ``fails``
    calls, then serves to the end; records every request it gets."""

    def __init__(self, error_cls, fails=1, emit=2, total=6):
        self.error_cls, self.fails, self.emit, self.total = error_cls, fails, emit, total
        self.requests = []

    async def generate(self, request, context):
        self.requests.append(request)
        n = request["stop_conditions"]["max_tokens"]
        if len(self.requests) <= self.fails:
            for i in range(self.emit):
                yield {"token_ids": [30 + i]}
            raise self.error_cls("worker died")
        for i in range(n):
            yield {"token_ids": [40 + i], "finish_reason": "length" if i == n - 1 else None}


async def _migrate(mig_cls, err_cls, ctx, fails):
    down = _Flaky(err_cls, fails=fails)
    mig = mig_cls(down, migration_limit=2, retry_delay_s=0.001, rng=random.Random(0))
    request = {"token_ids": [20, 21, 22], "stop_conditions": {"max_tokens": 6},
               "backend_instance_id": 7}
    items, error = [], None
    try:
        async for item in mig.generate(request, ctx):
            items.append(item)
    except err_cls as e:
        error = str(e)
    return items, down.requests, error


@pytest.mark.parametrize("fails", [1, 2, 3])
async def test_migration_redrives_like_jax(fails):
    """After a stream death the request is re-driven with the generated
    tokens appended, the budget shrunk, the pin dropped and the checksum
    stamped; past the limit the error surfaces. The same as the reference,
    counters included."""
    j0, t0 = dict(JAX_STATS), dict(STATS)
    want = await _migrate(JaxMigration, JaxStreamError, JaxContext("r"), fails)
    got = await _migrate(Migration, StreamError, Context("r"), fails)
    assert got == want
    assert {k: STATS[k] - t0[k] for k in STATS} == {k: JAX_STATS[k] - j0[k] for k in JAX_STATS}
    if fails <= 2:
        assert got[1][-1]["token_ids"] == [20, 21, 22] + [30, 31] * fails
        assert got[0][-1]["finish_reason"] == "length"
    else:
        assert got[2] == "worker died"


async def test_migration_never_retries_a_stopped_request():
    ctx = Context()
    ctx.stop_generating()
    down = _Flaky(StreamError)
    with pytest.raises(StreamError):
        async for _ in Migration(down, retry_delay_s=0.001).generate(
                {"token_ids": [1], "stop_conditions": {"max_tokens": 4}}, ctx):
            pass
    assert len(down.requests) == 1


# ------------------------------------------------------ refused features


async def test_refused_features_raise():
    with pytest.raises(ValueError, match="transformers"):
        load_tokenizer("/models/llama")
    assert isinstance(load_tokenizer(None), MockTokenizer)
    with pytest.raises(NotImplementedError, match="parsers"):
        OpenAIPreprocessor(MockTokenizer(), model_name="m", tool_call_parser="hermes")
    drt = DistributedRuntime(InMemoryHub())
    base = dict(name="m", namespace="ns", component="c", endpoint="e")
    with pytest.raises(NotImplementedError, match="4b"):
        await build_pipeline(drt, ModelDeploymentCard(**base, router_mode="kv"))
    with pytest.raises(NotImplementedError, match="parsers"):
        await build_pipeline(drt, ModelDeploymentCard(**base, reasoning_parser="basic"))
    with pytest.raises(NotImplementedError, match="multimodal"):
        await build_pipeline(drt, ModelDeploymentCard(**base, mm_tokens_per_image=4))
    pipe = await build_pipeline(drt, ModelDeploymentCard(**base))
    assert type(pipe.engine).__name__ == "Backend"
    assert type(pipe.engine.downstream).__name__ == "Migration"
    assert pipe.engine.downstream.downstream is pipe.push_router
    await pipe.close()
    await drt.close()
