"""Guided decoding in the port (dynamo_tpu_torch/guided/, the masked
sample, the masked decode and verify graphs, the engine's guided schedule)
against the JAX package's.

The grammar half is a copy of the reference's: grammar sources, DFAs,
token masks, cursor walks and error texts must be equal. The engine half
runs both engines on the same weights (the JAX init bridged through
params_from_numpy) with the same vocabulary (``TokenVocab.ascii_json``, as
tests/test_guided.py) and the same requests: greedy streams on the tied
peaked spec (input embedding x32) and seeded temperature-0.8 streams on the
x8 spec must be equal token for token, logprobs within 1e-4, and the
``dynamo_guided_requests_total`` outcomes must move alike. Guided x spec is
held to the port's own spec on/off identity (the reference's golden for it,
``test_guided_spec_greedy_golden_bit_identical``, is red).
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.guided as jg
import dynamo_tpu_torch.guided as tg
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.engine.sampling import sample_tokens_masked as jax_sample_masked
from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxMockTokenizer
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parsers import make_tool_config as jax_tool_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.faults import FAULTS as JAX_FAULTS
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.graphs import DecodeGraphs, VerifyGraphs
from dynamo_tpu_torch.engine.sampling import sample_tokens_masked
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.parsers import make_tool_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.faults import FAULTS as PORT_FAULTS
from test_torch_graphs import SAMPLING, _port_args, _port_sampling, _runner, _setup

pytestmark = pytest.mark.unit

LP_TOL = 1e-4
V = 128
SPEC_KW = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=256, max_pages_per_seq=64,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64),
              pipeline_decode=True, decode_steps_per_dispatch=2)
PEAKED, SAMPLED = 32.0, 8.0  # input-embedding scales (tests/test_torch_engine*.py)
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"enum": [0, 1, 7, 42]},
        "ok": {"type": "boolean"},
    },
    "required": ["name", "age", "ok"],
}
TOOLS = [{"type": "function", "function": {
    "name": "lookup",
    "parameters": {"type": "object",
                   "properties": {"q": {"type": "string", "maxLength": 6}},
                   "required": ["q"]}}}]
MSG = [{"role": "user", "content": "hi"}]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ grammars

# (request, tool-call parser) -> grammar_from_request in both packages:
# the request shapes of tests/test_guided.py, then its refusals
REQUESTS = {
    "json_object": ({"response_format": {"type": "json_object"}}, None),
    "json_schema": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "t", "schema": SCHEMA}}}, None),
    "schema_arrays_anyof": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "t", "schema": {
            "type": "object",
            "properties": {
                "kind": {"enum": ["a", "b"]},
                "vals": {"type": "array", "items": {"type": "number"},
                         "minItems": 1, "maxItems": 3},
                "note": {"anyOf": [{"type": "string"}, {"type": "null"}]}},
            "required": ["kind", "vals", "note"]}}}}, None),
    "schema_boolean": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "b", "schema": {"type": "boolean"}}}}, None),
    "text": ({"response_format": {"type": "text"}}, None),
    "regex_alternation": ({"nvext": {"guided_regex": "yes|no"}}, None),
    "regex_bounded": ({"nvext": {"guided_regex": "[0-9]{3}-[a-z]{4}"}}, None),
    "tool_required": ({"tools": TOOLS, "tool_choice": "required"}, "hermes"),
    "tool_named": ({"tools": TOOLS + [{"type": "function", "function": {"name": "f2"}}],
                    "tool_choice": {"type": "function", "function": {"name": "f2"}}},
                   "hermes"),
    "tool_auto": ({"tools": TOOLS, "tool_choice": "auto"}, "hermes"),
    "err_ref": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "r", "schema": {"$ref": "#/defs/x"}}}}, None),
    "err_not_required": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "r", "schema": {"type": "object", "properties": {"a": {"type": "string"}},
                                "required": []}}}}, None),
    "err_additional": ({"response_format": {"type": "json_schema", "json_schema": {
        "name": "r", "schema": {"type": "object", "additionalProperties": True}}}}, None),
    "err_format_type": ({"response_format": {"type": "yaml"}}, None),
    "err_no_schema": ({"response_format": {"type": "json_schema"}}, None),
    "err_tool_choice_word": ({"tools": TOOLS, "tool_choice": "sometimes"}, "hermes"),
    "err_tool_choice_no_tools": ({"tool_choice": "required"}, "hermes"),
    "err_tool_choice_object": ({"tools": TOOLS, "tool_choice": {"type": "x"}}, "hermes"),
    "err_tool_unknown": ({"tools": TOOLS, "tool_choice": {
        "type": "function", "function": {"name": "nope"}}}, "hermes"),
    "err_tool_no_parser": ({"tools": TOOLS, "tool_choice": "required"}, None),
    "err_tool_pythonic": ({"tools": TOOLS, "tool_choice": "required"}, "pythonic"),
    "err_regex_type": ({"nvext": {"guided_regex": 5}}, None),
    "err_regex_wide": ({"nvext": {"guided_regex": "[ -" + chr(0xFFFF) + "]{64}"}}, None),
    "err_regex_syntax": ({"nvext": {"guided_regex": "(a"}}, None),
}


def _lower(mod, cfg_fn, req, parser):
    """grammar_from_request's answer, or (error type name, text)."""
    try:
        return mod.grammar_from_request(
            req, tool_cfg=cfg_fn(parser) if parser else None)
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", list(REQUESTS))
def test_grammar_from_request_matches_jax(case):
    """Wire grammars (kind, regex, key) and GrammarError texts equal."""
    req, parser = REQUESTS[case]
    want = _lower(jg, jax_tool_config, req, parser)
    got = _lower(tg, make_tool_config, req, parser)
    assert got == want
    assert isinstance(got, tuple) == case.startswith("err_")


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_schema_and_tool_call_regex_match_jax(depth):
    for schema in (SCHEMA, {"type": "array", "items": {"type": "integer"}, "maxItems": 2},
                   {"type": "object", "properties": {}}, {"enum": ["x", 1, None]}):
        assert tg.schema_to_regex(schema, depth) == jg.schema_to_regex(schema, depth)
    assert tg.json_object_regex(depth) == jg.json_object_regex(depth)
    assert tg.json_value_regex(depth) == jg.json_value_regex(depth)
    for name in (None, "lookup"):
        assert (tg.tool_call_regex(TOOLS, make_tool_config("hermes"), name)
                == jg.tool_call_regex(TOOLS, jax_tool_config("hermes"), name))


def _dfa(d, other):
    return (d.start, list(d.accept),
            [{("OTHER" if k is other else k): v for k, v in t.items()} for t in d.trans],
            sorted(d.alphabet, key=repr))


@pytest.mark.parametrize("case", ["json_object", "json_schema", "schema_arrays_anyof",
                                  "regex_alternation", "regex_bounded", "tool_required"])
def test_regex_dfa_equals_jax(case):
    from dynamo_tpu.guided.regex_dfa import OTHER as JAX_OTHER
    from dynamo_tpu_torch.guided.regex_dfa import OTHER

    req, parser = REQUESTS[case]
    src = _lower(jg, jax_tool_config, req, parser)["regex"]
    assert _dfa(tg.compile_regex(src), OTHER) == _dfa(jg.compile_regex(src), JAX_OTHER)


def test_regex_errors_match_jax():
    for bad in ("[", "(a", "a)", "^x", "x$", "a{999999}",
                "".join(chr(0x4E00 + i) for i in range(1100))):
        with pytest.raises(jg.RegexError) as want:
            jg.compile_regex(bad)
        with pytest.raises(tg.RegexError) as got:
            tg.compile_regex(bad)
        assert str(got.value) == str(want.value)


def _vocabs(kind):
    """(JAX vocab, port vocab) of one kind: the tiny ASCII-JSON table, or
    the mock tokenizer's at a model vocabulary of 288 (ids 16..271 bytes)."""
    if kind == "ascii":
        return jg.TokenVocab.ascii_json(V), tg.TokenVocab.ascii_json(V)
    return (jg.TokenVocab.from_tokenizer(JaxMockTokenizer(), 288),
            tg.TokenVocab.from_tokenizer(MockTokenizer(), 288))


@pytest.mark.parametrize("kind", ["ascii", "mock"])
@pytest.mark.parametrize("case", ["json_schema", "regex_bounded", "tool_required"])
def test_token_masks_bitwise_equal_over_visited_states(case, kind):
    """Every state reachable by token walks from the start (breadth
    first, up to 60 states): the same token transitions and bitwise equal
    masks, eos bits included."""
    jv, tv = _vocabs(kind)
    assert tv.tokens == jv.tokens and tv.digest == jv.digest
    req, parser = REQUESTS[case]
    g = _lower(jg, jax_tool_config, req, parser)
    jc = jg.GrammarCompiler(jv, vocab_size=len(jv))
    tc = tg.GrammarCompiler(tv, vocab_size=len(tv))
    js, ts = jc.state_for(g, eos_ids=(2,)), tc.state_for(g, eos_ids=(2,))
    seen, frontier = {js.state}, [js.state]
    while frontier and len(seen) < 60:
        st = frontier.pop(0)
        jm, tm = js.mask_for(st), ts.mask_for(st)
        np.testing.assert_array_equal(tm, jm)
        assert tm.dtype == jm.dtype == bool
        for tok in np.nonzero(tm)[0]:
            nxt = ts.tdfa.step(st, int(tok))
            assert nxt == js.tdfa.step(st, int(tok))
            if nxt is not None and nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    assert len(seen) > 3


def test_cursor_walk_lookahead_and_violation_match_jax():
    jv, tv = _vocabs("ascii")
    g = _lower(jg, jax_tool_config, *REQUESTS["json_schema"])
    text = '{"name":"x","age":7,"ok":true}'
    toks = [tv.tokens.index(ch) for ch in text]
    for prefix in (0, 5, len(toks)):
        js = jg.GrammarCompiler(jv, vocab_size=V).state_for(
            g, eos_ids=(2,), prefix_tokens=toks[:prefix])
        ts = tg.GrammarCompiler(tv, vocab_size=V).state_for(
            g, eos_ids=(2,), prefix_tokens=toks[:prefix])
        assert (ts.state, ts.conformant) == (js.state, js.conformant)
        draft = toks[prefix:prefix + 4] + [tv.tokens.index("]"), 9]
        (jvalid, jmasks), (tvalid, tmasks) = js.lookahead(draft), ts.lookahead(draft)
        assert tvalid == jvalid and len(tmasks) == len(jmasks) == len(tvalid) + 1
        for a, b in zip(tmasks, jmasks):
            np.testing.assert_array_equal(a, b)
        assert ts.state == js.state  # lookahead leaves the cursor alone
    bad = tv.tokens.index("]")
    assert ts.advance(2) == js.advance(2) is True and ts.done
    js = jg.GrammarCompiler(jv, vocab_size=V).state_for(g, eos_ids=(2,))
    ts = tg.GrammarCompiler(tv, vocab_size=V).state_for(g, eos_ids=(2,))
    assert ts.advance(bad) == js.advance(bad) is False
    assert (ts.violated, ts.constraining) == (js.violated, js.constraining) == (True, False)


def test_compiler_lru_snapshot_and_vocab_size_check_match_jax():
    snaps = []
    for mod in (jg, tg):
        comp = mod.GrammarCompiler(mod.TokenVocab.ascii_json(96), vocab_size=96,
                                   cache_entries=2)
        grammars = [mod.grammar_from_request({"response_format": {
            "type": "json_schema", "json_schema": {"name": "x", "schema": {
                "type": "object", "properties": {f"port_lru{i}": {"type": "integer"}},
                "required": [f"port_lru{i}"]}}}}) for i in range(3)]
        for g in grammars:
            comp.compile(g)
        comp.compile(grammars[-1])
        with pytest.raises(ValueError) as e:
            comp.compile({"kind": "regex"})
        snap = comp.snapshot()
        snaps.append(({k: snap[k] for k in ("hits", "evictions", "entries", "errors")},
                      str(e.value)))
        with pytest.raises(ValueError) as e:
            mod.GrammarCompiler(mod.TokenVocab.ascii_json(96), vocab_size=128)
        snaps.append(str(e.value))
    assert snaps[:2] == snaps[2:]
    assert snaps[0][0] == {"hits": 1, "evictions": 1, "entries": 2, "errors": 1}


# ------------------------------------------------------------ sampling


@pytest.mark.parametrize("mode", ["greedy", "sampled", "top_k_top_p"])
def test_sample_tokens_masked_matches_jax(mode):
    """Same logits and masks (rows with few allowed tokens, an all-True
    row, an all-False row): bitwise equal tokens, each allowed."""
    rng = np.random.default_rng(7)
    B = 6
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    allowed = rng.random((B, V)) < 0.05
    allowed[0] = True
    allowed[1] = False
    allowed[2, :] = False
    allowed[2, [5, 90]] = True
    temp = np.full(B, 0.0 if mode == "greedy" else 0.8, np.float32)
    top_k = np.full(B, 3 if mode == "top_k_top_p" else 0, np.int32)
    top_p = np.full(B, 0.9 if mode == "top_k_top_p" else 1.0, np.float32)
    seeds = np.arange(B, dtype=np.uint32) * 977 + 5
    steps = np.arange(B, dtype=np.int32)
    want = np.asarray(jax_sample_masked(
        jnp.asarray(logits), jnp.asarray(allowed), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(seeds), jnp.asarray(steps)))
    got = sample_tokens_masked(
        torch.from_numpy(logits), torch.from_numpy(allowed), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(steps))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 2, 3, 4, 5):
        if allowed[i].any():
            assert allowed[i, int(got[i])]


# ------------------------------------------------ masked step and graphs


def _step_mask(seed=11):
    """A [4, V] mask: sparse rows, an all-True row, and a two-token row."""
    rng = np.random.default_rng(seed)
    m = rng.random((4, V)) < 0.1
    m[1] = True
    m[3, :] = False
    m[3, [7, 100]] = True
    return m


@pytest.mark.parametrize("n_logprobs", [0, 5])
def test_masked_decode_steps_match_jax(n_logprobs):
    """The port's decode_steps(allowed=...) against the reference's: tokens
    identical (greedy and seeded sampled rows), each allowed; masked
    logprobs within 1e-4. The all-True row equals an unmasked step's."""
    (jspec, jp, jk, jv), (tspec, tp, tk, tv), bts, first, seq_lens = _setup()
    s, m = SAMPLING, _step_mask()
    jfn = jax.jit(lambda *a: jllama.decode_steps_impl(
        jspec, *a[:-1], n_steps=1, n_logprobs=n_logprobs, allowed=a[-1]))
    want = jfn(jp, jnp.asarray(first), jnp.asarray(bts), jnp.asarray(seq_lens),
               jk, jv, jnp.asarray(s["active"]), jnp.asarray(s["temperature"]),
               jnp.asarray(s["top_k"]), jnp.asarray(s["top_p"]),
               jnp.asarray(s["seeds"]), jnp.asarray(s["steps"]), jnp.asarray(m))
    pools = [x.clone() for x in (tk, tv)]
    got = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens), *pools,
                             *_port_sampling(), n_steps=1, n_logprobs=n_logprobs,
                             allowed=torch.from_numpy(m))
    free = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens),
                              tk.clone(), tv.clone(), *_port_sampling(), n_steps=1,
                              n_logprobs=n_logprobs)
    if not n_logprobs:
        got, free = (got,), (free,)
    act = s["active"]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for i in np.nonzero(act)[0]:
        assert m[i, int(got[0][i, 0])]
    assert torch.equal(got[0][1], free[0][1])
    if n_logprobs:
        np.testing.assert_allclose(got[1].numpy()[act], np.asarray(want[1])[act],
                                   atol=LP_TOL, rtol=LP_TOL)
        np.testing.assert_array_equal(got[2].numpy()[act], np.asarray(want[2])[act])


@pytest.mark.parametrize("sampled", [False, True])
def test_masked_decode_graphs_eager_route_equals_decode_steps(sampled):
    """The graph runner's masked variant (its CPU route: the captured
    step function over the static tensors and the staged mask) gives
    decode_steps(allowed=...)'s tokens, logprobs and pool bytes exactly;
    it refuses a multi-step masked burst and a runner without a mask."""
    _, (tspec, tp, tk, tv), bts, first, seq_lens = _setup()
    m = _step_mask(3)
    sampling = list(_port_sampling())
    if not sampled:
        sampling[1] = torch.zeros_like(sampling[1])
    k2, v2 = tk.clone(), tv.clone()
    want = llama.decode_steps(tspec, tp, *_port_args(bts, first, seq_lens), k2, v2,
                              *sampling, n_steps=1, n_logprobs=5,
                              allowed=torch.from_numpy(m))
    runner = DecodeGraphs(lambda t, s, n: llama.decode_step_(tspec, tp, tk, tv, t,
                                                             sampled=s, n_logprobs=n),
                          batch=4, pages_per_seq=bts.shape[1], max_steps=2,
                          n_logprobs=5, device=torch.device("cpu"), vocab_size=V)
    assert len(runner.variants()) == 8
    inputs = {"tokens": first, "block_tables": bts, "seq_lens": seq_lens,
              **{k: v.numpy() for k, v in zip(
                  ("active", "temperature", "top_k", "top_p", "seeds", "steps"),
                  sampling)}}
    got = runner.dispatch(inputs, 1, sampled=sampled, n_logprobs=5, allowed=m).result()
    for g, w in zip(got[1:], want):
        np.testing.assert_array_equal(g, w.numpy())
    assert torch.equal(tk, k2) and torch.equal(tv, v2)
    with pytest.raises(ValueError, match="one step"):
        runner.dispatch(inputs, 2, sampled=sampled, n_logprobs=0, allowed=m)
    plain = _runner(tspec, tp, tk, tv, max_steps=1)
    assert len(plain.variants()) == 4
    with pytest.raises(ValueError, match="vocab_size"):
        plain.dispatch(inputs, 1, sampled=sampled, n_logprobs=0, allowed=m)


def test_masked_verify_graphs_eager_route_equals_verify_forward():
    """VerifyGraphs' masked route gives verify_forward(allowed=...)'s
    targets and pool bytes exactly, every target allowed at its position;
    an all-True mask gives the unmasked verify's targets."""
    _, (tspec, tp, tk, tv), bts, first, seq_lens = _setup()
    W, n = 3, 4
    rng = np.random.default_rng(5)
    tokens = np.stack([first, rng.integers(0, V, 4), rng.integers(0, V, 4)], 1)
    tokens = tokens.astype(np.int32)
    starts = (seq_lens - 1).astype(np.int32)
    nts = np.asarray([3, 2, 0, 3], np.int32)
    allowed = rng.random((n, W, V)) < 0.2
    allowed[:, :, 0] = True
    dev = [torch.from_numpy(a) for a in (tokens, bts, starts)]
    k2, v2 = tk.clone(), tv.clone()
    want = llama.verify_forward(tspec, tp, *dev, k2, v2, torch.from_numpy(nts),
                                torch.from_numpy(allowed))
    runner = VerifyGraphs(
        lambda t, b, s, nt, a=None: llama.verify_forward(tspec, tp, t, b, s, tk, tv, nt, a),
        batch=4, width=W, pages_per_seq=bts.shape[1], device=torch.device("cpu"),
        vocab_size=V)
    assert runner.variants() == [(1, False), (2, False), (4, False),
                                 (1, True), (2, True), (4, True)]
    got = runner.dispatch(tokens, bts, starts, nts, allowed).wait()
    assert torch.equal(got, want) and torch.equal(tk, k2) and torch.equal(tv, v2)
    for r in range(n):
        for j in range(nts[r]):
            assert allowed[r, j, int(got[r, j])]
    free = runner.dispatch(tokens, bts, starts, nts, np.ones((n, W, V), bool)).wait()
    plain = runner.dispatch(tokens, bts, starts, nts).wait()
    assert torch.equal(free, plain)
    with pytest.raises(ValueError, match="takes"):
        runner.dispatch(tokens, bts, starts, nts, allowed[:, :2])


# ---------------------------------------------------------- the engines

_WEIGHTS: dict[float, tuple] = {}


def _weights(scale, seed=1):
    if scale not in _WEIGHTS:
        jp = dict(jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed)))
        jp["embed"] = jp["embed"] * scale
        _WEIGHTS[scale] = (jp, params_from_numpy(
            ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp), device="cpu"))
    return _WEIGHTS[scale]


def _engines(scale, vocab=True, **cfg):
    jp, tp = _weights(scale)
    jv, tv = _vocabs("ascii") if vocab else (None, None)
    return (JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**{**CFG_KW, **cfg}),
                      params=jp, guided_vocab=jv),
            InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**{**CFG_KW, **cfg}),
                            params=tp, device="cpu", guided_vocab=tv))


def _grammar(case):
    req, parser = REQUESTS[case]
    return _lower(tg, make_tool_config, req, parser)


def _req(prompt, n, grammar=None, temperature=0.0, seed=None, logprobs=None, **stop):
    req = {"token_ids": list(prompt), "sampling": {"temperature": temperature},
           "stop_conditions": {"max_tokens": n, **stop}}
    if seed is not None:
        req["sampling"]["seed"] = seed
    if logprobs is not None:
        req["output_options"] = {"logprobs": logprobs}
    if grammar is not None:
        req["guided"] = {**grammar, "prompt_len": len(prompt)}
    return req


async def _collect(eng, req, ctx):
    return [x async for x in eng.generate(req, ctx)]


def _tokens(items):
    return [t for x in items for t in x["token_ids"]]


def _outcomes(mod):
    counter = mod.GUIDED_REQUESTS

    def value(child):  # prometheus_client's child, or the port's stdlib one
        return child._value.get() if hasattr(child, "_value") else child.value

    return {o: value(counter.labels(outcome=o))
            for o in ("ok", "truncated", "violation", "aborted", "compile_error",
                      "unavailable")}


async def _both(reqs, scale=PEAKED, vocab=True, **cfg):
    """The same requests, concurrently, through both engines; returns
    (JAX items, port items, JAX outcome deltas, port outcome deltas, port
    engine)."""
    jeng, teng = _engines(scale, vocab, **cfg)
    res = []
    for mod, eng, ctx in ((jg, jeng, JaxContext), (tg, teng, Context)):
        before = _outcomes(mod)
        outs = await asyncio.gather(*(_collect(eng, dict(r), ctx()) for r in reqs))
        after = _outcomes(mod)
        res.append((outs, {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        await eng.close()
    (want, wd), (got, gd) = res
    return want, got, wd, gd, teng


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 90, k).tolist() for k in (7, 13, 5, 10, 16, 9)[:n]]


@pytest.mark.parametrize("case", ["json_schema", "json_object", "regex_bounded",
                                  "tool_required"])
async def test_guided_greedy_streams_match_jax(case):
    """Greedy guided streams on the tied peaked spec: identical tokens,
    finish reasons and outcome counts; first tokens under the start mask;
    every text walks the grammar; nothing leaks."""
    g = _grammar(case)
    want, got, wd, gd, teng = await _both([_req(p, 90, g) for p in _prompts(3)])
    tv = _vocabs("ascii")[1]
    for w, o in zip(want, got):
        assert _tokens(o) == _tokens(w)
        assert o[-1]["finish_reason"] == w[-1]["finish_reason"]
        assert o[0]["token_ids"] == w[0]["token_ids"]
        st = tg.GrammarCompiler(tv, vocab_size=V).state_for(g, eos_ids=(2,))
        assert all(st.advance(t) for t in _tokens(o))
    assert gd == wd and sum(gd.values()) == 3
    assert teng.allocator.active_pages == 0
    if case == "json_schema":
        for o in got:
            assert o[-1]["finish_reason"] == "stop"
            assert set(json.loads(tv.text(_tokens(o)))) == {"name", "age", "ok"}


async def test_guided_sampled_streams_and_logprobs_match_jax():
    """Seeded temperature-0.8 guided streams on the x8 spec, with
    logprobs: identical tokens, logprob entries within 1e-4 (first token
    of the unmasked logits, later ones of the masked, as the reference)."""
    g = _grammar("json_schema")
    reqs = [_req(p, 90, g, temperature=0.8, seed=i + 1, logprobs=3)
            for i, p in enumerate(_prompts(3, seed=1))]
    want, got, wd, gd, _ = await _both(reqs, scale=SAMPLED)
    for w, o in zip(want, got):
        assert _tokens(o) == _tokens(w)
        we = [e for x in w for e in x.get("logprobs", ())]
        ge = [e for x in o for e in x.get("logprobs", ())]
        assert len(ge) == len(we) == len(_tokens(o))
        for a, b in zip(ge, we):
            assert a["id"] == b["id"] and abs(a["logprob"] - b["logprob"]) <= LP_TOL
            assert [t["id"] for t in a["top"]] == [t["id"] for t in b["top"]]
    assert gd == wd


@pytest.mark.parametrize("seed", [1, 7])
async def test_conformance_at_temperature(seed):
    """At temperature 0.9 every completion parses and validates."""
    g = _grammar("json_schema")
    _, teng = _engines(SAMPLED)
    tv = _vocabs("ascii")[1]
    outs = await asyncio.gather(*(
        _collect(teng, _req(p, 300, g, temperature=0.9, seed=seed + i), Context())
        for i, p in enumerate(_prompts(4, seed=seed))))
    for o in outs:
        parsed = json.loads(tv.text(_tokens(o)))
        assert set(parsed) == {"name", "age", "ok"} and parsed["age"] in (0, 1, 7, 42)
        assert isinstance(parsed["ok"], bool) and len(parsed["name"]) <= 8
        assert o[-1]["finish_reason"] == "stop"
    assert teng.allocator.active_pages == 0
    await teng.close()


async def test_outcomes_ok_truncated_violation_counted_like_jax():
    """ok (the grammar completes), truncated (max_tokens cuts it) and
    violation (an eos id outside the vocabulary leaves a finished grammar
    no legal token: the mask fails open and the stream leaves the
    grammar) move the counters as in the reference; min_tokens stops at
    a completed grammar."""
    ok = _grammar("schema_boolean")
    prompts = _prompts(4, seed=3)
    reqs = [_req(prompts[0], 40, ok), _req(prompts[1], 3, _grammar("json_schema")),
            {**_req(prompts[2], 30, _grammar("regex_bounded")), "eos_token_ids": [100000]},
            _req(prompts[3], 64, ok, min_tokens=48)]
    want, got, wd, gd, teng = await _both(reqs)
    assert [_tokens(o) for o in got] == [_tokens(w) for w in want]
    assert [o[-1]["finish_reason"] for o in got] == ["stop", "length", "length", "stop"]
    assert gd == wd == {"ok": 2, "truncated": 1, "violation": 1}
    assert len(_tokens(got[3])) <= 12


async def test_mixed_guided_and_free_slots_share_engine():
    """Guided and free slots share one pipelined engine: every stream
    equals the reference's, and each free stream equals the same request
    served with no guided neighbour."""
    g = _grammar("json_object")
    prompts = _prompts(4, seed=2)
    free = [_req(prompts[i], 24, temperature=0.8, seed=5 + i) for i in (1, 3)]
    reqs = [_req(prompts[0], 60, g, temperature=0.8, seed=4), free[0],
            _req(prompts[2], 60, g), free[1]]
    want, got, _, _, _ = await _both(reqs, scale=SAMPLED)
    assert [_tokens(o) for o in got] == [_tokens(w) for w in want]
    _, alone = _engines(SAMPLED)
    ref = await asyncio.gather(*(_collect(alone, dict(r), Context()) for r in free))
    await alone.close()
    assert [_tokens(o) for o in ref] == [_tokens(got[1]), _tokens(got[3])]


async def test_pipelined_engine_leaves_the_pipeline_while_guided_live():
    """While a constrained slot is live every dispatch is one masked step
    with nothing in flight; free-only batches keep multi-step pipelined
    bursts."""
    _, teng = _engines(PEAKED, decode_steps_per_dispatch=4, pipeline_depth=2)
    seen = []
    dispatch = teng._graphs.dispatch

    def spy(inputs, n_steps, **kw):
        seen.append((teng._guided_live(), n_steps, kw.get("allowed") is not None,
                     len(teng._pipeline)))
        return dispatch(inputs, n_steps, **kw)

    teng._graphs.dispatch = spy
    prompts = _prompts(2, seed=4)
    await _collect(teng, _req(prompts[1], 24, ignore_eos=True), Context())
    await asyncio.gather(_collect(teng, _req(prompts[0], 90, _grammar("json_schema")),
                                  Context()),
                         _collect(teng, _req(prompts[1], 24, ignore_eos=True), Context()))
    await teng.close()
    live = [s for s in seen if s[0]]
    assert live and all(n == 1 and masked and depth == 0 for _, n, masked, depth in live)
    assert any(n > 1 for g, n, _, _ in seen if not g)
    assert any(depth > 0 for g, _, _, depth in seen if not g)


async def test_guided_migration_resume_stitches_the_same_stream():
    """Engine A serves 10 tokens; engine B resumes with prompt + those
    tokens and the original prompt_len: the stitched stream equals one
    uninterrupted run, in the port as in the reference."""
    g = _grammar("json_schema")
    prompt = _prompts(1, seed=4)[0]
    full = {}
    for mod, ctx, make in ((jg, JaxContext, lambda: _engines(PEAKED)[0]),
                           (tg, Context, lambda: _engines(PEAKED)[1])):
        runs = []
        for req in (_req(prompt, 300, g), _req(prompt, 10, g)):
            eng = make()
            runs.append(_tokens(await _collect(eng, req, ctx())))
            await eng.close()
        b = make()
        resume = _req(prompt + runs[1], 300, g)
        resume["guided"]["prompt_len"] = len(prompt)
        rest = _tokens(await _collect(b, resume, ctx()))
        assert b.allocator.active_pages == 0
        await b.close()
        assert runs[1] + rest == runs[0]
        full[mod.__name__] = runs[0]
    assert full["dynamo_tpu_torch.guided"] == full["dynamo_tpu.guided"]


async def test_compile_fault_is_a_typed_400_that_leaks_nothing():
    """The armed engine.guided_compile site: the reference's typed error
    text, no page, no slot, the tenant's quota charge refunded, the
    compile_error outcome counted; the same grammar then serves."""
    schema = {"type": "object", "properties": {"port_fault_probe": {"enum": [1, 2]}},
              "required": ["port_fault_probe"]}
    g = _lower(tg, make_tool_config, {"response_format": {
        "type": "json_schema", "json_schema": {"name": "f", "schema": schema}}}, None)
    jeng, teng = _engines(PEAKED, tenants="*:rate=1,burst=5000")
    errors = []
    for mod, faults, eng, ctx in ((jg, JAX_FAULTS, jeng, JaxContext),
                                  (tg, PORT_FAULTS, teng, Context)):
        faults.configure("engine.guided_compile:error@1.0x1", seed=7)
        try:
            before = _outcomes(mod)
            out = await _collect(eng, _req([5, 6, 7], 8, g), ctx())
            assert [o["finish_reason"] for o in out] == ["error"]
            errors.append(out[0]["error"])
            assert _outcomes(mod)["compile_error"] == before["compile_error"] + 1
            assert eng.allocator.active_pages == 0
            assert not any(s is not None for s in eng._slots)
            assert eng._waiting.bucket_level("default") == pytest.approx(5000.0)
            faults.configure("")
            out = await _collect(eng, _req([5, 6, 7], 300, g), ctx())
            assert out[-1]["finish_reason"] == "stop"
        finally:
            faults.configure("")
            await eng.close()
    assert errors[0].startswith("invalid_request: guided grammar rejected")
    assert errors[1] == errors[0]


@pytest.mark.parametrize("how", ["no_vocab", "mode_off"])
async def test_guided_refused_without_a_compiler_like_jax(how):
    g = _grammar("json_object")
    cfg = {"guided_mode": "off"} if how == "mode_off" else {}
    want, got, wd, gd, teng = await _both([_req([3, 4, 5], 8, g)],
                                          vocab=how == "mode_off", **cfg)
    assert got == want and got[0][0]["error"].startswith(
        "invalid_request: guided decoding unavailable on this worker")
    assert gd == wd == {"unavailable": 1}
    assert teng.guided_snapshot() is None


async def test_guided_spec_on_equals_off():
    """Guided x spec in the port: greedy guided streams with spec_mode
    ngram equal spec-off's token for token, with masked verifies run, on a
    grammar whose output repeats (so prompt-lookup drafts exist)."""
    g = _lower(tg, make_tool_config, {"nvext": {"guided_regex": "(ab|cd){2,30}"}}, None)
    tv = _vocabs("ascii")[1]
    ab = [tv.tokens.index(c) for c in "abcdabab"]
    prompts = [ab * 3 + p for p in _prompts(3, seed=6)]
    outs = {}
    for mode in ("off", "ngram"):
        _, teng = _engines(PEAKED, spec_mode=mode, spec_k_max=4)
        calls = []
        if mode == "ngram":
            dispatch = teng._verify.dispatch
            teng._verify.dispatch = lambda *a: (calls.append(a[4] is not None)
                                                or dispatch(*a))
        res = await asyncio.gather(*(_collect(teng, _req(p, 40, g), Context())
                                     for p in prompts))
        outs[mode] = [_tokens(o) for o in res]
        if mode == "ngram":
            assert teng.spec_verifies > 0 and any(calls) and teng.spec_accepted > 0
        assert teng.allocator.active_pages == 0
        await teng.close()
    assert outs["ngram"] == outs["off"]
    for toks in outs["off"]:
        st = tg.GrammarCompiler(tv, vocab_size=V).state_for(g, eos_ids=(2,))
        assert all(st.advance(t) for t in toks)


def test_guided_slot_is_never_a_preemption_victim():
    """The victim policy skips guided batch slots in both packages: with
    a guided and a free batch stream live, the free one is chosen; with
    only guided ones, none."""
    from dynamo_tpu.engine.core import _Slot as JaxSlot
    from dynamo_tpu_torch.engine.core import _Slot as PortSlot

    picks = []
    for Slot, eng, ctx in ((JaxSlot, _engines(PEAKED)[0], JaxContext),
                           (PortSlot, _engines(PEAKED)[1], Context)):
        def slot(i, guided):
            req = _req([1, 2], 8, _grammar("json_object") if guided else None)
            return Slot(request_id=f"r{i}", context=ctx(), out_q=None, seq=None,
                        pages=None, seq_len=2, remaining=8, priority="batch",
                        request=req, admitted_seq=i,
                        guided=object() if guided else None)
        eng._slots[:2] = [slot(1, False), slot(2, True)]
        picks.append(eng._victim_slot()[0])
        eng._slots[0] = slot(3, True)
        picks.append(eng._victim_slot())
        eng._slots[:] = [None] * len(eng._slots)
    assert picks == [0, None, 0, None]


async def test_worker_builds_its_vocab_from_the_tokenizer():
    """launch_engine_worker builds the TokenVocab from its tokenizer at the
    model's vocabulary size (the reference's worker), and none with
    guided_mode off."""
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    spec = ModelSpec(**{**SPEC_KW, "vocab_size": 288})
    for mode in ("auto", "off"):
        drt = DistributedRuntime(InMemoryHub())
        eng, _ = await launch_engine_worker(
            drt, model_name="m", spec=spec, device="cpu", router_mode="round_robin",
            engine_config=EngineConfig(**CFG_KW, guided_mode=mode))
        if mode == "auto":
            assert eng._guided.vocab.tokens == _vocabs("mock")[0].tokens
            assert eng._graphs.allowed.shape == (4, 288)
        else:
            assert eng._guided is None and eng._graphs.allowed is None
        await eng.close()
        await drt.close()


def test_guided_subpackage_is_under_the_import_guard():
    from test_torch_engine import _port_files

    names = {p.relative_to(p.parents[1]).as_posix() for p in _port_files()}
    assert {f"guided/{m}.py" for m in ("__init__", "vocab", "regex_dfa", "schema",
                                        "runtime")} <= names
    assert tg.__all__ == jg.__all__
