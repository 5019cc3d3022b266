"""The port's InferenceEngine (dynamo_tpu_torch/engine/core.py) against the
JAX package's, plus its serving contract and the port's import boundary.

Both engines get the same weights (the JAX init, bridged through
params_from_numpy) on a peaked f32 tiny spec, so greedy streams must be
identical token for token. The port runs on the CPU (``device="cpu"``).
"""

import ast
import asyncio
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.engine.core import InferenceEngine as JaxEngine
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
SPEC_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype="float32")
CFG_KW = dict(page_size=4, num_pages=96, max_pages_per_seq=16,
              max_decode_slots=4, prefill_buckets=(8, 16, 32, 64))
EMBED_SCALE = 32.0  # peaked logits (tests/test_quant_goldens.py)
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "xxhash", "aiohttp", "msgpack",
             "prometheus_client", "ml_dtypes", "yaml", "transformers", "tokenizers",
             "uvloop")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _weights(seed=0):
    jp = jllama.init_params(JaxSpec(**SPEC_KW), jax.random.PRNGKey(seed))
    jp = dict(jp)
    jp["embed"] = jp["embed"] * EMBED_SCALE
    return jp, params_from_numpy(ModelSpec(**SPEC_KW), jax.tree.map(np.asarray, jp),
                                 device="cpu")


def _engine(params=None, **cfg):
    return InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**{**CFG_KW, **cfg}),
                           params=params, device="cpu")


def _req(tokens, n, **stop):
    return {"token_ids": list(tokens),
            "stop_conditions": {"max_tokens": n, "ignore_eos": True, **stop}}


async def _collect(eng, req, ctx):
    return [x async for x in eng.generate(req, ctx)]


def _tokens(items):
    return [t for x in items for t in x["token_ids"]]


async def test_greedy_streams_match_jax_engine():
    jp, tp = _weights(seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).tolist() for n in (5, 13, 9, 22, 3, 17)]
    prompts.append(prompts[3][:16] + [7, 8])  # shares 4 pages with prompt 3
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW), params=jp)
    teng = _engine(tp)
    want = await asyncio.gather(*(
        _collect(jeng, _req(p, 10), JaxContext()) for p in prompts))
    got = await asyncio.gather(*(
        _collect(teng, _req(p, 10), Context()) for p in prompts))
    await jeng.close()
    await teng.close()
    for w, g in zip(want, got):
        assert _tokens(g) == _tokens(w)
        assert len(_tokens(g)) == 10 and g[-1]["finish_reason"] == "length"
    assert teng.allocator.active_pages == 0


async def test_fp8_greedy_streams_match_jax_engine(monkeypatch):
    """kv_dtype="fp8" on both engines: identical greedy streams, the
    prefix-sharing prompt included. The reference runs its Pallas decode
    kernels (interpret mode), the route the port's kernels follow."""
    monkeypatch.setenv("DYNAMO_PALLAS", "1")
    jp, tp = _weights(seed=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n).tolist() for n in (6, 13, 21, 9)]
    prompts.append(prompts[2][:16] + [5, 9, 1])  # shares 4 pages with prompt 2
    jeng = JaxEngine(JaxSpec(**SPEC_KW), JaxEngineConfig(**CFG_KW, kv_dtype="fp8"),
                     params=jp)
    teng = _engine(tp, kv_dtype="fp8")
    assert teng.kv_dtype == "fp8" and teng.pool_bytes == sum(
        p.vals.nbytes + p.scale.nbytes for p in (teng.k_pages, teng.v_pages))
    # four concurrent streams, then the sharer once its prefix is sealed
    want = await asyncio.gather(*(
        _collect(jeng, _req(p, 8), JaxContext()) for p in prompts[:4]))
    want.append(await _collect(jeng, _req(prompts[4], 8), JaxContext()))
    got = await asyncio.gather(*(
        _collect(teng, _req(p, 8), Context()) for p in prompts[:4]))
    got.append(await _collect(teng, _req(prompts[4], 8), Context()))
    await jeng.close()
    await teng.close()
    for w, g in zip(want, got):
        assert _tokens(g) == _tokens(w)
        assert len(_tokens(g)) == 8 and g[-1]["finish_reason"] == "length"
    assert teng.cached_prompt_tokens == 16
    assert teng.allocator.active_pages == 0


async def test_prefix_cache_hit_reuses_sealed_pages():
    eng = _engine()
    prompt = list(range(10, 26))  # 16 tokens = 4 pages
    first = await _collect(eng, _req(prompt + [90], 4), Context())
    assert eng.cached_prompt_tokens == 0
    second = await _collect(eng, _req(prompt + [90], 4), Context())
    assert eng.cached_prompt_tokens == 16
    # a fully cached prompt keeps its last token uncached (prefill needs
    # the last position's logits): 12 tokens come from the cache
    await _collect(eng, _req(prompt, 4), Context())
    assert eng.cached_prompt_tokens == 16 + 12
    assert _tokens(first) == _tokens(second)
    assert eng.allocator.active_pages == 0
    await eng.close()


async def test_cancellation_releases_pages():
    eng = _engine()
    ctx = Context()
    got = []
    async for item in eng.generate(_req([1, 2, 3, 4, 5], 10_000), ctx):
        got.append(item)
        if len(got) == 3:
            ctx.stop_generating()
    assert got[-1]["finish_reason"] == "cancelled"
    assert eng.allocator.active_pages == 0
    assert all(s is None for s in eng._slots)
    await eng.close()


async def test_refusals():
    eng = _engine()
    out = await _collect(eng, {"token_ids": []}, Context())
    assert out == [{"token_ids": [], "finish_reason": "error",
                    "error": "empty token_ids"}]
    big = {"token_ids": list(range(4 * 16))}  # == max_context (64)
    out = await _collect(eng, big, Context())
    assert out[0]["finish_reason"] == "error" and "max context" in out[0]["error"]
    # an uncached tail longer than one prefill chunk is served in chunks,
    # never refused or cut: the stream equals a one-shot prefill's
    eng2 = _engine(max_prefill_chunk_tokens=16)
    out = await _collect(eng2, _req(range(20), 4), Context())
    assert out[-1]["finish_reason"] == "length"
    assert _tokens(out) == _tokens(await _collect(eng, _req(range(20), 4), Context()))
    assert eng2.allocator.active_pages == 0
    # a chunk that would start mid-page is refused at construction
    with pytest.raises(ValueError, match="page_size"):
        _engine(max_prefill_chunk_tokens=18)
    await eng.close()
    await eng2.close()


async def test_stop_rules():
    eng = _engine()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    base = _tokens(await _collect(eng, _req(prompt, 6), Context()))
    # a stop token ends the stream with "stop", the token included
    out = await _collect(eng, _req(prompt, 6, stop_token_ids=[base[2]]), Context())
    k = base.index(base[2])
    assert _tokens(out) == base[: k + 1] and out[-1]["finish_reason"] == "stop"
    # eos counts unless ignore_eos
    req = {"token_ids": prompt, "eos_token_ids": [base[0]],
           "stop_conditions": {"max_tokens": 6}}
    out = await _collect(eng, req, Context())
    assert _tokens(out) == base[:1] and out[-1]["finish_reason"] == "stop"
    await eng.close()


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(ModelSpec(**SPEC_KW), EngineConfig(**CFG_KW))


def _port_files():
    return sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_or_reference_package():
    """AST guard: no import statement in the port (or chip_smoke.py) names
    JAX, the JAX package, or a package the GPU machine lacks."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_port_imports_with_jax_blocked():
    """Subprocess guard: every port module and chip_smoke.py import with
    the forbidden packages made unimportable."""
    mods = sorted(
        ".".join(part for part in p.relative_to(ROOT).with_suffix("").parts
                 if part != "__init__")
        for p in _port_files()
    )
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "assert not any(sys.modules.get(m) for m in "
        f"{FORBIDDEN!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sampling_greedy_seeded_and_masks():
    """Greedy is exactly argmax (first maximum); seeded draws repeat per
    (seed, step) and move with the step; top-k=1 and a tiny top-p reduce
    a sampled row to the argmax, as in the JAX sampler."""
    from dynamo_tpu.engine.sampling import sample_tokens as jax_sample
    from dynamo_tpu_torch.engine.sampling import sample_tokens

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 50)).astype(np.float32)
    logits[4, [7, 9]] = 10.0  # a tie: the first index wins
    t = torch.from_numpy(logits)
    B = 5
    greedy = sample_tokens(t, torch.zeros(B), torch.zeros(B, dtype=torch.int32),
                           torch.ones(B), torch.zeros(B, dtype=torch.int64),
                           torch.zeros(B, dtype=torch.int64))
    assert greedy.tolist() == np.argmax(logits, axis=-1).tolist()
    assert greedy[4] == 7

    temps = torch.full((B,), 1.0)
    seeds = torch.arange(B, dtype=torch.int64)
    steps = torch.zeros(B, dtype=torch.int64)
    free = dict(top_k=torch.zeros(B, dtype=torch.int32), top_p=torch.ones(B))
    a = sample_tokens(t, temps, free["top_k"], free["top_p"], seeds, steps)
    b = sample_tokens(t, temps, free["top_k"], free["top_p"], seeds, steps)
    assert torch.equal(a, b)
    draws = {tuple(sample_tokens(t, temps, free["top_k"], free["top_p"], seeds,
                                 steps + s).tolist()) for s in range(8)}
    assert len(draws) > 1

    top_k = torch.tensor([1, 1, 0, 0, 1], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1e-6, 1e-6, 1.0])
    got = sample_tokens(t, temps, top_k, top_p, seeds, steps)
    want = jax_sample(logits, np.ones(B, np.float32), top_k.numpy(),
                      top_p.numpy(), np.arange(B, dtype=np.uint32),
                      np.zeros(B, np.int32))
    # row 4's tie survives top-k=1, and both samplers break it with the
    # same draw (one threefry stream)
    assert got.tolist()[:4] == np.asarray(want).tolist()[:4] == greedy.tolist()[:4]
    assert got[4] in (7, 9) and got[4] == int(np.asarray(want)[4])


async def test_page_backpressure_and_deadline():
    """A prompt that cannot get pages waits at the queue head until a
    neighbour frees them (never errors while the pool could fit it); an
    expired deadline is refused before admission."""
    from dynamo_tpu_torch.runtime.context import DeadlineExceeded

    eng = _engine(num_pages=9)  # 8 usable pages of 4 tokens
    a, b = list(range(20, 40)), list(range(60, 80))  # 5 pages each
    ref = _engine()
    alone = _tokens(await _collect(ref, _req(b, 8), Context()))
    await ref.close()
    outs = await asyncio.gather(_collect(eng, _req(a, 8), Context()),
                                _collect(eng, _req(b, 8), Context()))
    assert [o[-1]["finish_reason"] for o in outs] == ["length", "length"]
    assert _tokens(outs[1]) == alone
    assert eng.allocator.active_pages == 0
    with pytest.raises(DeadlineExceeded):
        await _collect(eng, _req(a, 4), Context(deadline=0.0))
    await eng.close()
