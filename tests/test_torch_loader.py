"""Checkpoint loading in the port (dynamo_tpu_torch/models/loader.py)
against the ``safetensors`` library, the JAX package's loader and HF
``transformers``.

- The port's stdlib + numpy safetensors reader reads files the library
  writes bit for bit (bf16, f16, f32, i64, several shards, metadata), and
  the library reads the port writer's files bit for bit.
- ``spec_from_hf_config`` / ``hf_config_from_spec`` equal the reference's
  on every preset.
- One checkpoint loads in both packages (dense llama, mixtral's and qwen's
  per-expert names, gpt-oss's fused experts), written by either package:
  ``reference_forward`` logits within 1e-4.
- A tiny ``GptOssForCausalLM`` that ``transformers`` writes loads to
  logits within the reference test's ``atol=3e-4, rtol=2e-4`` of HF's,
  and paged greedy decode equals HF's greedy tokens.
- DeepSeek (MLA) checkpoints: tiny ``DeepseekV3ForCausalLM`` models that
  ``transformers`` writes (dense and with live experts) load to logits
  within the reference tests' tolerances of HF's; a checkpoint written by
  either package loads in both, with and without ``rope_interleave``; a
  bf16 save -> load round trip is bitwise.
- Refusals: a missing tensor, ``mesh=`` (item 11), tokenizer files beside
  the weights; and the loader never needs ``safetensors``.
"""

import asyncio
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as st_save_file

from dynamo_tpu.engine.config import ModelSpec as JaxSpec
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models import mla as jmla
from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.models import llama, loader, mla
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.family import MlaFamily, get_family
from dynamo_tpu_torch.runtime.context import Context

pytestmark = pytest.mark.unit

LOGIT_TOL = 1e-4
PRESETS = ("tiny-test", "tiny-moe", "tiny-deepseek", "tiny-gpt-oss", "llama-3-8b",
           "llama-3-70b", "mixtral-8x7b", "gpt-oss-120b", "deepseek-r1")
DENSE_KW = dict(name="tiny-dense", vocab_size=96, hidden_size=32,
                intermediate_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=8, dtype="float32", tie_embeddings=False)
MOE_KW = dict(DENSE_KW, name="tiny-experts", num_experts=4, num_experts_per_token=2,
              moe_intermediate_size=48)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a.bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "b.f16": rng.standard_normal((7,)).astype(np.float16),
        "c.f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "d.i64": rng.integers(-2**40, 2**40, (6,), dtype=np.int64),
        "e.scalar": np.asarray(1.5, np.float32),
    }


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_reads_library_files_bit_equal(tmp_path):
    """Two shards written by safetensors.numpy.save_file, one with
    __metadata__: every tensor's bytes, dtype code and shape."""
    arrs = _arrays()
    names = sorted(arrs)
    st_save_file({k: arrs[k] for k in names[:3]}, str(tmp_path / "s1.safetensors"),
                 metadata={"format": "pt", "note": "x"})
    st_save_file({k: arrs[k] for k in names[3:]}, str(tmp_path / "s2.safetensors"))
    seen = {}
    for f in ("s1", "s2"):
        with loader.SafetensorsFile(str(tmp_path / f"{f}.safetensors")) as r:
            if f == "s1":
                assert r.metadata == {"format": "pt", "note": "x"}
            for name in r.keys():
                seen[name] = r.get_numpy(name).copy()
                assert r.get_tensor(name).shape == arrs[name].shape
    assert sorted(seen) == names
    for name, a in arrs.items():
        assert seen[name].shape == a.shape
        np.testing.assert_array_equal(_bits(seen[name]), _bits(a))
    with loader.SafetensorsFile(str(tmp_path / "s1.safetensors")) as r:
        t = r.get_tensor("a.bf16")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                      arrs["a.bf16"].view(np.uint16))


def test_library_reads_port_files_bit_equal(tmp_path):
    """The port's writer (numpy arrays and torch tensors, e4m3 included):
    safe_open reads every tensor back bit for bit; the header is padded
    with spaces to 8 bytes."""
    arrs = _arrays(1)
    tensors = dict(arrs)
    tensors["f.torch_bf16"] = torch.randn(4, 3).to(torch.bfloat16)
    tensors["g.e4m3"] = torch.randn(8).to(torch.float8_e4m3fn)
    tensors["h.bool"] = torch.tensor([True, False, True])
    path = str(tmp_path / "port.safetensors")
    loader.save_file(tensors, path, metadata={"format": "pt"})
    raw = open(path, "rb").read()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0 and raw[8:8 + n].decode().endswith((" ", "}"))
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for name, want in tensors.items():
            got = f.get_tensor(name)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(_bits(got.view(torch.uint8).numpy()
                                                    if got.dtype == torch.bfloat16
                                                    else got.numpy()), _bits(want))
            else:
                assert got.dtype == want.dtype
                assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("name", PRESETS)
def test_config_maps_equal_reference(name):
    jspec, tspec = JaxSpec.preset(name), ModelSpec.preset(name)
    cfg = jloader.hf_config_from_spec(jspec)
    assert loader.hf_config_from_spec(tspec) == cfg
    assert (dataclasses.asdict(loader.spec_from_hf_config(cfg, name=name))
            == dataclasses.asdict(jloader.spec_from_hf_config(cfg, name=name)))
    # a config without layer_types / with the pre-4.56 dtype key
    cfg2 = {k: v for k, v in cfg.items() if k not in ("layer_types", "dtype")}
    assert (dataclasses.asdict(loader.spec_from_hf_config(cfg2))
            == dataclasses.asdict(jloader.spec_from_hf_config(cfg2)))


def _jax_params(jspec, seed):
    """The reference's init with every bias and sink drawn non-zero."""
    jp = jax.tree.map(np.asarray, jllama.init_params(jspec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for lp in jp["layers"]:
        for d in (lp, lp.get("moe", {})):
            for k in ("bq", "bk", "bv", "bo", "sinks", "router_bias", "b_gate",
                      "b_up", "b_down"):
                if k in d:
                    d[k] = (rng.standard_normal(d[k].shape) * 0.2).astype(np.float32)
    return jp


def _qwen_checkpoint(spec, jp, path):
    """qwen's per-expert names (``mlp.gate`` + ``mlp.experts.E.*_proj``),
    written with the port's writer."""
    t = {"model.embed_tokens.weight": jp["embed"], "model.norm.weight": jp["final_norm"],
         "lm_head.weight": jp["lm_head"].T}
    for i, lp in enumerate(jp["layers"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = lp["attn_norm"]
        t[p + "post_attention_layernorm.weight"] = lp["mlp_norm"]
        for hf, ours in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                         ("o_proj", "wo")):
            t[p + f"self_attn.{hf}.weight"] = lp[ours].T
        t[p + "mlp.gate.weight"] = lp["moe"]["router"].T
        for e in range(spec.num_experts):
            for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                             ("down_proj", "w_down")):
                t[p + f"mlp.experts.{e}.{hf}.weight"] = lp["moe"][ours][e].T
    os.makedirs(path, exist_ok=True)
    loader.save_file(t, os.path.join(path, "model.safetensors"))
    cfg = jloader.hf_config_from_spec(spec)
    cfg["model_type"] = "qwen3_moe"
    cfg["num_experts"] = cfg.pop("num_local_experts")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("scheme", ["dense", "mixtral", "qwen_moe", "gpt_oss"])
def test_checkpoint_loads_in_both_packages(tmp_path, scheme, writer):
    """One checkpoint (written by either package; qwen's names by hand)
    loads in both: the same names resolved, reference_forward logits within
    1e-4. Small shards force several files."""
    kw = {"dense": DENSE_KW, "mixtral": MOE_KW, "qwen_moe": MOE_KW}.get(scheme)
    jspec = JaxSpec(**kw) if kw else JaxSpec.tiny_gpt_oss()
    tspec = ModelSpec(**kw) if kw else ModelSpec.tiny_gpt_oss()
    jp = _jax_params(jspec, seed=len(scheme))
    path = str(tmp_path / "ckpt")
    if scheme == "qwen_moe":
        _qwen_checkpoint(jspec, jp, path)
    elif writer == "jax":
        jloader.save_params(jspec, jax.tree.map(jnp.asarray, jp), path, shard_bytes=40_000)
    else:
        loader.save_params(tspec, params_from_numpy(tspec, jp, device="cpu"), path,
                           shard_bytes=40_000)
    if scheme != "qwen_moe":
        assert len([f for f in os.listdir(path) if f.endswith(".safetensors")]) > 1
    js, jparams = jloader.load_model_dir(path, dtype="float32")
    ts, tparams = loader.load_model_dir(path, dtype="float32", device="cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    if tspec.num_experts:
        assert tparams.layers[0].moe.router.dtype == torch.float32
    tokens = np.random.default_rng(0).integers(0, ts.vocab_size, 17).astype(np.int32)
    want = np.asarray(jllama.reference_forward(js, jparams, jnp.asarray(tokens)))
    got = llama.reference_forward(ts, tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the saved weights themselves come back
    np.testing.assert_array_equal(tparams.embed.numpy(), jp["embed"])


def test_bf16_round_trip_is_bitwise(tmp_path):
    """A bf16 model written by the port and read back: every weight's bits,
    the router f32."""
    spec = dataclasses.replace(ModelSpec.tiny_gpt_oss(), dtype="bfloat16")
    p = llama.init_params(spec, 5, device="cpu")
    loader.save_params(spec, p, str(tmp_path))
    spec2, p2 = loader.load_model_dir(str(tmp_path), device="cpu")
    assert spec2.dtype == "bfloat16"
    a, b = dict(p.named_parameters()), dict(p2.named_parameters())
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert b["layers.0.moe.router"].dtype == torch.float32


def _tiny_hf_gpt_oss(tmpdir: str):
    """A real HF GptOssForCausalLM (sinks, alternating sliding windows,
    projection and expert biases, clamped swiglu, YaRN) saved as
    safetensors, as tests/test_gpt_oss.py builds it."""
    tfm = pytest.importorskip("transformers")
    if not hasattr(tfm, "GptOssForCausalLM"):
        pytest.skip("transformers too old for GptOss")
    from transformers import GptOssConfig, GptOssForCausalLM

    cfg = GptOssConfig(
        vocab_size=96, hidden_size=32, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, layer_types=["sliding_attention", "full_attention"],
        rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "original_max_position_embeddings": 4096,
                      "truncate": False},
        max_position_embeddings=4096, tie_word_embeddings=False,
        swiglu_limit=7.0, attention_bias=True, rms_norm_eps=1e-5,
    )
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = GptOssForCausalLM(cfg).to(torch.float32).eval()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".sinks") or "bias" in n:
                p.copy_(torch.randn_like(p) * 0.5)
    model.save_pretrained(tmpdir)
    return model


def test_hf_gpt_oss_checkpoint_matches_transformers(tmp_path):
    """The HF checkpoint through the port's loader: reference_forward
    within the reference test's tolerance of HF's logits, and paged
    prefill + decode greedy-decode HF's tokens."""
    model = _tiny_hf_gpt_oss(str(tmp_path))
    spec, params = loader.load_model_dir(str(tmp_path), dtype="float32", device="cpu")
    assert spec.attn_sinks and spec.attn_bias and spec.moe_bias
    assert spec.layer_types == ("sliding_attention", "full_attention")
    assert spec.swiglu_limit == 7.0 and spec.rope_scaling_factor == 32.0
    tokens = np.arange(13) % 96
    with torch.no_grad():
        want = model(torch.tensor(tokens)[None]).logits[0].float().numpy()
        got = llama.reference_forward(spec, params, torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=2e-4)

    T, N = 11, 5
    prompt = list(np.arange(5, 5 + T) % 96)
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(N):
            seq.append(int(torch.argmax(model(torch.tensor(seq)[None]).logits[0, -1])))
    k, v = llama.init_cache(spec, 16, 4, device="cpu", dtype=torch.float32)
    padded = torch.zeros(16, dtype=torch.int32)
    padded[:T] = torch.tensor(prompt)
    bt = torch.zeros(8, dtype=torch.int32)
    bt[:4] = torch.tensor([1, 2, 3, 4])
    logits, dropped = llama.prefill_forward(spec, params, padded, bt, 0, k, v, T)
    got = [int(torch.argmax(logits))]
    for i in range(N - 1):
        lg = llama.decode_forward(spec, params, torch.tensor([got[-1]]), bt[None],
                                  torch.tensor([T + 1 + i], dtype=torch.int32), k, v,
                                  torch.ones(1, dtype=torch.bool))
        got.append(int(torch.argmax(lg[0])))
    assert got == seq[T:]


def test_refusals(tmp_path, caplog):
    spec = ModelSpec(**MOE_KW)
    p = llama.init_params(spec, 0, device="cpu")
    loader.save_params(spec, p, str(tmp_path))
    # MoE checkpoints shard under a mesh since item 11b: one whose 4 experts
    # do not divide over ep=3 is refused naming the axis
    from dynamo_tpu_torch.parallel.mesh import AXES, Mesh

    ep3 = Mesh(dict.fromkeys(AXES, 1) | {"ep": 3}, dict.fromkeys(AXES, 0),
               torch.device("cpu"))
    with pytest.raises(ValueError, match="ep=3"):
        loader.load_model_dir(str(tmp_path), mesh=ep3, device="cpu")
    # MLA is no longer refused: the family and the name map exist, and a
    # DeepSeek directory without its tensors fails as any checkpoint does
    assert isinstance(get_family(ModelSpec.tiny_deepseek()), MlaFamily)
    ds_spec = ModelSpec.tiny_deepseek()
    assert set(loader._dest_map_mla(ds_spec)) == set(
        jloader._dest_map_mla(JaxSpec.tiny_deepseek()))
    cfg = jloader.hf_config_from_spec(JaxSpec.tiny_deepseek())
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "config.json").write_text(json.dumps(cfg))
    loader.save_file({"x": np.zeros(1, np.float32)}, str(ds / "model.safetensors"))
    with pytest.raises(ValueError, match="kv_b_proj|missing"):
        loader.load_model_dir(str(ds), device="cpu")
    # a missing tensor raises as the reference does; an extra bias logs
    r = loader.SafetensorsFile(str(tmp_path / "model.safetensors"))
    t = {n: r.get_tensor(n) for n in r.keys()
         if n != "model.layers.1.block_sparse_moe.experts.3.w2.weight"}
    r.close()
    t["model.layers.0.mlp.extra.bias"] = torch.zeros(2)
    broken = tmp_path / "broken"
    broken.mkdir()
    loader.save_file(t, str(broken / "model.safetensors"))
    (broken / "config.json").write_text((tmp_path / "config.json").read_text())
    with pytest.raises(ValueError, match="missing 1 tensors"):
        loader.load_model_dir(str(broken), device="cpu")
    assert "skipped 1 tensors" in caplog.text
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        loader.load_params(spec, str(empty), device="cpu")


def test_loader_needs_no_safetensors_package(tmp_path, monkeypatch):
    spec = ModelSpec(**MOE_KW)
    p = llama.init_params(spec, 1, device="cpu")
    loader.save_params(spec, p, str(tmp_path))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    _spec, p2 = loader.load_model_dir(str(tmp_path), device="cpu")
    assert torch.equal(p2.layers[1].moe.w_down, p.layers[1].moe.w_down)


async def test_worker_serves_model_path(tmp_path):
    """launch_engine_worker(model_path=...) serves the checkpoint: the spec
    from its config, the streams of an engine on the same loaded weights;
    spec= beside model_path= raises; tokenizer files beside the weights are
    served (the card names the directory), and an unreadable one raises."""
    from dynamo_tpu_torch.engine.worker import launch_engine_worker
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub import InMemoryHub

    spec = dataclasses.replace(ModelSpec.tiny_moe(), name="ckpt-moe")
    loader.save_params(spec, llama.init_params(spec, 2, device="cpu"), str(tmp_path))
    cfg = EngineConfig(page_size=4, num_pages=64, max_pages_per_seq=16,
                       max_decode_slots=2, prefill_buckets=(8, 16, 32))
    drt = DistributedRuntime(InMemoryHub())
    with pytest.raises(ValueError, match="not both"):
        await launch_engine_worker(drt, model_path=str(tmp_path), spec=spec,
                                   engine_config=cfg, device="cpu")
    engine, _served = await launch_engine_worker(
        drt, model_path=str(tmp_path), engine_config=cfg, device="cpu",
        router_mode="round_robin")
    req = {"token_ids": [5, 6, 7, 8, 9], "stop_conditions": {"max_tokens": 5,
                                                              "ignore_eos": True}}
    got = [t for x in [x async for x in engine.generate(dict(req), Context())]
           for t in x["token_ids"]]
    assert engine.spec.name == os.path.basename(str(tmp_path))
    assert engine.spec.num_experts == 4
    await engine.close()
    await drt.close()
    s2, p2 = loader.load_model_dir(str(tmp_path), device="cpu")
    ref = InferenceEngine(s2, cfg, params=p2, device="cpu")
    want = [t for x in [x async for x in ref.generate(dict(req), Context())]
            for t in x["token_ids"]]
    await ref.close()
    assert got == want and len(got) == 5

    from test_torch_tokenizer import build_tokenizer_dir

    from dynamo_tpu_torch.frontend.model_card import ModelDeploymentCard

    build_tokenizer_dir("llama3", tmp_path)
    drt = DistributedRuntime(InMemoryHub())
    engine, _served = await launch_engine_worker(
        drt, model_path=str(tmp_path), engine_config=cfg, device="cpu",
        router_mode="round_robin")
    cards = [ModelDeploymentCard.from_dict(v) for _k, v in
             (await drt.hub.get_prefix("v1/mdc/")).items()]
    assert [c.tokenizer for c in cards] == [str(tmp_path)]
    await engine.close()
    await drt.close()
    (tmp_path / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "Unigram", "vocab": [["a", 0.0]], "unk_id": 0}}))
    drt = DistributedRuntime(InMemoryHub())
    with pytest.raises(NotImplementedError, match="Unigram"):
        await launch_engine_worker(drt, model_path=str(tmp_path), engine_config=cfg,
                                   device="cpu")
    await drt.close()


def test_worker_flag_model_path_is_accepted():
    """The worker's --model-path is no longer refused at flag parsing."""
    from dynamo_tpu_torch.engine import worker

    args = worker.parse_args(["--model-path", "/nonexistent", "--device", "cpu"])
    assert worker._engine_config(args).page_size == 16


# ------------------------------------------------------------ DeepSeek (MLA)


def _tiny_hf_deepseek(tmpdir: str, moe: bool):
    """A real HF DeepseekV3ForCausalLM saved as safetensors, as
    tests/test_mla.py builds it: all layers dense with YaRN and the
    mscale^2 softmax scale (attention golden), or with live experts
    (sigmoid routing, a non-zero correction bias, group-limited top-k,
    routed scaling, a shared expert)."""
    tfm = pytest.importorskip("transformers")
    if not hasattr(tfm, "DeepseekV3ForCausalLM"):
        pytest.skip("transformers too old for DeepseekV3")
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    common = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                  moe_intermediate_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
                  kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, rope_theta=10000.0,
                  max_position_embeddings=4096, tie_word_embeddings=False,
                  attention_bias=False)
    if moe:
        cfg = DeepseekV3Config(**common, n_routed_experts=8, num_experts_per_tok=3,
                               n_group=2, topk_group=1, routed_scaling_factor=2.5,
                               norm_topk_prob=True, first_k_dense_replace=1)
    else:
        cfg = DeepseekV3Config(
            **common, n_routed_experts=4, num_experts_per_tok=2, first_k_dense_replace=2,
            rope_scaling={"rope_type": "yarn", "factor": 40.0, "beta_fast": 32.0,
                          "beta_slow": 1.0, "original_max_position_embeddings": 4096,
                          "mscale": 1.0, "mscale_all_dim": 1.0})
    cfg._attn_implementation = "eager"
    torch.manual_seed(3 if moe else 2)
    model = DeepseekV3ForCausalLM(cfg).to(torch.float32).eval()
    if moe:
        with torch.no_grad():
            for n, b in model.named_buffers():
                if "e_score_correction_bias" in n:
                    b.copy_(torch.randn_like(b) * 0.2)
    model.save_pretrained(tmpdir)
    return model


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_mla_golden_logits_vs_hf(tmp_path, moe):
    """The HF DeepSeek checkpoint through the port's loader (interleaved
    rope columns, the kv_b_proj split, the shared expert, the correction
    bias): mla.reference_forward within the reference tests' tolerances
    of HF's logits (atol 3e-4 / rtol 2e-4 dense, 5e-4 / 3e-4 with
    experts), the paged prefill within 1e-4 of the reference forward."""
    model = _tiny_hf_deepseek(str(tmp_path), moe)
    tokens = np.arange(11) % 96
    with torch.no_grad():
        want = model(torch.tensor(tokens)[None]).logits[0].float().numpy()
    spec, params = loader.load_model_dir(str(tmp_path), dtype="float32", device="cpu")
    assert spec.is_mla and spec.rope_interleave and isinstance(params, mla.MlaParams)
    if moe:
        assert spec.moe_scoring == "sigmoid" and spec.n_group == 2
        assert spec.routed_scaling_factor == 2.5
    else:
        assert spec.rope_scaling_factor == 40.0 and spec.rope_mscale_all_dim == 1.0
    got = mla.reference_forward(spec, params, torch.tensor(tokens)).numpy()
    atol, rtol = (5e-4, 3e-4) if moe else (3e-4, 2e-4)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    cache = mla.init_cache(spec, 8, 4, device="cpu")
    padded = torch.zeros(12, dtype=torch.int32)
    padded[:11] = torch.tensor(tokens)
    bt = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    last, _ = mla.prefill_forward(spec, params, padded, bt, 0, cache, 11)
    np.testing.assert_allclose(last.numpy(), got[-1], atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mla_checkpoint_loads_in_both_packages(tmp_path, writer, interleave):
    """A tiny_deepseek checkpoint written by either package (the port's
    with its rope columns interleaved when the spec says so; small shards
    force several files) loads in both: the same spec, reference_forward
    logits within 1e-4, the saved weights back."""
    jspec = dataclasses.replace(JaxSpec.tiny_deepseek(), rope_interleave=interleave)
    tspec = dataclasses.replace(ModelSpec.tiny_deepseek(), rope_interleave=interleave)
    jp = jax.tree.map(np.asarray, jmla.init_params(jspec, jax.random.PRNGKey(4)))
    for lp in jp["layers"]:
        if "moe" in lp:
            lp["moe"]["score_bias"] = np.linspace(-0.3, 0.3, 4).astype(np.float32)
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jloader.save_params(jspec, jax.tree.map(jnp.asarray, jp), path, shard_bytes=20_000)
    else:
        loader.save_params(tspec, params_from_numpy(tspec, jp, device="cpu"), path,
                           shard_bytes=20_000)
    assert len([f for f in os.listdir(path) if f.endswith(".safetensors")]) > 1
    js, jparams = jloader.load_model_dir(path, dtype="float32")
    ts, tparams = loader.load_model_dir(path, dtype="float32", device="cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.rope_interleave == (interleave and writer == "port")
    assert tparams.layers[1].moe.router.dtype == torch.float32
    tokens = np.random.default_rng(0).integers(0, ts.vocab_size, 17).astype(np.int32)
    want = np.asarray(jmla.reference_forward(js, jparams, jnp.asarray(tokens)))
    got = mla.reference_forward(ts, tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(tparams.layers[0].w_uk.numpy(), jp["layers"][0]["w_uk"])
    np.testing.assert_array_equal(tparams.layers[1].shared.w_down.numpy(),
                                  jp["layers"][1]["shared"]["w_down"])
    np.testing.assert_array_equal(tparams.layers[1].moe.score_bias.numpy(),
                                  jp["layers"][1]["moe"]["score_bias"])


def test_mla_bf16_round_trip_is_bitwise(tmp_path):
    """deepseek's layout (interleaved rope, fused kv_b_proj, shared and
    routed experts) in bf16, written by the port and read back: the same
    spec and every weight's bits, the router f32."""
    spec = dataclasses.replace(ModelSpec.tiny_deepseek(), dtype="bfloat16",
                               rope_interleave=True)
    p = mla.init_params(spec, 5, device="cpu")
    loader.save_params(spec, p, str(tmp_path))
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["model_type"] == "deepseek_v3" and cfg["rope_interleave"] is True
    spec2, p2 = loader.load_model_dir(str(tmp_path), device="cpu")
    assert dataclasses.replace(spec2, name=spec.name) == spec
    a, b = dict(p.named_parameters()), dict(p2.named_parameters())
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert b["layers.1.moe.router"].dtype == torch.float32
