"""Checkpoint loading: HF-format safetensors -> the port's ``LlamaParams``
(counterpart of dynamo_tpu/models/loader.py).

A model directory holds ``config.json`` and ``*.safetensors``:
``load_model_dir`` derives the ``ModelSpec`` from the config and streams
every tensor to the device one at a time (memory-mapped read, one host
copy of that tensor, then cast and transpose on the device), so host RAM
never holds a second full copy of the checkpoint. ``save_params`` writes
params back out in the same format (test round trips, re-export).

The safetensors format is read and written here with the standard
library and numpy, without the ``safetensors`` package: an 8-byte
little-endian header length, a JSON header (``{name: {"dtype", "shape",
"data_offsets": [begin, end]}}``, offsets from the first byte after the
header, plus an optional ``"__metadata__"`` of strings), then the tensor
bytes. bf16 passes through its ``uint16`` bits; e4m3 reads as ``uint8``.

Weight names (HF LlamaForCausalLM / MixtralForCausalLM / Qwen-MoE /
GptOssForCausalLM) map onto the port's tree as the reference's loader maps
them (``_dest_map``); HF stores linear weights ``[out, in]`` and the
forward is ``x @ W``, so every projection transposes on load. MoE experts
come in three schemes (``_moe_scheme``): mixtral's ``block_sparse_moe``,
qwen's ``mlp.experts.E``, each expert copied into its row of the stacked
``[E, d, f]`` device tensor, and gpt-oss's fused ``gate_up_proj`` /
``down_proj`` with their biases, gate and up interleaved on the last axis.
The router and its biases stay f32.

DeepSeek (MLA) checkpoints map through ``_dest_map_mla`` onto the port's
``MlaParams`` (models/mla.py): the fused per-head ``kv_b_proj [H * (dn +
dv), dc]`` splits into ``w_uk [H, dc, dn]`` and ``w_uv [H, dc, dv]``, the
shared experts land in ``shared``, the router's correction bias in
``moe.score_bias``, and a ``rope_interleave`` checkpoint's pair-interleaved
rope columns of the query and latent projections are permuted to the
half-split order the forward rotates (exact: both sides of every rope dot
product get the same permutation). ``save_params`` re-fuses ``kv_b_proj``
and, for a ``rope_interleave`` spec, re-interleaves those columns.

Not ported: loading onto a mesh (ROADMAP Queue A item 11) raises.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Callable

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models.llama import LlamaParams, resolve_device, torch_dtype

__all__ = [
    "spec_from_hf_config",
    "hf_config_from_spec",
    "load_params",
    "save_params",
    "load_model_dir",
    "SafetensorsFile",
    "save_file",
]

log = logging.getLogger("dynamo_tpu_torch.loader")

# ------------------------------------------------------------- safetensors

# safetensors dtype code -> (numpy dtype of the stored bits, torch dtype)
_ST_DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F16": (np.dtype(np.float16), torch.float16),
    "F32": (np.dtype(np.float32), torch.float32),
    "F64": (np.dtype(np.float64), torch.float64),
    "I8": (np.dtype(np.int8), torch.int8),
    "I16": (np.dtype(np.int16), torch.int16),
    "I32": (np.dtype(np.int32), torch.int32),
    "I64": (np.dtype(np.int64), torch.int64),
    "U8": (np.dtype(np.uint8), torch.uint8),
    "BOOL": (np.dtype(np.bool_), torch.bool),
    "F8_E4M3": (np.dtype(np.uint8), torch.float8_e4m3fn),
}
_TORCH_CODES = {tdt: code for code, (_n, tdt) in _ST_DTYPES.items()}
_NUMPY_CODES = {np.dtype(np.float16): "F16", np.dtype(np.float32): "F32",
                np.dtype(np.float64): "F64", np.dtype(np.int8): "I8",
                np.dtype(np.int16): "I16", np.dtype(np.int32): "I32",
                np.dtype(np.int64): "I64", np.dtype(np.uint8): "U8",
                np.dtype(np.bool_): "BOOL"}


class SafetensorsFile:
    """One ``.safetensors`` file, its tensors read through a read-only
    ``numpy.memmap`` one at a time."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self.entries: dict[str, dict] = header
        size = os.path.getsize(path) - 8 - n
        end = max((e["data_offsets"][1] for e in header.values()), default=0)
        if end > size:
            raise ValueError(f"{path}: header covers {end} bytes, file holds {size}")
        self._data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n,
                                shape=(size,))
                      if size else np.zeros(0, np.uint8))

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._data = None

    def keys(self) -> list[str]:
        return list(self.entries)

    def get_numpy(self, name: str) -> np.ndarray:
        """A read-only view of the stored bits: bf16 as uint16, e4m3 as
        uint8, the other dtypes as themselves."""
        e = self.entries[name]
        begin, end = e["data_offsets"]
        np_dt = _ST_DTYPES[e["dtype"]][0]
        return self._data[begin:end].view(np_dt).reshape(e["shape"])

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        """The tensor in its stored dtype on ``device`` (default the CPU),
        through one host copy of it (the memmap is read-only)."""
        host = torch.from_numpy(np.array(self.get_numpy(name)))
        t = host.view(_ST_DTYPES[self.entries[name]["dtype"]][1])
        return t if device is None else t.to(device)


def _code(x) -> str:
    """The dtype code of a torch tensor or a numpy array (a bf16 numpy
    array passes by its dtype name)."""
    if isinstance(x, torch.Tensor):
        return _TORCH_CODES[x.dtype]
    return "BF16" if x.dtype.name == "bfloat16" else _NUMPY_CODES[np.dtype(x.dtype)]


def _tensor_bytes(x) -> tuple[str, list[int], np.ndarray]:
    """(dtype code, shape, the bytes as a flat uint8 array) of a torch
    tensor (copied to the host) or a numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        return _code(t), list(t.shape), t.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x, order="C")  # (ascontiguousarray makes a 0-d array 1-d)
    return _code(a), list(a.shape), a.reshape(-1).view(np.uint8)


def _header_entry(code: str, shape: list[int]) -> int:
    itemsize = _ST_DTYPES[code][0].itemsize
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def _write_file(path: str, specs: list[tuple[str, str, list[int], Callable]],
                metadata: dict[str, str] | None) -> None:
    """Write one file from ``(name, dtype code, shape, produce)`` entries:
    the header first (offsets from the declared shapes), then each
    tensor's bytes from ``produce()``, one tensor at a time."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, code, shape, _p in specs:
        n = _header_entry(code, shape)
        header[name] = {"dtype": code, "shape": shape, "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # pad to 8-byte alignment with spaces
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, code, shape, produce in specs:
            got_code, got_shape, data = _tensor_bytes(produce())
            if (got_code, got_shape) != (code, shape):
                raise ValueError(f"{name}: declared {code}{shape}, got {got_code}{got_shape}")
            f.write(memoryview(data))


def save_file(tensors: dict[str, Any], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``{name: torch tensor or numpy array}`` as one safetensors file
    (names sorted, as ``safetensors.numpy.save_file`` lays them out)."""
    specs = [(name, _code(x), list(x.shape), lambda x=x: x)
             for name, x in sorted(tensors.items())]
    _write_file(path, specs, metadata)


# ------------------------------------------------------------- spec <-> config


def spec_from_hf_config(cfg: dict, name: str | None = None) -> ModelSpec:
    """Map an HF ``config.json`` dict to a ModelSpec (llama/mixtral/qwen-moe/
    gpt-oss/deepseek)."""
    model_type = cfg.get("model_type", "llama")
    heads = int(cfg["num_attention_heads"])
    hidden = int(cfg["hidden_size"])
    moe = {}
    n_experts = int(
        cfg.get("num_local_experts") or cfg.get("num_experts")
        or cfg.get("n_routed_experts") or 0
    )
    if model_type in ("mixtral", "qwen2_moe", "qwen3_moe", "gpt_oss") or n_experts:
        moe = dict(
            num_experts=n_experts,
            num_experts_per_token=int(
                cfg.get("num_experts_per_tok")
                or cfg.get("experts_per_token") or 2
            ),
            moe_intermediate_size=int(
                cfg.get("moe_intermediate_size") or cfg["intermediate_size"]
            ),
        )
    # gpt-oss attention extras: sinks + per-layer sliding windows +
    # projection/expert biases + clamped swiglu (HF GptOssConfig)
    extras: dict = {}
    if model_type == "gpt_oss":
        n_layers = int(cfg["num_hidden_layers"])
        extras = dict(
            sliding_window=int(cfg.get("sliding_window") or 0),
            # HF GptOssConfig alternates sliding/full when layer_types is
            # absent
            layer_types=tuple(
                cfg.get("layer_types")
                or ("sliding_attention" if i % 2 == 0 else "full_attention"
                    for i in range(n_layers))
            ),
            attn_sinks=True,
            attn_bias=bool(cfg.get("attention_bias", True)),
            moe_bias=True,
            swiglu_limit=float(cfg.get("swiglu_limit") or 7.0),
            swiglu_alpha=1.702,
        )
    if model_type in ("deepseek_v2", "deepseek_v3"):
        # DeepSeek MLA checkpoints store rope dims pair-interleaved
        extras["rope_interleave"] = bool(cfg.get("rope_interleave", True))
        if n_experts:
            # V3 noaux_tc routing; fallbacks are HF DeepseekV3Config's
            extras.update(
                moe_scoring=str(cfg.get("scoring_func") or "sigmoid"),
                n_group=int(cfg.get("n_group") or 8),
                topk_group=int(cfg.get("topk_group") or 4),
                routed_scaling_factor=float(
                    cfg.get("routed_scaling_factor") or 2.5
                ),
                norm_topk_prob=bool(cfg.get("norm_topk_prob", True)),
            )
    # YaRN rope scaling (gpt-oss, DeepSeek-R1)
    rs = cfg.get("rope_scaling") or {}
    if (rs.get("rope_type") or rs.get("type")) == "yarn":
        extras.update(
            rope_scaling_factor=float(rs["factor"]),
            rope_orig_max_pos=int(
                rs.get("original_max_position_embeddings")
                or cfg.get("max_position_embeddings") or 4096
            ),
            rope_beta_fast=float(rs.get("beta_fast") or 32),
            rope_beta_slow=float(rs.get("beta_slow") or 1),
            rope_mscale=float(rs.get("mscale") or 0),
            rope_mscale_all_dim=float(rs.get("mscale_all_dim") or 0),
            rope_truncate=bool(rs.get("truncate", True)),
        )
    return ModelSpec(
        name=name or cfg.get("_name_or_path") or model_type,
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(cfg["intermediate_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(cfg.get("num_key_value_heads", heads)),
        head_dim=int(cfg.get("head_dim") or hidden // heads),
        rope_theta=float(cfg.get("rope_theta", 500000.0)),
        rms_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        # transformers >= 4.56 writes "dtype"; older wrote "torch_dtype"
        dtype=(
            ckpt_dtype
            if (ckpt_dtype := cfg.get("dtype") or cfg.get("torch_dtype"))
            in ("bfloat16", "float32", "float16")
            else "bfloat16"
        ),
        n_shared_experts=int(cfg.get("n_shared_experts") or 0),
        first_k_dense=int(cfg.get("first_k_dense_replace") or 0),
        kv_lora_rank=int(cfg.get("kv_lora_rank") or 0),
        qk_nope_head_dim=int(cfg.get("qk_nope_head_dim") or 0),
        qk_rope_head_dim=int(cfg.get("qk_rope_head_dim") or 0),
        v_head_dim=int(cfg.get("v_head_dim") or 0),
        q_lora_rank=int(cfg.get("q_lora_rank") or 0),
        **moe,
        **extras,
    )


def hf_config_from_spec(spec: ModelSpec) -> dict:
    """Inverse of spec_from_hf_config: every architecture field the loader
    reads round-trips."""
    if spec.kv_lora_rank:
        model_type = "deepseek_v3"
    elif spec.attn_sinks:
        model_type = "gpt_oss"
    elif spec.num_experts:
        model_type = "mixtral"
    else:
        model_type = "llama"
    cfg = {
        "model_type": model_type,
        "vocab_size": spec.vocab_size,
        "hidden_size": spec.hidden_size,
        "intermediate_size": (
            spec.moe_intermediate_size
            if spec.num_experts and not spec.kv_lora_rank
            else spec.intermediate_size
        ),
        "num_hidden_layers": spec.num_layers,
        "num_attention_heads": spec.num_heads,
        "num_key_value_heads": spec.num_kv_heads,
        "head_dim": spec.head_dim,
        "rope_theta": spec.rope_theta,
        "rms_norm_eps": spec.rms_eps,
        "tie_word_embeddings": spec.tie_embeddings,
        "dtype": spec.dtype,  # transformers >= 4.56 key (the loader reads both)
        "torch_dtype": spec.dtype,
    }
    if spec.num_experts:
        cfg["num_local_experts"] = spec.num_experts
        cfg["num_experts_per_tok"] = spec.num_experts_per_token
        cfg["moe_intermediate_size"] = spec.moe_intermediate_size
    if model_type == "gpt_oss":
        cfg.update(
            sliding_window=spec.sliding_window,
            layer_types=list(spec.layer_types),
            attention_bias=spec.attn_bias,
            swiglu_limit=spec.swiglu_limit,
        )
    if spec.kv_lora_rank:
        cfg.update(
            n_routed_experts=spec.num_experts,
            n_shared_experts=spec.n_shared_experts,
            first_k_dense_replace=spec.first_k_dense,
            kv_lora_rank=spec.kv_lora_rank,
            q_lora_rank=spec.q_lora_rank or None,
            qk_nope_head_dim=spec.qk_nope_head_dim,
            qk_rope_head_dim=spec.qk_rope_head_dim,
            v_head_dim=spec.v_head_dim,
            scoring_func=spec.moe_scoring,
            n_group=spec.n_group,
            topk_group=spec.topk_group,
            routed_scaling_factor=spec.routed_scaling_factor,
            norm_topk_prob=spec.norm_topk_prob,
            # in-memory params are half-split: an export must say so
            rope_interleave=False,
        )
    if spec.rope_scaling_factor:
        cfg["rope_scaling"] = {
            "rope_type": "yarn",
            "factor": spec.rope_scaling_factor,
            "original_max_position_embeddings": spec.rope_orig_max_pos,
            "beta_fast": spec.rope_beta_fast,
            "beta_slow": spec.rope_beta_slow,
            "truncate": spec.rope_truncate,
            **(
                {"mscale": spec.rope_mscale,
                 "mscale_all_dim": spec.rope_mscale_all_dim}
                if spec.rope_mscale or spec.rope_mscale_all_dim
                else {}
            ),
        }
        # HF convention: the post-scaling context window
        cfg["max_position_embeddings"] = int(
            spec.rope_orig_max_pos * spec.rope_scaling_factor
        )
    return cfg


# ------------------------------------------------------------------- name map

# (tree path, transpose, dtype override)
Dest = tuple[tuple, bool, str | None]


def _moe_scheme(names: set[str] | None) -> str:
    """Which MoE tensor-naming convention a checkpoint uses.

    mixtral:  model.layers.N.block_sparse_moe.gate.weight + experts.E.w{1,2,3}
    qwen_moe: model.layers.N.mlp.gate.weight + experts.E.{gate,up,down}_proj
    gpt_oss:  model.layers.N.mlp.router.weight + FUSED 3D
              experts.gate_up_proj [E, d, 2f] (gate/up interleaved on the
              last axis) and experts.down_proj [E, f, d]
    """
    if not names:
        return "mixtral"
    for n in names:
        if ".block_sparse_moe." in n:
            return "mixtral"
        if ".mlp.experts.gate_up_proj" in n:
            return "gpt_oss"
        if ".mlp.experts.0." in n:
            return "qwen_moe"
    return "mixtral"


def _dest_map_mla(spec: ModelSpec) -> dict[str, Dest]:
    """DeepSeek-family (MLA) tensor names -> models/mla.py tree paths, as
    the reference's. ``kv_b_proj`` (the fused per-head w_uk / w_uv) splits
    in load_params."""
    m: dict[str, Dest] = {
        "model.embed_tokens.weight": (("embed",), False, None),
        "model.norm.weight": (("final_norm",), False, None),
    }
    if not spec.tie_embeddings:
        m["lm_head.weight"] = (("lm_head",), True, None)
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        li = ("layers", i)
        m[p + "input_layernorm.weight"] = (li + ("attn_norm",), False, None)
        m[p + "post_attention_layernorm.weight"] = (li + ("mlp_norm",), False, None)
        m[p + "self_attn.o_proj.weight"] = (li + ("wo",), True, None)
        m[p + "self_attn.kv_a_proj_with_mqa.weight"] = (li + ("w_kv_a",), True, None)
        m[p + "self_attn.kv_a_layernorm.weight"] = (li + ("kv_norm",), False, None)
        if spec.q_lora_rank:
            m[p + "self_attn.q_a_proj.weight"] = (li + ("wq_a",), True, None)
            m[p + "self_attn.q_a_layernorm.weight"] = (li + ("q_norm",), False, None)
            m[p + "self_attn.q_b_proj.weight"] = (li + ("wq_b",), True, None)
        else:
            m[p + "self_attn.q_proj.weight"] = (li + ("wq",), True, None)
        mlp = (("gate_proj", "w_gate"), ("up_proj", "w_up"), ("down_proj", "w_down"))
        if spec.num_experts and i >= spec.first_k_dense:
            mo = li + ("moe",)
            m[p + "mlp.gate.weight"] = (mo + ("router",), True, "float32")
            if spec.moe_scoring == "sigmoid":
                m[p + "mlp.gate.e_score_correction_bias"] = (
                    mo + ("score_bias",), False, "float32")
            for e in range(spec.num_experts):
                for hf, ours in mlp:
                    m[p + f"mlp.experts.{e}.{hf}.weight"] = (mo + (ours, e), True, None)
            if spec.n_shared_experts:
                for hf, ours in mlp:
                    m[p + f"mlp.shared_experts.{hf}.weight"] = (
                        li + ("shared", ours), True, None)
        else:
            for hf, ours in mlp:
                m[p + f"mlp.{hf}.weight"] = (li + (ours,), True, None)
    return m


def _rope_perm(spec: ModelSpec, inverse: bool = False) -> torch.Tensor:
    """Column order that takes pair-interleaved rope dims ([x0, y0, x1, y1,
    ...]) to half-split ([x0, x1, ..., y0, y1, ...]); ``inverse`` the way
    back."""
    dr = spec.qk_rope_head_dim
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])
    return torch.argsort(perm) if inverse else perm


# the projections whose output columns hold rope dims
_ROPE_Q = ("self_attn.q_b_proj.weight", "self_attn.q_proj.weight")
_ROPE_NAMES = _ROPE_Q + ("self_attn.kv_a_proj_with_mqa.weight",)


def _rope_cols(spec: ModelSpec, name: str, t: torch.Tensor,
               inverse: bool = False) -> torch.Tensor:
    """A ``rope_interleave`` checkpoint's query and latent projections
    ([in, out], as the forward holds them) with their rope columns
    de-interleaved (``inverse``: re-interleaved); other tensors as they
    are. The reference's ``_deinterleave_rope_cols``."""
    if name.endswith(_ROPE_Q):
        dn = spec.qk_nope_head_dim
        q = t.reshape(t.shape[0], spec.num_heads, -1)
        perm = _rope_perm(spec, inverse).to(t.device)
        return torch.cat([q[..., :dn], q[..., dn:][..., perm]], dim=-1).reshape(t.shape)
    if name.endswith("self_attn.kv_a_proj_with_mqa.weight"):
        dc = spec.kv_lora_rank
        perm = _rope_perm(spec, inverse).to(t.device)
        return torch.cat([t[:, :dc], t[:, dc:][:, perm]], dim=1)
    return t


def _dest_map(spec: ModelSpec, names: set[str] | None = None) -> dict[str, Dest]:
    """HF tensor name -> (tree path, transpose, dtype override). ``names``
    (the checkpoint's tensor set) selects the MoE naming scheme; gpt-oss's
    fused expert tensors split, which this map cannot express: load_params
    and save_params handle them."""
    m: dict[str, Dest] = {
        "model.embed_tokens.weight": (("embed",), False, None),
        "model.norm.weight": (("final_norm",), False, None),
    }
    if not spec.tie_embeddings:
        m["lm_head.weight"] = (("lm_head",), True, None)
    scheme = _moe_scheme(names) if spec.num_experts else None
    for i in range(spec.num_layers):
        p = f"model.layers.{i}."
        li = ("layers", i)
        m[p + "input_layernorm.weight"] = (li + ("attn_norm",), False, None)
        m[p + "post_attention_layernorm.weight"] = (li + ("mlp_norm",), False, None)
        for hf, ours in (("q_proj", "wq"), ("k_proj", "wk"),
                         ("v_proj", "wv"), ("o_proj", "wo")):
            m[p + f"self_attn.{hf}.weight"] = (li + (ours,), True, None)
        if spec.attn_bias:
            for hf, ours in (("q_proj", "bq"), ("k_proj", "bk"),
                             ("v_proj", "bv"), ("o_proj", "bo")):
                m[p + f"self_attn.{hf}.bias"] = (li + (ours,), False, None)
        if spec.attn_sinks:
            m[p + "self_attn.sinks"] = (li + ("sinks",), False, None)
        if not spec.num_experts:
            for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                             ("down_proj", "w_down")):
                m[p + f"mlp.{hf}.weight"] = (li + (ours,), True, None)
            continue
        mo = li + ("moe",)
        if scheme == "gpt_oss":  # the router here; fused experts apart
            m[p + "mlp.router.weight"] = (mo + ("router",), True, "float32")
            if spec.moe_bias:
                m[p + "mlp.router.bias"] = (mo + ("router_bias",), False, "float32")
            continue
        mp, names3 = ((p + "block_sparse_moe.", ("w1", "w3", "w2"))
                      if scheme == "mixtral" else
                      (p + "mlp.", ("gate_proj", "up_proj", "down_proj")))
        m[mp + "gate.weight"] = (mo + ("router",), True, "float32")
        for e in range(spec.num_experts):
            for hf, ours in zip(names3, ("w_gate", "w_up", "w_down")):
                m[mp + f"experts.{e}.{hf}.weight"] = (mo + (ours, e), True, None)
    return m


_FUSED_TAILS = ("gate_up_proj", "down_proj", "gate_up_proj_bias", "down_proj_bias")


def _tree_set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if key == "layers" else {})
    node[path[-1]] = value


def _params_get(params: LlamaParams, path: tuple) -> torch.Tensor:
    node = params
    for key in path:
        node = node[key] if isinstance(key, int) else getattr(node, key)
    return node


# ------------------------------------------------------------------ load/save


def load_params(
    spec: ModelSpec,
    model_dir: str,
    *,
    mesh=None,
    dtype: str | None = None,
    device: str | torch.device | None = None,
) -> LlamaParams:
    """Read ``*.safetensors`` under ``model_dir`` into the port's params on
    ``device`` (None = the GPU), in ``dtype`` (default the spec's; the
    router leaves f32). Each tensor streams on its own: memmap view, one
    host copy, to the device, cast, transpose there. Per-expert tensors land
    in their row of the stacked ``[E, ...]`` device tensor."""
    if mesh is not None:
        raise NotImplementedError(
            "load_params(mesh=...): meshes are not ported (ROADMAP Queue A item 11)")
    dev = resolve_device(device)
    dtype = dtype or spec.dtype
    files = sorted(os.path.join(model_dir, f) for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    readers = [SafetensorsFile(p) for p in files]
    all_names = {n for r in readers for n in r.keys()}
    mla = spec.is_mla
    dest = _dest_map_mla(spec) if mla else _dest_map(spec, all_names)
    fused = bool(not mla and spec.num_experts and _moe_scheme(all_names) == "gpt_oss")

    tree: dict[str, Any] = {}
    seen: set[str] = set()
    stacked: dict[tuple, torch.Tensor] = {}  # per-expert leaves, filled row by row
    skipped: list[str] = []

    def read(r: SafetensorsFile, name: str, dt: str) -> torch.Tensor:
        return r.get_tensor(name, dev).to(torch_dtype(dt))

    for r in readers:
        for name in r.keys():
            if name in dest:
                path, transpose, dt_override = dest[name]
                t = read(r, name, dt_override or dtype)
                if transpose:
                    t = t.T.contiguous()
                if mla and spec.rope_interleave:
                    t = _rope_cols(spec, name, t)
                seen.add(name)
                if isinstance(path[-1], int):
                    key, e = path[:-1], path[-1]
                    if key not in stacked:
                        stacked[key] = torch.empty(
                            (spec.num_experts, *t.shape), dtype=t.dtype, device=dev)
                    stacked[key][e].copy_(t)
                else:
                    _tree_set(tree, path, t)
            elif mla and name.endswith("self_attn.kv_b_proj.weight"):
                # the fused per-head up-projections [H * (dn + dv), dc]
                li = ("layers", int(name.split(".")[2]))
                H, dn = spec.num_heads, spec.qk_nope_head_dim
                t = read(r, name, dtype).reshape(H, dn + spec.v_head_dim, -1)
                _tree_set(tree, li + ("w_uk",), t[:, :dn].transpose(1, 2).contiguous())
                _tree_set(tree, li + ("w_uv",), t[:, dn:].transpose(1, 2).contiguous())
                seen.add(name)
            elif fused and name.endswith(tuple(".mlp.experts." + t for t in _FUSED_TAILS)):
                if name.endswith("_bias") and not spec.moe_bias:
                    skipped.append(name)
                    continue
                mo = ("layers", int(name.split(".")[2]), "moe")
                t = read(r, name, dtype)
                if name.endswith("gate_up_proj"):
                    _tree_set(tree, mo + ("w_gate",), t[..., 0::2].contiguous())
                    _tree_set(tree, mo + ("w_up",), t[..., 1::2].contiguous())
                elif name.endswith("gate_up_proj_bias"):
                    _tree_set(tree, mo + ("b_gate",), t[..., 0::2].contiguous())
                    _tree_set(tree, mo + ("b_up",), t[..., 1::2].contiguous())
                elif name.endswith("down_proj_bias"):
                    _tree_set(tree, mo + ("b_down",), t)
                else:
                    _tree_set(tree, mo + ("w_down",), t)
                seen.add(name)
            elif name.endswith(("_bias", ".bias", ".sinks")):
                skipped.append(name)
        r.close()
    for key, t in stacked.items():
        _tree_set(tree, key, t)

    expected = set(dest)
    if mla:
        expected |= {f"model.layers.{i}.self_attn.kv_b_proj.weight"
                     for i in range(spec.num_layers)}
    if fused:
        tails = _FUSED_TAILS if spec.moe_bias else _FUSED_TAILS[:2]
        expected |= {f"model.layers.{i}.mlp.experts.{t}"
                     for i in range(spec.num_layers) for t in tails}
    if skipped:
        log.warning("skipped %d tensors with no destination in this spec "
                    "(unexpected for supported architectures), e.g. %s",
                    len(skipped), sorted(skipped)[:3])
    missing = expected - seen
    if missing:
        raise ValueError(f"checkpoint {model_dir} missing {len(missing)} tensors, "
                         f"e.g. {sorted(missing)[:4]}")
    if mla:
        from dynamo_tpu_torch.models.mla import MlaParams as cls
    else:
        cls = LlamaParams
    return cls(tree["embed"], tree["final_norm"], tree["layers"], tree.get("lm_head"))


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gate/up interleaved on the last axis (gpt-oss's fused layout)."""
    return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], 2 * a.shape[-1])


def save_params(
    spec: ModelSpec, params: LlamaParams, model_dir: str, *,
    shard_bytes: int = 2**31,
) -> None:
    """Write params as HF-format safetensors + config.json, split into
    ``model-0000i-of-0000n.safetensors`` shards of at most ``shard_bytes``
    (one ``model.safetensors`` when it fits). Tensors leave the device one
    at a time. A DeepSeek (MLA) spec writes HF's fused ``kv_b_proj`` and,
    with ``rope_interleave``, pair-interleaved rope columns, which its
    config.json declares."""
    os.makedirs(model_dir, exist_ok=True)
    mla = spec.is_mla
    # gpt-oss exports use the fused expert naming (synthesized below)
    dest = (_dest_map_mla(spec) if mla else
            _dest_map(spec, {"model.layers.0.mlp.experts.gate_up_proj"}
                      if spec.moe_bias else None))
    # name -> (dtype code, shape, produce): shapes are declared up front (the
    # header comes first), tensors made one at a time while writing
    entries: dict[str, tuple[str, list[int], Callable[[], torch.Tensor]]] = {}

    def add(name, t: torch.Tensor, shape, produce):
        entries[name] = (_code(t), list(shape), produce)

    for name, (path, transpose, _dt) in dest.items():
        t = _params_get(params, path)
        if mla and spec.rope_interleave and name.endswith(_ROPE_NAMES):
            add(name, t, t.shape[::-1],
                lambda t=t, name=name: _rope_cols(spec, name, t, inverse=True).T)
            continue
        add(name, t, t.shape[::-1] if transpose else t.shape,
            (lambda t=t: t.T) if transpose else (lambda t=t: t))
    if mla:
        H, dn, dv = spec.num_heads, spec.qk_nope_head_dim, spec.v_head_dim
        for i, lp in enumerate(params.layers):
            add(f"model.layers.{i}.self_attn.kv_b_proj.weight", lp.w_uk,
                (H * (dn + dv), spec.kv_lora_rank),
                lambda lp=lp: torch.cat([lp.w_uk.transpose(1, 2), lp.w_uv.transpose(1, 2)],
                                        dim=1).reshape(H * (dn + dv), -1))
    if spec.moe_bias and not mla:
        for i in range(spec.num_layers):
            m = params.layers[i].moe
            p = f"model.layers.{i}.mlp.experts."
            add(p + "gate_up_proj", m.w_gate, (*m.w_gate.shape[:-1], 2 * m.w_gate.shape[-1]),
                lambda m=m: _interleave(m.w_gate, m.w_up))
            add(p + "gate_up_proj_bias", m.b_gate, (*m.b_gate.shape[:-1], 2 * m.b_gate.shape[-1]),
                lambda m=m: _interleave(m.b_gate, m.b_up))
            add(p + "down_proj", m.w_down, m.w_down.shape, lambda m=m: m.w_down)
            add(p + "down_proj_bias", m.b_down, m.b_down.shape, lambda m=m: m.b_down)

    shards: list[list[tuple]] = [[]]
    size = 0
    for name in sorted(entries):
        code, shape, produce = entries[name]
        nbytes = _header_entry(code, shape)
        if size + nbytes > shard_bytes and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append((name, code, shape, produce))
        size += nbytes
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = ("model.safetensors" if n == 1
                 else f"model-{i + 1:05d}-of-{n:05d}.safetensors")
        _write_file(os.path.join(model_dir, fname), shard, {"format": "pt"})
    cfg = hf_config_from_spec(spec)
    if mla:
        cfg["rope_interleave"] = spec.rope_interleave  # the columns as written
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def load_model_dir(
    model_dir: str, *, mesh=None, dtype: str | None = None,
    name: str | None = None, device: str | torch.device | None = None,
) -> tuple[ModelSpec, LlamaParams]:
    """One call: config.json -> spec, safetensors -> params on ``device``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    spec = spec_from_hf_config(
        cfg, name=name or os.path.basename(model_dir.rstrip("/")))
    return spec, load_params(spec, model_dir, mesh=mesh, dtype=dtype, device=device)
