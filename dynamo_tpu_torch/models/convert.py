"""Weights from the JAX parameter pytree, given as numpy arrays.

``params_from_numpy(spec, tree, device)`` builds the port's ``LlamaParams``
from the tree ``dynamo_tpu.models.llama.init_params`` returns, or its
``MlaParams`` from ``dynamo_tpu.models.mla.init_params``' (an MLA spec), or
from what a checkpoint loader would return, after ``np.asarray`` on every
leaf. That is how
every parity test gives both packages the same weights. bf16 leaves arrive
as ``ml_dtypes.bfloat16`` arrays; their bits pass through ``uint16`` so this
module never imports ml_dtypes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models.llama import LlamaParams, resolve_device, torch_dtype

# a MoE layer's leaves kept in f32 whatever the model dtype (the reference's
# init and loader keep them so)
F32_MOE_LEAVES = ("router", "router_bias", "score_bias")


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    """A writable copy of ``arr`` as a tensor on ``device`` (JAX hands out
    read-only host views)."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(
    spec: ModelSpec, tree: dict[str, Any], device: str | torch.device | None = None
) -> LlamaParams:
    """The JAX pytree ``{"embed", "final_norm", ["lm_head"], "layers": [...]}``
    as the port's modules, in the spec's dtype (a layer's ``moe`` and, for
    DeepSeek, ``shared`` dicts nested, the router leaves f32)."""
    dev = resolve_device(device)
    dtype = torch_dtype(spec.dtype)

    def conv(a, dt=dtype):
        return tensor_from_numpy(a, dev).to(dt)

    def conv_moe(moe):
        # the router and its biases stay f32: rounded to bf16 they would
        # pick other experts
        return {name: conv(a, torch.float32 if name in F32_MOE_LEAVES else dtype)
                for name, a in moe.items()}

    def conv_leaf(name, a):
        if name == "moe":
            return conv_moe(a)
        if isinstance(a, dict):  # MLA's shared experts
            return {k: conv(v) for k, v in a.items()}
        return conv(a)

    layers = [{name: conv_leaf(name, a) for name, a in lp.items()}
              for lp in tree["layers"]]
    lm_head = None if spec.tie_embeddings else conv(tree["lm_head"])
    if spec.is_mla:
        from dynamo_tpu_torch.models.mla import MlaParams as cls
    else:
        cls = LlamaParams
    return cls(conv(tree["embed"]), conv(tree["final_norm"]), layers, lm_head)


# -------------------------------------------------------------- tp shards

# the axis each llama leaf is split on under tensor parallelism (the
# reference's ``llama.param_shardings``: Megatron columns for the heads'
# and FFN's input projections, rows for their output projections, the
# embedding on d, an untied lm head on the vocabulary); absent: replicated
SHARD_DIMS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "bq": 0, "bk": 0, "bv": 0, "sinks": 0,
    "w_gate": 1, "w_up": 1, "w_down": 0,
    "embed": 1, "lm_head": 1,
}


def check_shardable(spec: ModelSpec, tp) -> None:
    """Raise unless the spec's dense llama layout divides over ``tp``
    ranks (a count, or a mesh): heads, KV heads, FFN width, hidden size and
    an untied vocabulary. MoE and MLA specs are refused first (ROADMAP
    Queue A item 11b)."""
    if spec.is_mla or spec.num_experts:
        raise NotImplementedError(
            f"{spec.name}: tensor parallelism of MoE and MLA layers is ROADMAP "
            "Queue A item 11b (expert parallelism and the MoE/MLA shardings)")
    tp = tp if isinstance(tp, int) else tp.tp
    sizes = {"num_heads": spec.num_heads, "num_kv_heads": spec.num_kv_heads,
             "intermediate_size": spec.intermediate_size,
             "hidden_size": spec.hidden_size}
    if not spec.tie_embeddings:
        sizes["vocab_size"] = spec.vocab_size
    for name, n in sizes.items():
        if n % tp:
            raise ValueError(f"{spec.name}: {name} {n} does not divide over tp={tp}")


def shard_tensor(name: str, t, mesh):
    """Rank ``mesh.tp_rank``'s contiguous slice of leaf ``name`` (a tensor
    or a numpy array), a copy; a replicated leaf comes back as it is."""
    dim = SHARD_DIMS.get(name)
    if dim is None:
        return t
    sl = [slice(None)] * t.ndim
    sl[dim] = mesh.shard(t.shape[dim], name)
    part = t[tuple(sl)]
    return part.clone() if isinstance(part, torch.Tensor) else np.array(part, copy=True)


def shard_params(spec: ModelSpec, params, mesh,
                 device: str | torch.device | None = None) -> LlamaParams:
    """This rank's shard of the full weights: the port's ``LlamaParams``,
    or the JAX pytree as numpy (through ``params_from_numpy``, cut before
    it reaches ``device``). Each leaf equals, bit for bit, the JAX array's
    ``addressable_shards[rank]`` under ``llama.param_shardings(spec,
    make_mesh(tp=N))``. The result carries ``mesh``: the forwards run
    their collectives over it."""
    check_shardable(spec, mesh.tp)
    if isinstance(params, dict):
        tree = {name: shard_tensor(name, a, mesh) for name, a in params.items()
                if name != "layers"}
        tree["layers"] = [{name: shard_tensor(name, a, mesh) for name, a in lp.items()}
                          for lp in params["layers"]]
        out = params_from_numpy(spec, tree, device)
    else:
        layers = [{name: shard_tensor(name, p.data, mesh)
                   for name, p in lp.named_parameters()} for lp in params.layers]
        out = LlamaParams(
            shard_tensor("embed", params.embed.data, mesh), params.final_norm.data,
            layers, None if params.lm_head is None
            else shard_tensor("lm_head", params.lm_head.data, mesh))
    out.mesh = mesh
    return out
