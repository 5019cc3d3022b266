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


# ----------------------------------------------------------- mesh shards

# the axis each llama / MLA leaf is split on over ``tp`` (the reference's
# ``llama.param_shardings`` and ``mla.param_shardings``: Megatron columns
# for the heads' and FFN's input projections, rows for their output
# projections, the per-head up-projections on their head axis, the
# embedding on d, an untied lm head on the vocabulary); absent: replicated
# (norms, MLA's latent path ``w_kv_a`` / ``kv_norm`` and its q-LoRA
# ``wq_a`` / ``q_norm``). A dense FFN's and the shared experts' leaves
# follow ``w_gate`` / ``w_up`` / ``w_down``.
SHARD_DIMS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "bq": 0, "bk": 0, "bv": 0, "sinks": 0,
    "w_gate": 1, "w_up": 1, "w_down": 0,
    "wq_b": 1, "w_uk": 0, "w_uv": 0,
    "embed": 1, "lm_head": 1,
}

# a MoE layer's leaves over the mesh (the reference's
# ``moe.moe_layer_shardings``): experts on ``ep``, their FFN columns on
# ``tp``; the router and its biases replicated
MOE_SHARD_AXES = {
    "w_gate": ("ep", None, "tp"), "w_up": ("ep", None, "tp"),
    "w_down": ("ep", "tp", None),
    "b_gate": ("ep", "tp"), "b_up": ("ep", "tp"), "b_down": ("ep", None),
}


def _axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis sizes from a tp count, an axis-size dict or a Mesh."""
    if isinstance(mesh, int):
        return {"tp": mesh, "ep": 1, "pp": 1}
    sizes = mesh if isinstance(mesh, dict) else mesh.shape
    return {a: sizes.get(a, 1) for a in ("tp", "ep", "pp")}


def stage_layers(spec: ModelSpec, mesh) -> range:
    """The layers this rank holds: its pipeline stage's ``L / pp``
    consecutive layers (all of them at pp 1; the reference's
    ``pp_param_shardings`` puts the stacked layer axis on ``pp``)."""
    if mesh is None or mesh.shape.get("pp", 1) == 1:
        return range(spec.num_layers)
    sl = mesh.shard(spec.num_layers, "layers", "pp")
    return range(sl.start, sl.stop)


def check_shardable(spec: ModelSpec, mesh) -> None:
    """Raise unless the spec divides over ``mesh`` (a tp count, a dict of
    axis sizes or a Mesh): over tp the heads (and a GQA spec's KV heads),
    the FFN widths (dense, experts', shared experts'), the hidden size and
    an untied vocabulary; over ep the experts. A dense spec under ep runs
    replicated along it, as in the reference."""
    sz = _axis_sizes(mesh)
    tp, ep = sz["tp"], sz["ep"]
    if spec.num_layers % sz["pp"]:
        raise ValueError(
            f"{spec.name}: num_layers {spec.num_layers} does not divide over pp={sz['pp']}")
    sizes = {"num_heads": spec.num_heads, "hidden_size": spec.hidden_size}
    if not spec.is_mla:
        sizes["num_kv_heads"] = spec.num_kv_heads
    if not spec.tie_embeddings:
        sizes["vocab_size"] = spec.vocab_size
    if not spec.num_experts or (spec.is_mla and spec.first_k_dense):
        sizes["intermediate_size"] = spec.intermediate_size
    if spec.num_experts:
        sizes["moe_intermediate_size"] = spec.moe_intermediate_size
        if spec.is_mla and spec.n_shared_experts:
            sizes["shared expert width"] = spec.moe_intermediate_size * spec.n_shared_experts
    for name, n in sizes.items():
        if n % tp:
            raise ValueError(f"{spec.name}: {name} {n} does not divide over tp={tp}")
    if spec.num_experts and spec.num_experts % ep:
        raise ValueError(
            f"{spec.name}: num_experts {spec.num_experts} does not divide over ep={ep}")


def shard_axes(t, axes, mesh):
    """A copy of ``t`` cut to this rank's slice along each dim whose
    ``axes`` entry names a mesh axis (``t`` itself when none does)."""
    if not axes or all(a is None for a in axes):
        return t
    sl = tuple(slice(None) if a is None else mesh.shard(t.shape[d], f"axis {d}", a)
               for d, a in enumerate(axes))
    part = t[sl]
    return part.clone() if isinstance(part, torch.Tensor) else np.array(part, copy=True)


def shard_tensor(name: str, t, mesh):
    """Rank ``mesh``'s slice of leaf ``name`` (a tensor or a numpy array), a
    copy: a ``moe`` dict cut by MOE_SHARD_AXES, a dict of shared experts'
    leaves by SHARD_DIMS, a replicated leaf as it is."""
    if name == "moe":
        return {k: shard_axes(v, MOE_SHARD_AXES.get(k), mesh) for k, v in t.items()}
    if isinstance(t, dict):
        return {k: shard_tensor(k, v, mesh) for k, v in t.items()}
    dim = SHARD_DIMS.get(name)
    if dim is None or (name == "embed" and mesh.shape.get("pp", 1) > 1):
        return t  # pipeline stages hold the whole embedding (pp_param_shardings)
    return shard_axes(t, [None] * dim + ["tp"], mesh)


def _layer_tree(module) -> dict:
    """A layer module's leaves as a (nested) dict of tensors."""
    out = {name: p.data for name, p in module._parameters.items() if p is not None}
    out.update((name, _layer_tree(m)) for name, m in module._modules.items())
    return out


def shard_params(spec: ModelSpec, params, mesh,
                 device: str | torch.device | None = None) -> LlamaParams:
    """This rank's shard of the full weights: the port's params (a
    ``LlamaParams`` or MLA's ``MlaParams``), or the JAX pytree as numpy
    (through ``params_from_numpy``, cut before it reaches ``device``).
    Each leaf equals, bit for bit, the JAX array's
    ``addressable_shards[rank]`` under the family's ``param_shardings(spec,
    make_mesh(ep=E, tp=N))``. Under pp > 1 the result holds the rank's
    stage's layers only (``stage_layers``) and the whole embedding, as
    the reference's ``pp_param_shardings``. The result carries ``mesh``:
    the forwards run their collectives over it."""
    check_shardable(spec, mesh)
    mine = stage_layers(spec, mesh)
    if isinstance(params, dict):
        tree = {name: shard_tensor(name, a, mesh) for name, a in params.items()
                if name != "layers"}
        tree["layers"] = [{name: shard_tensor(name, a, mesh) for name, a in lp.items()}
                          for lp in (params["layers"][i] for i in mine)]
        out = params_from_numpy(spec, tree, device)
    else:
        layers = [{name: shard_tensor(name, t, mesh) for name, t in _layer_tree(lp).items()}
                  for lp in (params.layers[i] for i in mine)]
        out = type(params)(
            shard_tensor("embed", params.embed.data, mesh), params.final_norm.data,
            layers, None if params.lm_head is None
            else shard_tensor("lm_head", params.lm_head.data, mesh))
    out.mesh = mesh
    return out
