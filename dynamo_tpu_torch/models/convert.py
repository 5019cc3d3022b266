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
