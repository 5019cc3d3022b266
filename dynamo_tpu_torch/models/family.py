"""Model-family dispatch (counterpart of dynamo_tpu/models/family.py).

The engine drives a small adapter surface (params/cache init, prefill,
packed prefill, and the one decode step its bursts run, which its CUDA
graphs capture) and the adapter maps it onto the family's
functional core. This slice ports the dense GQA family only.
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.engine.config import ModelSpec

__all__ = ["get_family", "GqaFamily"]


class GqaFamily:
    """llama-family adapter: thin passthrough to models/llama.py."""

    supports_logprobs = True

    def __init__(self):
        from dynamo_tpu_torch.models import llama

        self.m = llama

    def init_params(self, spec, seed, device=None):
        return self.m.init_params(spec, seed, device=device)

    def init_cache(self, spec, num_pages, page_size, device=None,
                   kv_dtype="bf16"):
        return self.m.init_cache(spec, num_pages, page_size, device=device,
                                 kv_dtype=kv_dtype)

    def prefill(self, spec, params, tokens, bt, start, k, v, n):
        return self.m.prefill_forward(spec, params, tokens, bt, start, k, v, n)

    def prefill_batch(self, spec, params, tokens, bts, starts, k, v, ns):
        return self.m.prefill_forward_batch(
            spec, params, tokens, bts, starts, k, v, ns
        )

    def decode_step(self, spec, params, k, v, t, *, sampled, n_logprobs):
        """One model step over fixed tensors (engine/graphs.py captures
        it)."""
        self.m.decode_step_(spec, params, k, v, t, sampled=sampled,
                            n_logprobs=n_logprobs)


def get_family(spec: ModelSpec) -> Any:
    if spec.is_mla:
        raise NotImplementedError(
            f"{spec.name}: MLA latent attention arrives with the port's MLA "
            "slice (models/mla.py + MlaFamily)"
        )
    if spec.num_experts:
        raise NotImplementedError(
            f"{spec.name}: mixture-of-experts layers arrive with the port's "
            "gpt-oss/MoE slice (models/moe.py)"
        )
    return GqaFamily()
