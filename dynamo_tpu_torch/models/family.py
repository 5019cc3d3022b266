"""Model-family dispatch (counterpart of dynamo_tpu/models/family.py).

The engine drives a small adapter surface (params/cache init, prefill,
packed prefill, the one decode step its bursts run and the speculative
verify, both of which its CUDA graphs capture) and the adapter maps it
onto the family's functional core. The port has the GQA family (llama,
mistral, mixtral, qwen-moe, gpt-oss: dense or routed-expert MLPs); the MLA
family (DeepSeek) is ROADMAP Queue A item 9.

Engine contract, as the reference's (dynamo_tpu/models/family.py): prefill,
packed prefill and verify return ``(result, moe_dropped)``, the second an
int32 device scalar the engine sums without a host read; the pools update
in place.
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.engine.config import ModelSpec

__all__ = ["get_family", "GqaFamily"]


class GqaFamily:
    """llama-family adapter: thin passthrough to models/llama.py."""

    supports_logprobs = True
    supports_spec_decode = True

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
        """(last logits [V], moe_dropped)."""
        return self.m.prefill_forward(spec, params, tokens, bt, start, k, v, n)

    def prefill_batch(self, spec, params, tokens, bts, starts, k, v, ns):
        """(last logits [N, V], moe_dropped)."""
        return self.m.prefill_forward_batch(
            spec, params, tokens, bts, starts, k, v, ns
        )

    def verify(self, spec, params, tokens, bts, starts, k, v, ntoks,
               allowed=None):
        """Speculative verify: (targets [N, W] int32, moe_dropped), both on
        the device (engine/graphs.py VerifyGraphs captures it), argmax
        under the guided [N, W, V] ``allowed`` masks when given."""
        return self.m.verify_forward(spec, params, tokens, bts, starts, k, v,
                                     ntoks, allowed)

    def decode_step(self, spec, params, k, v, t, *, sampled, n_logprobs):
        """One model step over fixed tensors (engine/graphs.py captures
        it); ``t.allowed``, when set, is the guided [B, V] mask."""
        self.m.decode_step_(spec, params, k, v, t, sampled=sampled,
                            n_logprobs=n_logprobs)


def get_family(spec: ModelSpec) -> Any:
    if spec.is_mla:
        raise NotImplementedError(
            f"{spec.name}: MLA latent attention is not ported (ROADMAP Queue A "
            "item 9: models/mla.py + MlaFamily)"
        )
    return GqaFamily()
