"""Model-family dispatch (counterpart of dynamo_tpu/models/family.py).

The engine drives a small adapter surface (params/cache init, prefill,
packed prefill, the one decode step its bursts run and the speculative
verify, both of which its CUDA graphs capture, and the eager decode burst)
and the adapter maps it onto the family's functional core. The port has
the GQA family (llama, mistral, mixtral, qwen-moe, gpt-oss: dense or
routed-expert MLPs) and the MLA family (DeepSeek-V2/V3/R1: latent
attention, models/mla.py).

Engine contract, as the reference's (dynamo_tpu/models/family.py): prefill,
packed prefill and verify return ``(result, moe_dropped)``, the second an
int32 device scalar the engine sums without a host read; the pools update
in place. The MLA family's ``moe_dropped`` is always 0, as the
reference's.
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.engine.config import ModelSpec

__all__ = ["get_family", "GqaFamily", "MlaFamily"]


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

    def decode_steps(self, spec, params, tokens, bts, lens, k, v, active,
                     temps, topk, topp, seeds, steps, *, n_steps, n_logprobs,
                     allowed=None):
        """The eager burst (``llama.decode_steps``' results)."""
        return self.m.decode_steps(spec, params, tokens, bts, lens, k, v, active,
                                   temps, topk, topp, seeds, steps, n_steps=n_steps,
                                   n_logprobs=n_logprobs, allowed=allowed)


class MlaFamily(GqaFamily):
    """DeepSeek MLA adapter: the latent cache rides the ``k_pages`` slot,
    and ``v_pages`` carries an inert empty placeholder (no bytes, so the
    engine's ``pool_bytes`` is the latent cache's). Prefill, packed
    prefill and verify report 0 dropped MoE slots, as the reference's MLA
    family does. Not here, as in the reference or the port: ring prefill
    (off in the reference's MLA family), embeddings (ROADMAP Queue A item
    12) and meshes (item 11)."""

    def __init__(self):
        from dynamo_tpu_torch.models import mla

        self.m = mla

    def init_cache(self, spec, num_pages, page_size, device=None,
                   kv_dtype="bf16"):
        import torch

        cache = self.m.init_cache(spec, num_pages, page_size, device=device,
                                  kv_dtype=kv_dtype)
        return cache, torch.zeros((0,), dtype=torch.int8, device=cache.device)

    def prefill(self, spec, params, tokens, bt, start, k, v, n):
        return self.m.prefill_forward(spec, params, tokens, bt, start, k, n)

    def prefill_batch(self, spec, params, tokens, bts, starts, k, v, ns):
        return self.m.prefill_forward_batch(spec, params, tokens, bts, starts, k, ns)

    def verify(self, spec, params, tokens, bts, starts, k, v, ntoks,
               allowed=None):
        return self.m.verify_forward(spec, params, tokens, bts, starts, k, ntoks,
                                     allowed)

    def decode_steps(self, spec, params, tokens, bts, lens, k, v, active,
                     temps, topk, topp, seeds, steps, *, n_steps, n_logprobs,
                     allowed=None):
        return self.m.decode_steps(spec, params, tokens, bts, lens, k, active,
                                   temps, topk, topp, seeds, steps, n_steps=n_steps,
                                   n_logprobs=n_logprobs, allowed=allowed)


def get_family(spec: ModelSpec) -> Any:
    return MlaFamily() if spec.is_mla else GqaFamily()
