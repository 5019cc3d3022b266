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

KVBM page movement: ``extract_pages`` gathers whole pages into new tensors
(packed ``uint8`` payloads on fp8 pools) and ``insert_pages`` writes them
back IN PLACE and returns nothing: the engine never rebinds its pools,
which its captured graphs read at their captured addresses.
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.engine.config import ModelSpec

__all__ = ["get_family", "GqaFamily", "MlaFamily"]


class GqaFamily:
    """llama-family adapter: thin passthrough to models/llama.py. Its specs
    shard over a mesh (``supports_mesh``): heads, KV heads and dense FFN
    columns over tp whatever ep is, a MoE spec's experts over ep x tp,
    replicated over sp and dp. Ring prefill (``prefill_ring``) serves cold
    prompts over the sp ranks, except for a spec with attention extras
    (gpt-oss's sinks and sliding window: the ring has neither), as the
    reference's family does."""

    supports_mesh = True
    supports_logprobs = True
    supports_spec_decode = True
    supports_embeddings = True
    supports_multimodal = True  # prefill embedding injection (EPD)
    supports_ring_prefill = True
    # under tp a rank's pools hold its KV heads: disagg exports, resumes and
    # mirror syncs split and join blocks on the heads axis
    shards_kv_heads = True

    def __init__(self, spec: ModelSpec | None = None):
        from dynamo_tpu_torch.models import llama

        self.m = llama
        if spec is not None and spec.has_attn_extras:
            self.supports_ring_prefill = False

    def init_params(self, spec, seed, device=None, mesh=None):
        """The seeded init; with a ``mesh``, this rank's shard of it."""
        return self.m.init_params(spec, seed, device=device, mesh=mesh)

    def shard_params(self, spec, params, mesh):
        """This rank's shard of full weights (models/convert.shard_params)."""
        from dynamo_tpu_torch.models.convert import shard_params

        return shard_params(spec, params, mesh, device=mesh.device)

    def init_cache(self, spec, num_pages, page_size, device=None,
                   kv_dtype="bf16", tp=1):
        """Pools of ``num_pages`` pages; under tp, of this rank's KV heads
        (the reference's ``cache_shardings``)."""
        return self.m.init_cache(spec, num_pages, page_size, device=device,
                                 kv_dtype=kv_dtype, tp=tp)

    def prefill(self, spec, params, tokens, bt, start, k, v, n,
                mm_embeds=None, mm_pos=None):
        """(last logits [V], moe_dropped); ``mm_embeds [M, d]`` overwrite
        the embedded rows at ``mm_pos [M]``."""
        return self.m.prefill_forward(spec, params, tokens, bt, start, k, v, n,
                                      mm_embeds=mm_embeds, mm_pos=mm_pos)

    def prefill_batch(self, spec, params, tokens, bts, starts, k, v, ns):
        """(last logits [N, V], moe_dropped)."""
        return self.m.prefill_forward_batch(
            spec, params, tokens, bts, starts, k, v, ns
        )

    def prefill_ring(self, spec, params, tokens, bt, k, v, n):
        """Sequence-parallel cold prefill over the params' sp ranks: (last
        logits [V], moe_dropped)."""
        return self.m.prefill_forward_ring(spec, params, tokens, bt, k, v, n)

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

    def embed_forward(self, spec, params, tokens, num_tokens):
        """Pooled, L2-normalized sequence embedding [hidden] f32."""
        return self.m.embed_forward(spec, params, tokens, num_tokens)

    def extract_pages(self, k, v, page_ids):
        """Blocks ``[L, n, KH, page, D]`` x2 (packed ``uint8 [L, n, X]`` x2
        on fp8 pools)."""
        from dynamo_tpu_torch.models import llama

        return llama.extract_kv_pages(k, v, page_ids)

    def insert_pages(self, k, v, page_ids, kb, vb) -> None:
        from dynamo_tpu_torch.models import llama

        llama.insert_kv_pages(k, v, page_ids, kb, vb)


class MlaFamily(GqaFamily):
    """DeepSeek MLA adapter: the latent cache rides the ``k_pages`` slot,
    and ``v_pages`` carries an inert empty placeholder (no bytes, so the
    engine's ``pool_bytes`` is the latent cache's). Prefill, packed
    prefill and verify report 0 dropped MoE slots, as the reference's MLA
    family does. It serves embeddings but takes no image input, as the
    reference's. Under a mesh the heads shard over tp, the routed experts
    over ep x tp, and the latent pool stays whole on every rank (the
    reference's ``mla.cache_shardings`` replicates it). Not here, as in the
    reference: ring prefill (off in the reference's MLA family)."""

    supports_multimodal = False
    supports_ring_prefill = False
    shards_kv_heads = False  # the latent pool is whole on every rank

    def __init__(self):
        from dynamo_tpu_torch.models import mla

        self.m = mla

    def init_cache(self, spec, num_pages, page_size, device=None,
                   kv_dtype="bf16", tp=1):
        """The whole latent pool (replicated over the mesh: ``tp`` is not
        used) and the inert v placeholder."""
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

    def extract_pages(self, k, v, page_ids):
        """Latent blocks ``[L, n, page, dc + dr]`` (packed ``uint8 [L, n,
        X]`` on an fp8 latent pool) and the reference's inert v slot, int8
        zeros ``[1, n]``, which tier payloads carry as the reference's do."""
        import torch

        from dynamo_tpu_torch.models import llama

        blocks = llama.extract_pool_pages(k, page_ids)
        return blocks, torch.zeros((1, page_ids.numel()), dtype=torch.int8,
                                   device=blocks.device)

    def insert_pages(self, k, v, page_ids, kb, vb) -> None:
        from dynamo_tpu_torch.models import llama

        llama.insert_pool_pages_(k, page_ids, kb)


def get_family(spec: ModelSpec) -> Any:
    return MlaFamily() if spec.is_mla else GqaFamily(spec)
