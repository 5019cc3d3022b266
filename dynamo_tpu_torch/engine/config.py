"""Model + engine configuration (a copy of dynamo_tpu/engine/config.py).

ModelSpec describes a llama-family transformer (all the models the reference
recipes target are in-family or MoE variants); EngineConfig describes the
serving engine's memory and batching envelope.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class ModelSpec:
    name: str = "tiny-test"
    vocab_size: int = 272  # mock-tokenizer-compatible default
    hidden_size: int = 128
    intermediate_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # MoE (0 experts = dense)
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0  # always-on dense experts (DeepSeek)
    first_k_dense: int = 0  # leading layers with plain dense MLP
    # routing flavor: "softmax" (mixtral/qwen/gpt-oss) or "sigmoid"
    # (DeepSeek-V3 noaux_tc: sigmoid scores + learned correction bias +
    # group-limited top-k + routed scaling)
    moe_scoring: str = "softmax"
    n_group: int = 0  # expert groups for group-limited routing (0 = off)
    topk_group: int = 0  # groups each token may route into
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    # MLA (DeepSeek-family latent attention; 0 = plain GQA attention)
    kv_lora_rank: int = 0  # latent dim d_c (the per-token KV cache row)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0  # decoupled-RoPE key dim, shared across heads
    v_head_dim: int = 0
    q_lora_rank: int = 0  # query low-rank compression (0 = full q_proj)
    # gpt-oss attention extras (ref recipes/gpt-oss-120b; HF GptOssConfig)
    sliding_window: int = 0  # 0 = full attention everywhere
    layer_types: tuple[str, ...] = ()  # per-layer "sliding_attention" /
    # "full_attention"; empty + sliding_window>0 = every layer windowed
    attn_sinks: bool = False  # learned per-head sink logits in softmax
    attn_bias: bool = False  # q/k/v/o projection biases
    moe_bias: bool = False  # router + expert (gate_up/down) biases
    swiglu_limit: float = 0.0  # clamped swiglu bound (gpt-oss 7.0); 0 = off
    swiglu_alpha: float = 0.0  # swish slope inside clamp (gpt-oss 1.702)
    # YaRN rope scaling (gpt-oss, DeepSeek-R1; HF _compute_yarn_parameters)
    rope_scaling_factor: float = 0.0  # 0 = no scaling
    rope_orig_max_pos: int = 0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.0  # 0 = unset
    rope_mscale_all_dim: float = 0.0
    rope_truncate: bool = True  # floor/ceil the correction range bounds
    # checkpoint stores rope dims pair-interleaved (DeepSeek MLA weights);
    # the loader de-interleaves q_rope/k_rope projection columns to our
    # half-split convention — exact, since both sides of every rope-dim
    # dot product get the same permutation
    rope_interleave: bool = False

    def attn_window(self, li: int) -> int:
        """Sliding-window size for layer ``li`` (0 = full attention)."""
        if not self.sliding_window:
            return 0
        if self.layer_types:
            return (
                self.sliding_window
                if self.layer_types[li] == "sliding_attention" else 0
            )
        return self.sliding_window

    @property
    def has_attn_extras(self) -> bool:
        return bool(self.sliding_window or self.attn_sinks)

    @classmethod
    def llama3_8b(cls) -> "ModelSpec":
        return cls(
            name="llama-3-8b", vocab_size=128256, hidden_size=4096,
            intermediate_size=14336, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, tie_embeddings=False,
        )

    @classmethod
    def llama3_70b(cls) -> "ModelSpec":
        return cls(
            name="llama-3-70b", vocab_size=128256, hidden_size=8192,
            intermediate_size=28672, num_layers=80, num_heads=64,
            num_kv_heads=8, head_dim=128, tie_embeddings=False,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 272) -> "ModelSpec":
        return cls(vocab_size=vocab_size)

    @classmethod
    def dryrun(cls) -> "ModelSpec":
        """Tiny spec with kv_heads=8 so tp up to 8 divides the KV head axis
        (shared by bench.py's CPU smoke and __graft_entry__)."""
        return cls(
            name="dryrun", vocab_size=512, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=8,
            num_kv_heads=8, head_dim=32, tie_embeddings=True,
        )

    @classmethod
    def tiny_moe(cls) -> "ModelSpec":
        return cls(
            name="tiny-moe", vocab_size=272, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, dtype="float32",
            num_experts=4, num_experts_per_token=2, moe_intermediate_size=64,
        )

    @classmethod
    def mixtral_8x7b(cls) -> "ModelSpec":
        return cls(
            name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
            intermediate_size=14336, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, tie_embeddings=False,
            num_experts=8, num_experts_per_token=2,
            moe_intermediate_size=14336,
        )

    @classmethod
    def gpt_oss_120b(cls) -> "ModelSpec":
        """Wide-EP config (ref: engine_configs gpt-oss-120b recipes), with
        the full attention feature set: alternating sliding-window/full
        layers, attention sinks, projection + expert biases, clamped
        swiglu, YaRN rope (HF GptOssConfig values)."""
        return cls(
            name="gpt-oss-120b", vocab_size=201088, hidden_size=2880,
            intermediate_size=2880, num_layers=36, num_heads=64,
            num_kv_heads=8, head_dim=64, tie_embeddings=False,
            rope_theta=150000.0,
            num_experts=128, num_experts_per_token=4,
            moe_intermediate_size=2880,
            sliding_window=128,
            layer_types=tuple(
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(36)
            ),
            attn_sinks=True, attn_bias=True, moe_bias=True,
            swiglu_limit=7.0, swiglu_alpha=1.702,
            rope_scaling_factor=32.0, rope_orig_max_pos=4096,
            rope_truncate=False,
        )

    @classmethod
    def tiny_gpt_oss(cls) -> "ModelSpec":
        """Toy gpt-oss architecture at test scale: every flagship
        attention extra on (sinks, alternating sliding windows, biases,
        clamped swiglu, YaRN)."""
        return cls(
            name="tiny-gpt-oss", vocab_size=96, hidden_size=32,
            intermediate_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8, dtype="float32",
            tie_embeddings=False, rope_theta=150000.0,
            num_experts=4, num_experts_per_token=2,
            moe_intermediate_size=32,
            sliding_window=8,
            layer_types=("sliding_attention", "full_attention"),
            attn_sinks=True, attn_bias=True, moe_bias=True,
            swiglu_limit=7.0, swiglu_alpha=1.702,
            rope_scaling_factor=32.0, rope_orig_max_pos=4096,
            rope_truncate=False,
        )

    @classmethod
    def deepseek_r1(cls) -> "ModelSpec":
        """DeepSeek-R1/V3 (ref recipes/deepseek-r1/): MLA + wide MoE with
        one shared expert and 3 leading dense layers."""
        return cls(
            name="deepseek-r1", vocab_size=129280, hidden_size=7168,
            intermediate_size=18432, num_layers=61, num_heads=128,
            num_kv_heads=128, head_dim=128, tie_embeddings=False,
            rope_theta=10000.0,
            rope_scaling_factor=40.0, rope_orig_max_pos=4096,
            rope_mscale=1.0, rope_mscale_all_dim=1.0,
            rope_interleave=True,
            num_experts=256, num_experts_per_token=8,
            moe_scoring="sigmoid", n_group=8, topk_group=4,
            routed_scaling_factor=2.5,
            moe_intermediate_size=2048, n_shared_experts=1,
            first_k_dense=3,
            kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128, q_lora_rank=1536,
        )

    @classmethod
    def tiny_deepseek(cls) -> "ModelSpec":
        """Toy MLA+MoE spec: the deepseek-r1 architecture at test scale."""
        return cls(
            name="tiny-deepseek", vocab_size=96, hidden_size=32,
            intermediate_size=64, num_layers=3, num_heads=4,
            num_kv_heads=4, head_dim=16, dtype="float32",
            tie_embeddings=False,
            num_experts=4, num_experts_per_token=2,
            moe_scoring="sigmoid", n_group=2, topk_group=1,
            routed_scaling_factor=2.5,
            moe_intermediate_size=32, n_shared_experts=1, first_k_dense=1,
            kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, q_lora_rank=24,
        )

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @classmethod
    def preset(cls, name: str) -> "ModelSpec":
        presets = {
            "tiny-test": cls.tiny,
            "tiny-moe": cls.tiny_moe,
            "tiny-deepseek": cls.tiny_deepseek,
            "tiny-gpt-oss": cls.tiny_gpt_oss,
            "llama-3-8b": cls.llama3_8b,
            "llama-3-70b": cls.llama3_70b,
            "mixtral-8x7b": cls.mixtral_8x7b,
            "gpt-oss-120b": cls.gpt_oss_120b,
            "deepseek-r1": cls.deepseek_r1,
        }
        if name in presets:
            return presets[name]()
        raise KeyError(f"unknown model preset {name!r}")


@dataclass
class EngineConfig:
    """The JAX engine's config, field for field, and every field is read by
    the port's engine. A field of a feature the port lacks would be listed
    in UNPORTED (none is now): a value other than the default there raises
    NotImplementedError naming its ROADMAP Queue A item. ``pp`` > 1 raises
    ValueError: pipeline stages are parallel/pipeline.py's, not the
    engine's."""

    # -- read by the port's engine ------------------------------------------
    page_size: int = 16  # tokens per page (= router block_size granularity)
    num_pages: int = 2048  # device page budget (the trash page is extra)
    max_pages_per_seq: int = 64  # max context = page_size * this
    # KV-cache storage dtype: "bf16" = unquantized pool in the model dtype,
    # "fp8" = e4m3 values + per-page per-head bf16 scales (ops/quant.py:
    # half the pool's bytes and half the bytes decode attention reads).
    # "" consults DYN_KV_DTYPE, default bf16; an explicit value here wins
    # over the environment.
    kv_dtype: str = ""
    # decode slots (the decode batch). None = auto-size from the page
    # budget: every slot can still hold a full-length context
    max_decode_slots: int | None = 8
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048, 4096)
    # per-step prefill admission token budget while other streams decode
    # (ref: vLLM max_num_batched_tokens)
    max_prefill_tokens_per_step: int = 2048
    # most prompts of one bucket that one packed prefill forward takes
    prefill_pack_size: int = 8
    # decode model steps per dispatch; a stop inside a burst discards the
    # tail host-side
    decode_steps_per_dispatch: int = 1
    # burst cap while prompts wait and the batch is under half full, so a
    # queued prompt is not held behind a long burst. 0 = never cap.
    decode_steps_admit_pending: int = 4
    # longest uncached prompt tail one prefill dispatch takes; a longer
    # prompt prefills in chunks of this many tokens, one per engine step,
    # interleaved with decode bursts (a multiple of page_size: chunks start
    # on page boundaries)
    max_prefill_chunk_tokens: int = 512
    seed: int = 0  # base of the per-request sampling seeds
    step_idle_sleep_s: float = 0.002  # step-thread poll while page-stalled
    # pipelined decode bursts: dispatch ahead with the fed tokens chained
    # on the device, processing each burst's tokens pipeline_depth bursts
    # late, so the host's work hides behind device execution. Stops are
    # detected up to pipeline_depth * decode_steps_per_dispatch tokens late
    # (overshoot discarded). Cancels flush the pipeline; admissions
    # interleave without flushing.
    pipeline_decode: bool = False
    pipeline_depth: int = 2  # in-flight decode bursts when pipelined
    # admission first tokens sampled on the device and landed a step later
    # (the step thread never waits on their copy to the host); off = the
    # synchronous sample-and-emit path
    async_admissions: bool = True
    # when a processed burst frees slots, run the admission pass again in
    # the same step cycle (the replacement's prefill dispatches behind the
    # in-flight burst)
    eager_readmit: bool = True
    # bounded wait for a closed-loop client's resubmission right after its
    # finish item posted, hidden behind an in-flight burst. 0 = don't wait.
    readmit_wait_s: float = 0.002
    # speculative decoding (engine/spec.py): "off" | "ngram" (prompt-lookup
    # drafts, verified in one packed dispatch; greedy, logprob-free slots)
    spec_mode: str = "off"
    spec_k_max: int = 8  # max drafts per verify (verify width k_max + 1)
    spec_ngram_min: int = 1
    spec_ngram_max: int = 4
    spec_ewma_alpha: float = 0.5  # acceptance-rate EWMA weight
    spec_reprobe_tokens: int = 64  # parked-slot tokens between k=1 probes

    # admission queue bound: a request arriving with this many already
    # waiting is refused with ServiceUnavailable (-> migration re-drives
    # on another worker, or HTTP 503 + Retry-After when none can take it),
    # unless a LOWER-priority waiting entry can be shed in its place
    # (engine/tenancy.py shed policy: lowest priority class, most-over-
    # quota tenant, newest entry). The 503's Retry-After derives from live
    # queue depth x recent step time. 0 = off.
    max_waiting: int = 0
    # per-tenant fairness + quotas (engine/tenancy.py): quota spec string
    # ("tenantA:weight=4,rate=1000,burst=2000;*:rate=200") or an already
    # parsed {tenant: TenantQuota} dict. "" = consult DYN_TENANT_QUOTAS,
    # default unmetered equal-weight tenants (the weighted-fair queue
    # still applies; buckets are wide open).
    tenants: str | dict = ""
    # priority preemption: when an interactive request cannot admit (no
    # free slot, or the prompt cannot get pages), pause a BATCH stream
    # (over-quota tenants first, newest admission first). Its complete
    # blocks seal into the prefix cache, its slot and pages free, and it
    # re-enqueues prompt + generated for a transparent resume by
    # re-prefill. False = interactive waits like everyone else.
    preemption: bool = True

    # -- guided decoding (guided/): "off" refuses guided requests; "auto"
    # serves them when the engine has a token vocabulary. The compiler keeps
    # guided_cache_entries compiled grammars in its LRU
    guided_mode: str = "auto"  # "auto" | "off"
    guided_cache_entries: int = 32

    # step-phase profiler (engine/core.py profile_snapshot); also
    # DYNAMO_ENGINE_PROFILE=1
    profile: bool = False

    # capture the decode and verify steps as CUDA graphs on a card; False
    # runs them eagerly (a gloo tp group, whose collectives no graph can
    # capture, needs it)
    cuda_graphs: bool = True

    # the engine's mesh (parallel/): tensor, data, sequence (ring prefill)
    # and expert parallelism; num_pages is per shard, as the reference's.
    # Pipeline stages are a library path (parallel/pipeline.py): the engine
    # refuses pp > 1, where the reference's engine ignores it
    tp: int = 1
    dp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def __post_init__(self) -> None:
        if self.max_decode_slots is None:
            self.max_decode_slots = max(
                8, min(64, self.num_pages // max(1, self.max_pages_per_seq))
            )
        from dynamo_tpu_torch.ops.quant import resolve_kv_dtype

        self.kv_dtype = resolve_kv_dtype(self.kv_dtype)
        if self.pp != 1:
            raise ValueError(
                f"EngineConfig.pp={self.pp}: the engine does not stage layers (the "
                "reference's worker builds its mesh without pp, dynamo_tpu/engine/"
                "worker.py:76); pipeline stages run through parallel/pipeline.py "
                "(stack_params, pp_prefill, pp_decode_step)")
        defaults = _UNPORTED_DEFAULTS
        for name, item in UNPORTED.items():
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"EngineConfig.{name}={value!r}: the port's engine does not "
                    f"have {item}; only the default {defaults[name]!r} is served")
        if isinstance(self.tenants, str):
            from dynamo_tpu_torch.engine.tenancy import parse_tenant_quotas

            spec = self.tenants or os.environ.get("DYN_TENANT_QUOTAS", "")
            self.tenants = parse_tenant_quotas(spec)
        if self.guided_mode not in ("auto", "off"):
            raise ValueError(f"guided_mode {self.guided_mode!r} (auto | off)")

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )


# fields of features the port's engine lacks -> what is missing
UNPORTED: dict[str, str] = {}
_UNPORTED_DEFAULTS = {f.name: f.default for f in fields(EngineConfig) if f.name in UNPORTED}
