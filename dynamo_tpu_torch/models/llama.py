"""Llama-family transformer in PyTorch over the paged KV cache.

The counterpart of dynamo_tpu/models/llama.py for the dense GQA path.
``nn.Module``s hold the weights (``LlamaParams``, names and ``[in, out]``
orientation as in the JAX pytree, so ``x @ w``); plain functions on tensors
mirror the JAX entry points: ``prefill_forward``, ``prefill_forward_batch``,
``decode_forward``, ``decode_steps`` and ``reference_forward``.
``decode_steps`` loops ``decode_step_``, one model step over fixed tensors
(``StepTensors``), which the engine's CUDA graphs capture
(engine/graphs.py).

The KV pools ``[L, num_pages, KH, page, D]`` are updated IN PLACE by every
forward that writes them (the JAX package's donation + aliasing). Page 0 is
the trash page: padded token positions and inactive decode slots write
there, so static-shape batches never corrupt live pages. With
``kv_dtype="fp8"`` each pool is a ``QuantPool`` (ops/quant.py): prefill
quantizes whole pages, decode appends requantize, and every reader
dequantizes.

Devices are explicit: init functions default to ``cuda`` and raise when no
GPU is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.ops.attention import (
    causal_attention,
    decode_update_attention,
    gather_ctx,
    page_tiles,
    pool_layer,
)
from dynamo_tpu_torch.ops.quant import (
    QuantPool,
    init_quant_pool,
    is_quant,
    quant_page_tiles,
)

TRASH_PAGE = 0  # reserved page index for padded-position writes


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the GPU. A CUDA device without a GPU raises: nothing
    falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------- weights


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's weights (JAX names, [in, out] orientation)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _param(t))

    def get(self, name: str) -> torch.Tensor | None:
        return getattr(self, name, None)


class LlamaParams(nn.Module):
    """All weights: embed [V, d], final_norm [d], lm_head [d, V] (absent
    when tied), layers."""

    def __init__(self, embed, final_norm, layers, lm_head=None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.lm_head = _param(lm_head) if lm_head is not None else None
        self.layers = nn.ModuleList(LlamaLayer(lp) for lp in layers)


def init_params(
    spec: ModelSpec, seed: int = 0, device: str | torch.device | None = None
) -> LlamaParams:
    """Random init from a seeded generator on the device (serving weights
    would come from a checkpoint). Same scheme as the JAX init: normal draws
    in f32 times 1/sqrt(fan_in) (0.02 for the embedding), cast to the model
    dtype; norms are ones, biases and sinks zeros. The draws differ from
    jax.random's; parity tests bridge the JAX weights with
    models/convert.params_from_numpy instead."""
    dev = resolve_device(device)
    dtype = torch_dtype(spec.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd = spec.hidden_size, spec.head_dim
    nh, nkv = spec.num_heads, spec.num_kv_heads

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=dtype)

    embed = dense((spec.vocab_size, d), scale=0.02)
    lm_head = None if spec.tie_embeddings else dense((d, spec.vocab_size))
    layers = []
    for _ in range(spec.num_layers):
        lp = {
            "attn_norm": ones(d),
            "wq": dense((d, nh * hd)),
            "wk": dense((d, nkv * hd)),
            "wv": dense((d, nkv * hd)),
            "wo": dense((nh * hd, d)),
            "mlp_norm": ones(d),
        }
        if spec.attn_bias:
            lp.update(bq=zeros(nh * hd), bk=zeros(nkv * hd),
                      bv=zeros(nkv * hd), bo=zeros(d))
        if spec.attn_sinks:
            lp["sinks"] = zeros(nh)
        lp.update(
            w_gate=dense((d, spec.intermediate_size)),
            w_up=dense((d, spec.intermediate_size)),
            w_down=dense((spec.intermediate_size, d)),
        )
        layers.append(lp)
    return LlamaParams(embed, ones(d), layers, lm_head)


def init_cache(
    spec: ModelSpec, num_pages: int, page_size: int, dtype=None,
    device: str | torch.device | None = None, kv_dtype: str = "bf16",
) -> tuple[torch.Tensor, torch.Tensor] | tuple[QuantPool, QuantPool]:
    """K and V page arrays [L, num_pages, kv_heads, page_size, head_dim],
    zeroed. ``num_pages`` must already include the trash page (index 0).
    ``kv_dtype="fp8"`` allocates QuantPools instead: fp8 values of that
    shape and bf16 scales [L, num_pages, kv_heads], zeros (empty pages)."""
    dev = resolve_device(device)
    shape = (spec.num_layers, num_pages, spec.num_kv_heads, page_size,
             spec.head_dim)
    if kv_dtype == "fp8":
        return init_quant_pool(shape, 3, dev), init_quant_pool(shape, 3, dev)
    dtype = dtype or torch_dtype(spec.dtype)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


# ---------------------------------------------------------------- layers


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def yarn_get_mscale(scale: float, m: float = 1.0) -> float:
    """HF yarn_get_mscale (the YaRN attention temperature formula)."""
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_freqs(spec: ModelSpec, dim: int):
    """YaRN-corrected inverse frequencies + cos/sin attention factor.

    Returns ``(inv_freq [dim//2] | None, attention_factor)``; None = no
    scaling configured. Semantics of HF ``_compute_yarn_parameters``."""
    if not spec.rope_scaling_factor:
        return None, 1.0
    base, factor = spec.rope_theta, spec.rope_scaling_factor
    orig = spec.rope_orig_max_pos
    half = dim // 2
    pos_freqs = base ** (np.arange(0, half, dtype=np.float64) * 2 / dim)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (factor * pos_freqs)

    def corr_dim(n_rot: float) -> float:
        return (dim * math.log(orig / (n_rot * 2 * math.pi))) / (
            2 * math.log(base)
        )

    low = corr_dim(spec.rope_beta_fast)
    high = corr_dim(spec.rope_beta_slow)
    if spec.rope_truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip(
        (np.arange(half, dtype=np.float64) - low) / (high - low), 0, 1
    )
    ext_factor = 1.0 - ramp
    inv = inv_inter * (1 - ext_factor) + inv_extra * ext_factor
    if spec.rope_mscale and spec.rope_mscale_all_dim:
        att = yarn_get_mscale(factor, spec.rope_mscale) / yarn_get_mscale(
            factor, spec.rope_mscale_all_dim
        )
    else:
        att = yarn_get_mscale(factor)
    return inv.astype(np.float32), float(att)


def _rope_tables(positions, half, theta, inv_freq, scale, device):
    if inv_freq is None:
        exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
        freqs = 1.0 / (theta ** exps)
    else:
        freqs = torch.as_tensor(inv_freq, dtype=torch.float32, device=device)
    angles = positions[..., None].float() * freqs  # [..., T, half]
    cos = (torch.cos(angles) * scale)[..., None, :]  # [..., T, 1, half]
    sin = (torch.sin(angles) * scale)[..., None, :]
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., T, heads, D] (half-split) by tables [..., T, 1, D/2]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1
    ).to(x.dtype)


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float,
    *, inv_freq=None, scale: float = 1.0,
) -> torch.Tensor:
    """Rotary embedding (half-split). x: [..., T, heads, D], positions:
    [..., T]. ``inv_freq`` overrides the plain theta schedule (YaRN);
    ``scale`` multiplies the rotated output (the YaRN attention factor)."""
    cos, sin = _rope_tables(positions, x.shape[-1] // 2, theta, inv_freq,
                            scale, x.device)
    return apply_rope(x, cos, sin)


def rope_tables(spec: ModelSpec, positions: torch.Tensor):
    """spec-driven (cos, sin) tables for ``positions`` [..., T]: the plain
    theta schedule, or YaRN when configured. Every layer rotates at the same
    positions, so a forward builds them once."""
    inv, att = yarn_freqs(spec, spec.head_dim)
    return _rope_tables(positions, spec.head_dim // 2, spec.rope_theta, inv,
                        att, positions.device)


def rope_spec(spec: ModelSpec, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """spec-driven rope: plain theta schedule, or YaRN when configured."""
    inv, att = yarn_freqs(spec, x.shape[-1])
    return rope(x, positions, spec.rope_theta, inv_freq=inv, scale=att)


def _attn_qkv(spec: ModelSpec, lp: LlamaLayer, x: torch.Tensor, rot):
    """x: [..., T, d] -> q [..., T, nh, hd], k/v [..., T, nkv, hd], rope
    applied to q and k with the forward's tables ``rot = (cos, sin)``."""
    q = x @ lp.wq
    k = x @ lp.wk
    v = x @ lp.wv
    if spec.attn_bias:
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    lead = x.shape[:-1]
    q = q.reshape(*lead, spec.num_heads, spec.head_dim)
    k = k.reshape(*lead, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(*lead, spec.num_kv_heads, spec.head_dim)
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def _o_proj(spec: ModelSpec, lp: LlamaLayer, attn: torch.Tensor) -> torch.Tensor:
    out = attn @ lp.wo
    return out + lp.bo if spec.attn_bias else out


def _mlp(lp: LlamaLayer, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ lp.w_gate) * (x @ lp.w_up)) @ lp.w_down


def _logits(spec: ModelSpec, params: LlamaParams, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, spec.rms_eps)
    head = params.embed.T if spec.tie_embeddings else params.lm_head
    return (x @ head).float()


# ---------------------------------------------------------------- prefill


def _write_prefill_pages(pool, li, safe_pg, arr, page_size, valid_tok):
    """Page-granular prefill write: prompts start page-aligned (prefix hits
    are whole pages), so the rows land as whole [KH, page, D] tiles. Tail
    garbage beyond the real tokens is masked in attention and overwritten
    by decode appends; fully padded tiles go to the trash page. A QuantPool
    zeroes the rows past the real tokens (``valid_tok [n_tiles, page]``)
    BEFORE the page amax, so garbage cannot inflate the scale, then takes
    one scale per (page, head)."""
    tiles = page_tiles(arr, page_size)
    if is_quant(pool):
        vals, s = quant_page_tiles(tiles, valid_tok[:, None, :, None], (2, 3))
        pool.vals.view(torch.uint8)[li, safe_pg] = vals.view(torch.uint8)
        pool.scale[li, safe_pg] = s
        return
    pool[li, safe_pg] = tiles


def _overlay_rows(ctx, rows, positions):
    """ctx [N, max_ctx, KH, D] f32 with this prompt's exact rows [N, T, KH,
    D] written at ``positions [N, T]``; positions past the context are
    dropped (the reference's ``mode="drop"``: they go to a spare row)."""
    N, max_ctx = ctx.shape[:2]
    ext = torch.cat([ctx, ctx.new_zeros((N, 1) + ctx.shape[2:])], dim=1)
    pos = torch.where(positions < max_ctx, positions, max_ctx)
    n_idx = torch.arange(N, device=ctx.device)[:, None].expand_as(pos)
    ext[n_idx, pos] = rows.to(ext.dtype)
    return ext[:, :max_ctx]


def prefill_forward(
    spec: ModelSpec,
    params: LlamaParams,
    tokens: torch.Tensor,  # [T_pad] int (padded)
    block_table: torch.Tensor,  # [max_pages_per_seq] int32
    start_pos: int,  # cached-prefix length (tokens, page-aligned)
    k_pages: torch.Tensor,  # [L, num_pages, kvh, page, D] (updated in place)
    v_pages: torch.Tensor,
    num_tokens: int,  # real token count in ``tokens``
) -> torch.Tensor:
    """Process one prompt; writes its KV pages; returns the last real
    position's logits [V] f32. Attention runs over the gathered paged
    context, so prefix-cache hits skip recompute of cached tokens."""
    logits = prefill_forward_batch(
        spec, params, tokens[None], block_table[None],
        torch.tensor([start_pos]), k_pages, v_pages,
        torch.tensor([num_tokens]),
    )
    return logits[0]


def prefill_forward_batch(
    spec: ModelSpec,
    params: LlamaParams,
    tokens: torch.Tensor,  # [N, T_pad] int (padded)
    block_tables: torch.Tensor,  # [N, max_pages_per_seq] int32
    start_pos: torch.Tensor,  # [N] host ints: cached-prefix lengths
    k_pages: torch.Tensor,  # updated in place
    v_pages: torch.Tensor,
    num_tokens: torch.Tensor,  # [N] host ints: real token counts
) -> torch.Tensor:
    """N prompts in one forward (the packed-prefill admission path):
    matmuls batch over [N, T, d], the per-layer KV write is one page-tile
    write over all N*T/page tiles, and attention runs per prompt over its
    own table. Padded rows (num_tokens 0) write only the trash page.
    Over fp8 pools each prompt attends to its own rows exactly: they are
    overlaid on the dequantized read-back, so only a cached prefix pays
    fp8. Returns the last real position's logits [N, V] f32."""
    dev = k_pages.device
    N, T = tokens.shape
    page_size = k_pages.shape[3]
    kv_len = (start_pos + num_tokens).tolist()  # host values: no device sync
    start = start_pos.to(dev).long()
    ntok = num_tokens.to(dev).long()
    tokens = tokens.to(dev)
    block_tables = block_tables.to(dev)
    idx = torch.arange(T, device=dev)
    positions = start[:, None] + idx[None, :]  # [N, T]
    n_pg = T // page_size
    page_starts = start[:, None] + (torch.arange(n_pg, device=dev) * page_size)[None, :]
    pg_idx_raw = torch.gather(block_tables.long(), 1, page_starts // page_size)
    valid_pg = page_starts < (start + ntok)[:, None]
    safe_pg = torch.where(valid_pg, pg_idx_raw, TRASH_PAGE).reshape(N * n_pg)
    valid_tok = (idx[None, :] < ntok[:, None]).reshape(N * n_pg, page_size)

    x = params.embed[tokens]  # [N, T, d]
    rot = rope_tables(spec, positions)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q, k, v = _attn_qkv(spec, lp, h, rot)
        _write_prefill_pages(k_pages, li, safe_pg, k, page_size, valid_tok)
        _write_prefill_pages(v_pages, li, safe_pg, v, page_size, valid_tok)
        # [N, max_ctx, kvh, D], dequantized to f32 from an fp8 pool
        k_ctx = gather_ctx(pool_layer(k_pages, li), block_tables)
        v_ctx = gather_ctx(pool_layer(v_pages, li), block_tables)
        if is_quant(k_pages):
            k_ctx = _overlay_rows(k_ctx, k, positions)
            v_ctx = _overlay_rows(v_ctx, v, positions)
        attn = torch.stack([
            causal_attention(
                q[i], k_ctx[i], v_ctx[i], positions[i], kv_len[i],
                window=spec.attn_window(li), sinks=lp.get("sinks"),
            )
            for i in range(N)
        ])
        x = x + _o_proj(spec, lp, attn.reshape(N, T, -1))
        h = rms_norm(x, lp.mlp_norm, spec.rms_eps)
        x = x + _mlp(lp, h)

    last = (ntok - 1).clamp(0, T - 1)
    x_last = x[torch.arange(N, device=dev), last]
    return _logits(spec, params, x_last)


# ---------------------------------------------------------------- decode


def decode_forward(
    spec: ModelSpec,
    params: LlamaParams,
    tokens: torch.Tensor,  # [B] last sampled token per slot
    block_tables: torch.Tensor,  # [B, max_pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32, length INCLUDING the new token
    k_pages: torch.Tensor,  # updated in place
    v_pages: torch.Tensor,
    active: torch.Tensor,  # [B] bool: slot has a live request
) -> torch.Tensor:
    """One decode step for the whole slot batch; returns logits [B, V].
    Per layer, one decode_update_attention call: the fused CUDA kernel on
    the GPU (KV append + paged attention in one launch)."""
    B = tokens.shape[0]
    page_size = k_pages.shape[3]
    positions = seq_lens.long() - 1  # position of the new token
    page_idx_raw = torch.gather(
        block_tables, 1, (positions // page_size)[:, None]
    )[:, 0]
    safe_page = torch.where(active, page_idx_raw, TRASH_PAGE).to(torch.int32)
    offset = (positions % page_size).to(torch.int32)

    x = params.embed[tokens.long()]  # [B, d]
    rot = rope_tables(spec, positions)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q, k, v = _attn_qkv(spec, lp, h, rot)
        attn = decode_update_attention(
            q.contiguous(), k_pages, v_pages, k.contiguous(), v.contiguous(),
            block_tables, seq_lens, safe_page, offset, layer=li,
            window=spec.attn_window(li), sinks=lp.get("sinks"),
        )
        x = x + _o_proj(spec, lp, attn.reshape(B, spec.num_heads * spec.head_dim))
        h = rms_norm(x, lp.mlp_norm, spec.rms_eps)
        x = x + _mlp(lp, h)
    return _logits(spec, params, x)


@dataclass
class StepTensors:
    """The fixed tensors one decode model step reads and advances
    (``decode_step_``): the counterpart of the carry of the JAX package's
    ``decode_steps`` loop. A CUDA graph captures the step over one set of
    these and replays it; the eager ``decode_steps`` runs the same step over
    a fresh set, so both compute the same thing.

    ``out`` holds one int32 record row per step after row 0, which the
    caller fills with the burst's fed tokens: ``record_width(B, n_lp)``
    words, the sampled ids [B] and, with logprobs, the sampled logprobs
    [B] (f32 bits), the top ids [B, n_lp] and the top logprobs [B, n_lp]
    (f32 bits). Rows are step-major, so a burst's first ``1 + n`` rows are
    one contiguous block (one copy to the host)."""

    tokens: torch.Tensor  # [B] int32 last token per slot (advanced)
    block_tables: torch.Tensor  # [B, P] int32
    seq_lens: torch.Tensor  # [B] int32 INCLUDING the new token (advanced)
    active: torch.Tensor  # [B] int32, 1 = live slot
    temperature: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int32 (0 = off)
    top_p: torch.Tensor  # [B] f32 (1.0 = off)
    seeds: torch.Tensor  # [B] int32, the uint32 seed's bits
    steps: torch.Tensor  # [B] int32 tokens generated so far (advanced)
    step_idx: torch.Tensor  # [1] int32 step within the burst (advanced)
    out: torch.Tensor  # [1 + n_max, record_width] int32


def record_width(B: int, n_logprobs: int) -> int:
    """int32 words of one step's record (StepTensors.out)."""
    return B * (2 + 2 * n_logprobs) if n_logprobs else B


def decode_step_(
    spec: ModelSpec, params: LlamaParams, k_pages, v_pages, t: StepTensors,
    *, sampled: bool, n_logprobs: int,
) -> None:
    """One decode model step over the fixed tensors ``t``, in place: the
    forward (pools appended in place), sampling (``sampled=False``: the
    greedy argmax, which the host picks for an all-greedy batch), optional
    logprobs, the record row ``1 + step_idx``, then tokens, seq_lens (by
    active), steps and step_idx advance. Reads no device value on the
    host, so a CUDA graph can capture it."""
    from dynamo_tpu_torch.engine.sampling import (
        greedy_tokens,
        sample_tokens,
        token_logprobs,
    )

    active = t.active != 0
    logits = decode_forward(spec, params, t.tokens, t.block_tables, t.seq_lens,
                            k_pages, v_pages, active)
    if sampled:
        nxt = sample_tokens(logits, t.temperature, t.top_k, t.top_p, t.seeds,
                            t.steps)
    else:
        nxt = greedy_tokens(logits)
    nxt = torch.where(active, nxt, t.tokens)
    row = nxt
    if n_logprobs:
        picked, top_i, top_v = token_logprobs(logits, nxt, n_logprobs)
        row = torch.cat([nxt, picked.view(torch.int32), top_i.reshape(-1),
                         top_v.reshape(-1).view(torch.int32)])
    t.out.index_copy_(0, t.step_idx.long() + 1, row[None])
    t.tokens.copy_(nxt)
    t.seq_lens.add_(t.active)
    t.steps.add_(1)
    t.step_idx.add_(1)


def unpack_records(rows: torch.Tensor, B: int, n_logprobs: int):
    """Step records [n, record_width] -> sampled [B, n] int32, or with
    logprobs (sampled, logprobs [B, n] f32, top_ids [B, n, N] int32,
    top_logprobs [B, n, N] f32): the JAX ``decode_steps`` outputs."""
    n = rows.shape[0]
    sampled = rows[:, :B].T
    if not n_logprobs:
        return sampled
    N = n_logprobs
    lp = rows[:, B:2 * B].contiguous().view(torch.float32).T
    ti = rows[:, 2 * B:2 * B + B * N].reshape(n, B, N).transpose(0, 1)
    tv = rows[:, 2 * B + B * N:].contiguous().view(torch.float32)
    return sampled, lp, ti, tv.reshape(n, B, N).transpose(0, 1)


def decode_steps(
    spec: ModelSpec,
    params: LlamaParams,
    tokens: torch.Tensor,  # [B] last sampled token per slot
    block_tables: torch.Tensor,  # [B, max_pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32, INCLUDING the first new token
    k_pages: torch.Tensor,  # updated in place
    v_pages: torch.Tensor,
    active: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,  # [B] host f32
    top_k: torch.Tensor,  # [B] int
    top_p: torch.Tensor,  # [B] f32
    seeds: torch.Tensor,  # [B] int (uint32 seed)
    steps: torch.Tensor,  # [B] int: tokens generated so far per slot
    n_steps: int = 1,
    n_logprobs: int = 0,
):
    """``n_steps`` decode iterations + sampling, eagerly, through
    ``decode_step_``. Returns sampled [B, n_steps] int32 on the pools'
    device; with ``n_logprobs`` > 0, (sampled, sampled_logprobs [B, n],
    top_ids [B, n, N], top_logprobs [B, n, N]) as the JAX package's
    ``decode_steps`` (N = n_logprobs). Callers pre-extend block tables so
    every active slot has page room for n more tokens; a stop inside a
    burst is handled by the caller discarding the tail. Sampling folds in
    the per-slot generated count, so bursts reproduce the per-request
    stream. Whether any row samples is read from ``temperature``, a host
    tensor (no device sync)."""
    dev = k_pages.device
    B = tokens.shape[0]

    def dev_t(x, dtype):
        return x.to(device=dev, dtype=dtype).clone()

    t = StepTensors(
        tokens=dev_t(tokens, torch.int32), block_tables=dev_t(block_tables, torch.int32),
        seq_lens=dev_t(seq_lens, torch.int32), active=dev_t(active, torch.int32),
        temperature=dev_t(temperature, torch.float32), top_k=dev_t(top_k, torch.int32),
        top_p=dev_t(top_p, torch.float32),
        seeds=dev_t(seeds.long() & 0xFFFFFFFF, torch.int64).to(torch.int32),
        steps=dev_t(steps, torch.int32),
        step_idx=torch.zeros(1, dtype=torch.int32, device=dev),
        out=torch.zeros((1 + n_steps, record_width(B, n_logprobs)), dtype=torch.int32,
                        device=dev),
    )
    t.out[0, :B] = t.tokens
    sampled = bool((temperature > 0).any())
    for _ in range(n_steps):
        decode_step_(spec, params, k_pages, v_pages, t, sampled=sampled,
                     n_logprobs=n_logprobs)
    return unpack_records(t.out[1:], B, n_logprobs)


# -------------------------------------------------------------- reference


def reference_forward(
    spec: ModelSpec, params: LlamaParams, tokens: torch.Tensor
) -> torch.Tensor:
    """Plain full-attention forward (no paging), the numerical ground truth
    for tests. tokens: [T] -> logits [T, V] f32."""
    T = tokens.shape[0]
    positions = torch.arange(T, device=tokens.device)
    x = params.embed[tokens.long()]
    rot = rope_tables(spec, positions)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q, k, v = _attn_qkv(spec, lp, h, rot)
        attn = causal_attention(
            q, k, v, positions, T,
            window=spec.attn_window(li), sinks=lp.get("sinks"),
        )
        x = x + _o_proj(spec, lp, attn.reshape(T, -1))
        h = rms_norm(x, lp.mlp_norm, spec.rms_eps)
        x = x + _mlp(lp, h)
    return _logits(spec, params, x)
