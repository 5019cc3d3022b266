"""Multi-head Latent Attention (MLA): the DeepSeek-V2/V3/R1 family in
PyTorch (counterpart of dynamo_tpu/models/mla.py).

The KV cache holds ONE latent row per token, shared by every head: the
``kv_lora_rank`` (d_c) normalized latent followed by the
``qk_rope_head_dim`` (d_r) roped key, ``[L, num_pages, page, d_c + d_r]``,
page 0 the trash page. For deepseek-r1 that is 576 values per token and
layer where GQA at the same head count would hold 2 x 128 x 128.

Attention runs in the absorbed form: ``q_nope`` folds through ``w_uk`` so
the scores are taken against the cached latents directly, and the output
latent re-expands through ``w_uv`` afterwards, all in f32 as the
reference's XLA einsums. The reference computes MLA in XLA, not Pallas,
so no hand-written kernel is on this path; the context gathers by block
table with plain indexing. ``reference_forward`` is the non-absorbed
ground truth (per-head K and V materialized).

With ``kv_dtype="fp8"`` the cache is a ``QuantPool`` (ops/quant.py) with
one bf16 scale per (layer, page, ROW): an append is a plain store of the
row and its scale, so a verify's siblings on one page never requantize
each other. Prefill, packed prefill and verify attend to their own new
rows exactly (overlaid on the dequantized read-back), and decode to its
new row, as the reference's.

The FFN is DeepSeek's: the first ``first_k_dense`` layers a dense MLP, the
rest routed experts (models/moe.py, sigmoid scoring with group-limited
top-k) plus ``n_shared_experts`` always-on experts. As in the reference,
MLA forwards do not count the MoE's dropped slots: the family reports 0.

Entry points mirror models/llama.py's: ``prefill_forward``,
``prefill_forward_batch``, ``verify_forward``, ``decode_forward``,
``decode_step_`` (over ``llama.StepTensors``, which the engine's CUDA
graphs capture), ``decode_steps`` and ``reference_forward``. The cache
updates in place; nothing in ``decode_step_`` or ``verify_forward`` reads
a device value on the host.
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.models import moe
from dynamo_tpu_torch.models.llama import (
    TRASH_PAGE,
    LlamaLayer,
    LlamaParams,
    StepTensors,
    _embed,
    _logits,
    _overlay_rows,
    apply_rope,
    finish_step_,
    param_mesh,
    pool_embedding,
    resolve_device,
    rms_norm,
    rope_tables,
    run_steps,
    torch_dtype,
    yarn_get_mscale,
)
from dynamo_tpu_torch.ops.quant import (
    QuantPool,
    gather_dequant_rows,
    init_quant_pool,
    is_quant,
    quant_append_rows,
    quant_page_tiles,
)

NEG_INF = -1e30


def latent_dim(spec: ModelSpec) -> int:
    return spec.kv_lora_rank + spec.qk_rope_head_dim


def softmax_scale(spec: ModelSpec) -> float:
    """1/sqrt(dn + dr), times the YaRN mscale^2 correction when the spec
    has ``rope_mscale_all_dim`` (HF DeepseekV3Attention)."""
    base = 1.0 / math.sqrt(spec.qk_nope_head_dim + spec.qk_rope_head_dim)
    if spec.rope_scaling_factor and spec.rope_mscale_all_dim:
        m = yarn_get_mscale(spec.rope_scaling_factor, spec.rope_mscale_all_dim)
        base *= m * m
    return base


# ---------------------------------------------------------------- weights


class MlaLayer(LlamaLayer):
    """One DeepSeek layer's weights (the JAX tree's names, [in, out]):
    attn_norm, mlp_norm, w_kv_a [d, dc + dr], kv_norm [dc], w_uk [H, dc,
    dn], w_uv [H, dc, dv], wo [H * dv, d], the query's wq_a / q_norm /
    wq_b (q-LoRA) or wq; then w_gate / w_up / w_down (dense layers) or
    ``moe`` (models/moe.py) and ``shared`` (the shared experts' MLP)."""


class MlaParams(LlamaParams):
    layer_cls = MlaLayer


def init_params(
    spec: ModelSpec, seed: int = 0, device: str | torch.device | None = None,
    mesh=None,
) -> MlaParams:
    """Random init from a seeded generator on the device, in the JAX
    init's scheme: normal draws in f32 times 1/sqrt(fan in) (``shape[-2]``;
    1/sqrt(dc) for w_uk and w_uv, 0.02 for the embedding and the router),
    cast to the model dtype; norms are ones. The draws differ from
    jax.random's; parity tests bridge the JAX weights with
    models/convert.params_from_numpy instead. With a ``mesh`` every rank
    draws the same full tensors, one layer at a time, and keeps its shard
    (models/convert.shard_params' layout: heads, dense and shared FFN
    columns over tp, routed experts over ep x tp, the latent path
    replicated)."""
    assert spec.is_mla, "not an MLA spec"
    dev = resolve_device(device)
    dtype = torch_dtype(spec.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, H = spec.hidden_size, spec.num_heads
    dn, dr, dv = spec.qk_nope_head_dim, spec.qk_rope_head_dim, spec.v_head_dim
    dc = spec.kv_lora_rank

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(scale).to(dtype)  # in place: an expert stack is 15 GB of f32

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def mlp(f):
        return {"w_gate": dense((d, f)), "w_up": dense((d, f)), "w_down": dense((f, d))}

    if mesh is not None:
        from dynamo_tpu_torch.models.convert import check_shardable, shard_tensor

        check_shardable(spec, mesh)

    def cut(name, t):
        return t if mesh is None else shard_tensor(name, t, mesh)

    embed = cut("embed", dense((spec.vocab_size, d), scale=0.02))
    lm_head = None if spec.tie_embeddings else cut("lm_head", dense((d, spec.vocab_size)))
    layers = []
    for li in range(spec.num_layers):
        lp = {
            "attn_norm": ones(d),
            "mlp_norm": ones(d),
            "w_kv_a": dense((d, dc + dr)),
            "kv_norm": ones(dc),
            "w_uk": dense((H, dc, dn), scale=1.0 / math.sqrt(dc)),
            "w_uv": dense((H, dc, dv), scale=1.0 / math.sqrt(dc)),
            "wo": dense((H * dv, d)),
        }
        if spec.q_lora_rank:
            lp.update(wq_a=dense((d, spec.q_lora_rank)), q_norm=ones(spec.q_lora_rank),
                      wq_b=dense((spec.q_lora_rank, H * (dn + dr))))
        else:
            lp["wq"] = dense((d, H * (dn + dr)))
        if spec.num_experts and li >= spec.first_k_dense:
            lp["moe"] = moe.init_moe_layer(spec, dense, dtype, dev, mesh)
            if spec.n_shared_experts:
                lp["shared"] = mlp(spec.moe_intermediate_size * spec.n_shared_experts)
        else:
            lp.update(mlp(spec.intermediate_size))
        # the experts come cut (init_moe_layer)
        layers.append({name: t if name == "moe" else cut(name, t)
                       for name, t in lp.items()})
    return MlaParams(embed, ones(d), layers, lm_head, mesh=mesh)


def init_cache(
    spec: ModelSpec, num_pages: int, page_size: int, dtype=None,
    device: str | torch.device | None = None, kv_dtype: str = "bf16",
) -> torch.Tensor | QuantPool:
    """The latent cache [L, num_pages, page_size, dc + dr], zeroed; page 0
    is the trash page. ``kv_dtype="fp8"`` allocates a QuantPool with one
    bf16 scale per (layer, page, row)."""
    dev = resolve_device(device)
    shape = (spec.num_layers, num_pages, page_size, latent_dim(spec))
    if kv_dtype == "fp8":
        return init_quant_pool(shape, 3, dev)
    return torch.zeros(shape, dtype=dtype or torch_dtype(spec.dtype), device=dev)


# ---------------------------------------------------------------- pieces


def _set_latent_tiles(cache, li: int, safe_pg: torch.Tensor, tiles: torch.Tensor,
                      valid_tok: torch.Tensor) -> None:
    """Prefill page write of ``tiles [n, page, D]`` (``valid_tok [n, page]``
    the real rows) to pages ``safe_pg [n]``; an fp8 cache zeroes the padded
    rows first and takes one scale per row."""
    if is_quant(cache):
        vals, s = quant_page_tiles(tiles, valid_tok[:, :, None], (2,))
        cache.vals.view(torch.uint8)[li, safe_pg] = vals.view(torch.uint8)
        cache.scale[li, safe_pg] = s
        return
    cache[li, safe_pg] = tiles.to(cache.dtype)


def _append_rows(cache, li: int, rows: torch.Tensor, pages: torch.Tensor,
                 offs: torch.Tensor) -> None:
    """Token-granular write of ``rows [N, D]`` at (page, offset): a plain
    store, or the per-row fp8 store."""
    if is_quant(cache):
        quant_append_rows(cache, rows, pages, offs, li)
        return
    cache[li, pages.long(), offs.long()] = rows.to(cache.dtype)


def _gather_rows_any(cache, li: int, block_tables: torch.Tensor) -> torch.Tensor:
    """[..., P] block tables -> the context rows [..., P * page, D]
    (dequantized to f32 from an fp8 cache)."""
    if is_quant(cache):
        return gather_dequant_rows(cache.layer(li), block_tables)
    rows = cache[li][block_tables.long()]  # [..., P, page, D]
    return rows.reshape(*rows.shape[:-3], -1, rows.shape[-1])


def _rot(spec: ModelSpec, positions: torch.Tensor):
    """The forward's rope tables at the rope dim (cached YaRN frequencies:
    nothing is copied to the device inside a capture)."""
    return rope_tables(spec, positions, spec.qk_rope_head_dim)


def _q_heads(spec: ModelSpec, lp: MlaLayer, h: torch.Tensor, rot):
    """h [..., T, d] -> (q_nope [..., T, H, dn], q_rope [..., T, H, dr])
    with rope applied; H from the weights (a tp rank's H / tp heads)."""
    dn, dr = spec.qk_nope_head_dim, spec.qk_rope_head_dim
    if spec.q_lora_rank:
        q = rms_norm(h @ lp.wq_a, lp.q_norm, spec.rms_eps) @ lp.wq_b
    else:
        q = h @ lp.wq
    q = q.reshape(*h.shape[:-1], -1, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], *rot)


def _latent_row(spec: ModelSpec, lp: MlaLayer, h: torch.Tensor, rot) -> torch.Tensor:
    """h [..., T, d] -> cache rows [..., T, dc + dr]: the normalized latent
    and the roped shared key."""
    dc = spec.kv_lora_rank
    kv_a = h @ lp.w_kv_a
    c = rms_norm(kv_a[..., :dc], lp.kv_norm, spec.rms_eps)
    k_r = apply_rope(kv_a[..., None, dc:], *rot)[..., 0, :]
    return torch.cat([c, k_r], dim=-1)


def _absorbed_attention(
    spec: ModelSpec,
    lp: MlaLayer,
    q_nope: torch.Tensor,  # [..., T, H, dn]
    q_rope: torch.Tensor,  # [..., T, H, dr]
    rows: torch.Tensor,  # [..., S, dc + dr] cached latents
    mask: torch.Tensor,  # [..., T, S] bool
) -> torch.Tensor:
    """Latent-space attention -> per-head outputs [..., T, H, dv], in f32."""
    dc = spec.kv_lora_rank
    rows = rows.float()
    c, k_r = rows[..., :dc], rows[..., dc:]
    q_lat = torch.einsum("...thn,hcn->...thc", q_nope.float(), lp.w_uk.float())
    scores = (torch.einsum("...thc,...sc->...ths", q_lat, c)
              + torch.einsum("...thr,...sr->...ths", q_rope.float(), k_r))
    scores = scores * softmax_scale(spec)
    scores = torch.where(mask[..., :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("...ths,...sc->...thc", probs, c)
    return torch.einsum("...thc,hcv->...thv", o_lat, lp.w_uv.float())


def _mlp(w, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A gated MLP; a tp rank holds FFN columns of w_gate / w_up and the
    rows of w_down, and all-reduces its partial."""
    out = (torch.nn.functional.silu(x @ w.w_gate) * (x @ w.w_up)) @ w.w_down
    return out if mesh is None else mesh.all_reduce(out)


def _ffn(spec: ModelSpec, lp: MlaLayer, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x [T, d]: routed experts plus the shared experts, or the dense MLP
    of the first ``first_k_dense`` layers; under a mesh the routed experts
    combine over the expert group, the others over tp. Drops are not
    counted (the reference's MLA does not count them)."""
    if lp.get("moe") is None:
        return _mlp(lp, x, mesh)
    out = moe.moe_mlp(spec, lp.moe, x, mesh=mesh)
    if lp.get("shared") is not None:
        out = out + _mlp(lp.shared, x, mesh)
    return out


def _layer_tail(spec: ModelSpec, lp: MlaLayer, x: torch.Tensor,
                attn: torch.Tensor, mesh=None) -> torch.Tensor:
    """x [..., T, d] + the output projection of ``attn [..., T, H, dv]`` (a
    tp rank's heads: its rows of wo, the partial all-reduced), then the
    FFN's residual."""
    o = attn.reshape(*attn.shape[:-2], -1).to(x.dtype) @ lp.wo
    x = x + (o if mesh is None else mesh.all_reduce(o))
    h = rms_norm(x, lp.mlp_norm, spec.rms_eps)
    return x + _ffn(spec, lp, h.reshape(-1, h.shape[-1]), mesh).reshape(x.shape)


def _dropped(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


# -------------------------------------------------------------- reference


def reference_forward(
    spec: ModelSpec, params: MlaParams, tokens: torch.Tensor
) -> torch.Tensor:
    """Plain NON-absorbed forward (per-head K/V materialized, no paging),
    the numerical ground truth. tokens: [T] -> logits [T, V] f32."""
    T = tokens.shape[0]
    positions = torch.arange(T, device=tokens.device)
    rot = _rot(spec, positions)
    mesh = param_mesh(params)
    x = _embed(params, tokens.long(), mesh)
    dc = spec.kv_lora_rank
    mask = positions[:, None] >= positions[None, :]
    for lp in params.layers:
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q_nope, q_rope = _q_heads(spec, lp, h, rot)
        rows = _latent_row(spec, lp, h, rot).float()
        c, k_r = rows[:, :dc], rows[:, dc:]
        k_nope = torch.einsum("sc,hcn->shn", c, lp.w_uk.float())
        v = torch.einsum("sc,hcv->shv", c, lp.w_uv.float())
        scores = (torch.einsum("thn,shn->ths", q_nope.float(), k_nope)
                  + torch.einsum("thr,sr->ths", q_rope.float(), k_r))
        scores = scores * softmax_scale(spec)
        scores = torch.where(mask[:, None, :], scores, NEG_INF)
        attn = torch.einsum("ths,shv->thv", torch.softmax(scores, dim=-1), v)
        x = _layer_tail(spec, lp, x, attn, mesh)
    return _logits(spec, params, x)


# ------------------------------------------------------------- embeddings


def embed_forward(
    spec: ModelSpec, params: MlaParams, tokens: torch.Tensor, num_tokens: int
) -> torch.Tensor:
    """Sequence embedding for the MLA family: the final-norm hidden states
    mean-pooled over the real tokens, L2-normalized, in f32 (as
    ``llama.embed_forward``). The absorbed attention runs over the prompt's
    own latent rows; no page is touched. tokens: [T_pad] -> [hidden] f32."""
    T = tokens.shape[0]
    positions = torch.arange(T, device=tokens.device)
    rot = _rot(spec, positions)
    mask = (positions[:, None] >= positions[None, :]) & (positions[None, :] < num_tokens)
    mesh = param_mesh(params)
    x = _embed(params, tokens.long(), mesh)
    for lp in params.layers:
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q_nope, q_rope = _q_heads(spec, lp, h, rot)
        attn = _absorbed_attention(spec, lp, q_nope, q_rope, _latent_row(spec, lp, h, rot),
                                   mask)
        x = _layer_tail(spec, lp, x, attn, mesh)
    return pool_embedding(rms_norm(x, params.final_norm, spec.rms_eps), num_tokens)


# ---------------------------------------------------------------- prefill


def prefill_forward(
    spec: ModelSpec,
    params: MlaParams,
    tokens: torch.Tensor,  # [T_pad] int (padded)
    block_table: torch.Tensor,  # [max_pages_per_seq] int32
    start_pos: int,  # cached-prefix length (tokens, page-aligned)
    cache,  # [L, num_pages, page, D] (updated in place)
    num_tokens: int,  # real token count in ``tokens``
) -> tuple[torch.Tensor, torch.Tensor]:
    """One prompt; writes its latent pages; returns (the last real
    position's logits [V] f32, 0 dropped slots as an int32 device
    scalar)."""
    logits, dropped = prefill_forward_batch(
        spec, params, tokens[None], block_table[None], torch.tensor([start_pos]),
        cache, torch.tensor([num_tokens]))
    return logits[0], dropped


def prefill_forward_batch(
    spec: ModelSpec,
    params: MlaParams,
    tokens: torch.Tensor,  # [N, T_pad] int (padded)
    block_tables: torch.Tensor,  # [N, max_pages_per_seq] int32
    start_pos: torch.Tensor,  # [N]: cached-prefix lengths (page-aligned)
    cache,  # updated in place
    num_tokens: torch.Tensor,  # [N] real token counts (0 = padded row)
) -> tuple[torch.Tensor, torch.Tensor]:
    """N prompts in one forward (the packed-prefill admission path): the
    matmuls batch over [N, T, d], the latent write is one page-tile write
    over all N*T/page tiles, and the absorbed attention runs per prompt
    over its own table. Over an fp8 cache each prompt attends to its own
    rows exactly. The experts route the N*T rows flattened, padding
    included, as the reference's. Returns (the last real position's
    logits [N, V] f32, 0 dropped slots as an int32 device scalar)."""
    dev = cache.device
    N, T = tokens.shape
    page_size = cache.shape[2]
    start = start_pos.to(dev).long()
    ntok = num_tokens.to(dev).long()
    tokens = tokens.to(dev)
    block_tables = block_tables.to(dev)
    idx = torch.arange(T, device=dev)
    positions = start[:, None] + idx[None, :]  # [N, T]
    n_pg = T // page_size
    page_starts = start[:, None] + (torch.arange(n_pg, device=dev) * page_size)[None, :]
    # a bucket padded past the table's end reads its last column: those
    # pages are past the prompt, so they write the trash page
    pg_col = (page_starts // page_size).clamp(max=block_tables.shape[1] - 1)
    pg_idx_raw = torch.gather(block_tables.long(), 1, pg_col)
    valid_pg = page_starts < (start + ntok)[:, None]
    safe_pg = torch.where(valid_pg, pg_idx_raw, TRASH_PAGE).reshape(N * n_pg)
    valid_tok = (idx[None, :] < ntok[:, None]).reshape(N * n_pg, page_size)
    kv_len = start + ntok
    ctx_pos = torch.arange(block_tables.shape[1] * page_size, device=dev)
    # [N, T, max_ctx]: causal within the prompt, nothing past its end
    mask = ((ctx_pos[None, None, :] <= positions[:, :, None])
            & (ctx_pos[None, None, :] < kv_len[:, None, None]))

    mesh = param_mesh(params)
    x = _embed(params, tokens.long(), mesh)  # [N, T, d]
    rot = _rot(spec, positions)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q_nope, q_rope = _q_heads(spec, lp, h, rot)
        new_rows = _latent_row(spec, lp, h, rot)  # [N, T, D]
        _set_latent_tiles(cache, li, safe_pg,
                          new_rows.reshape(N * n_pg, page_size, -1), valid_tok)
        rows = _gather_rows_any(cache, li, block_tables)  # [N, max_ctx, D]
        if is_quant(cache):
            rows = _overlay_rows(rows, new_rows, positions)
        # one prompt at a time: [T, H, max_ctx] f32 scores each
        attn = torch.stack([
            _absorbed_attention(spec, lp, q_nope[i], q_rope[i], rows[i], mask[i])
            for i in range(N)
        ])
        x = _layer_tail(spec, lp, x, attn, mesh)

    last = (ntok - 1).clamp(0, T - 1)
    x_last = x[torch.arange(N, device=dev), last]
    return _logits(spec, params, x_last), _dropped(dev)


# ----------------------------------------------------------------- verify


def verify_forward(
    spec: ModelSpec,
    params: MlaParams,
    tokens: torch.Tensor,  # [N, W] int32: [fed token, drafts...] per row
    block_tables: torch.Tensor,  # [N, max_pages_per_seq] int32
    start_pos: torch.Tensor,  # [N] int32: cache length before the fed token
    cache,  # updated in place
    num_tokens: torch.Tensor,  # [N] int32 valid tokens per row (0 = padded row)
    allowed: torch.Tensor | None = None,  # [N, W, V] bool: guided masks
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-verify forward: N slots' fed token + drafts, the
    target's greedy choice at every position (argmax under ``allowed``
    when given). Latent writes are token-granular (a verify starts
    mid-page); with per-row scales siblings on one page are independent
    stores. Returns (targets [N, W] int32, 0 dropped slots), both on the
    device; reads no device value on the host (engine/graphs.VerifyGraphs
    captures it)."""
    from dynamo_tpu_torch.engine.sampling import greedy_tokens, mask_logits

    logits = verify_logits(spec, params, tokens, block_tables, start_pos, cache,
                           num_tokens)
    if allowed is not None:
        logits = mask_logits(logits, allowed)
    return greedy_tokens(logits), _dropped(cache.device)


def verify_logits(spec, params, tokens, block_tables, start_pos, cache,
                  num_tokens) -> torch.Tensor:
    """The verify forward's logits [N, W, V] f32 at every position
    (arguments as ``verify_forward``'s); writes the rows' latents in
    place. Padded and invalid positions write trash page 0; rejected
    drafts' rows stay past the slot's post-verify length, masked, and are
    overwritten by the next write there."""
    dev = cache.device
    N, W = tokens.shape
    P = block_tables.shape[1]
    page_size = cache.shape[2]
    start = start_pos.long()
    ntok = num_tokens.long()
    idx = torch.arange(W, device=dev)
    positions = start[:, None] + idx[None, :]  # [N, W]
    valid = idx[None, :] < ntok[:, None]
    # positions past the table (padding, rows near the context cap) would
    # gather out of range: clamp first, the result is masked anyway
    pg_col = (positions // page_size).clamp(max=P - 1)
    pg_raw = torch.gather(block_tables.long(), 1, pg_col)
    safe_pg = torch.where(valid, pg_raw, TRASH_PAGE).reshape(N * W)
    offs = (positions % page_size).reshape(N * W)
    kv_len = start + ntok
    ctx_pos = torch.arange(P * page_size, device=dev)
    mask = ((ctx_pos[None, None, :] <= positions[:, :, None])
            & (ctx_pos[None, None, :] < kv_len[:, None, None]))  # [N, W, S]

    mesh = param_mesh(params)
    x = _embed(params, tokens.long(), mesh)  # [N, W, d]
    rot = _rot(spec, positions)
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)
        q_nope, q_rope = _q_heads(spec, lp, h, rot)
        new_rows = _latent_row(spec, lp, h, rot)  # [N, W, D]
        _append_rows(cache, li, new_rows.reshape(N * W, -1), safe_pg, offs)
        rows = _gather_rows_any(cache, li, block_tables)  # [N, S, D]
        if is_quant(cache):
            # the fed token and the drafts judge each other at full
            # precision over the dequantized context
            rows = _overlay_rows(rows, new_rows, positions)
        attn = _absorbed_attention(spec, lp, q_nope, q_rope, rows, mask)
        x = _layer_tail(spec, lp, x, attn, mesh)
    return _logits(spec, params, x)


# ---------------------------------------------------------------- decode


def decode_forward(
    spec: ModelSpec,
    params: MlaParams,
    tokens: torch.Tensor,  # [B] last sampled token per slot
    block_tables: torch.Tensor,  # [B, max_pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32, length INCLUDING the new token
    cache,  # updated in place
    active: torch.Tensor,  # [B] bool: slot has a live request
) -> torch.Tensor:
    """One decode step for the whole slot batch (absorbed latent
    attention); returns logits [B, V]. Inactive slots write trash page 0.
    Over an fp8 cache each query attends to its own new row exactly."""
    where = decode_where(block_tables, seq_lens, active, cache.shape[2])
    rot = _rot(spec, where[0][:, None])  # one position per slot
    mesh = param_mesh(params)
    x = _embed(params, tokens.long(), mesh)  # [B, d]
    for li, lp in enumerate(params.layers):
        h = rms_norm(x, lp.attn_norm, spec.rms_eps)[:, None]  # [B, 1, d]
        attn = decode_attention(spec, lp, li, h, rot, cache, block_tables, where)
        x = _layer_tail(spec, lp, x[:, None], attn, mesh)[:, 0]
    return _logits(spec, params, x)


def decode_where(block_tables: torch.Tensor, seq_lens: torch.Tensor,
                 active: torch.Tensor, page_size: int):
    """A decode step's indices, made once for all layers: (positions [B],
    the new rows' pages [B] (trash page 0 for inactive slots) and offsets
    [B], the context mask [B, 1, S], each query's own row [B])."""
    B, P = block_tables.shape
    positions = seq_lens.long() - 1  # position of the new token
    page_idx = torch.gather(block_tables.long(), 1,
                            (positions // page_size).clamp(0, P - 1)[:, None])[:, 0]
    safe_page = torch.where(active, page_idx, TRASH_PAGE)
    max_ctx = P * page_size
    mask = (torch.arange(max_ctx, device=seq_lens.device)[None, :]
            < seq_lens[:, None])[:, None]
    return positions, safe_page, positions % page_size, mask, positions.clamp(0, max_ctx - 1)


def decode_attention(spec: ModelSpec, lp: MlaLayer, li: int, h: torch.Tensor, rot,
                     cache, block_tables: torch.Tensor, where) -> torch.Tensor:
    """One layer's attention in a decode step: h [B, 1, d] (normed) ->
    [B, 1, H, dv]. Appends the new latent rows, gathers each slot's
    context by block table and attends in the absorbed form; over an fp8
    cache the query's own row (its strongest target) is exact."""
    _positions, safe_page, offset, mask, own = where
    q_nope, q_rope = _q_heads(spec, lp, h, rot)  # [B, 1, H, *]
    new_rows = _latent_row(spec, lp, h, rot)[:, 0]  # [B, D]
    _append_rows(cache, li, new_rows, safe_page, offset)
    rows = _gather_rows_any(cache, li, block_tables)  # [B, S, D]
    if is_quant(cache):
        b_idx = torch.arange(rows.shape[0], device=rows.device)
        rows = rows.index_put((b_idx, own), new_rows.to(rows.dtype))
    return _absorbed_attention(spec, lp, q_nope, q_rope, rows, mask)


def decode_step_(
    spec: ModelSpec, params: MlaParams, cache, _v_pages, t: StepTensors,
    *, sampled: bool, n_logprobs: int,
) -> None:
    """One decode model step over the fixed tensors ``t``, in place (the
    record layout and advance of ``llama.decode_step_``, through
    ``llama.finish_step_``); the second pool argument is the family's
    inert placeholder. Reads no device value on the host, so a CUDA graph
    captures it (engine/graphs.DecodeGraphs)."""
    logits = decode_forward(spec, params, t.tokens, t.block_tables, t.seq_lens,
                            cache, t.active != 0)
    finish_step_(t, logits, sampled=sampled, n_logprobs=n_logprobs)


def decode_steps(
    spec: ModelSpec,
    params: MlaParams,
    tokens: torch.Tensor,  # [B] last sampled token per slot
    block_tables: torch.Tensor,  # [B, max_pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32, INCLUDING the first new token
    cache,  # updated in place
    active: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,  # [B] host f32
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,  # [B] int (uint32 seed)
    steps: torch.Tensor,  # [B] int: tokens generated so far per slot
    n_steps: int = 1,
    n_logprobs: int = 0,
    allowed: torch.Tensor | None = None,  # [B, V] bool: guided token masks
):
    """``n_steps`` MLA decode iterations + sampling, eagerly, through
    ``decode_step_`` (the JAX package's ``mla.decode_steps``; returns as
    ``llama.decode_steps``)."""
    return run_steps(
        lambda t, sampled: decode_step_(spec, params, cache, None, t,
                                        sampled=sampled, n_logprobs=n_logprobs),
        cache.device, tokens, block_tables, seq_lens, active, temperature,
        top_k, top_p, seeds, steps, n_steps, n_logprobs, allowed)
