"""Attention ops over the paged KV cache (PyTorch forms).

The paged layout is PAGE-MAJOR: per layer, K and V live in page arrays of
shape ``[num_pages, num_kv_heads, page_size, head_dim]``; a sequence's pages
are listed in its row of ``block_tables [B, max_pages_per_seq]``. Page 0 is
the trash page. The pool's head dim is the model's: the TPU package's lane
padding of the pool is a Mosaic layout rule with no counterpart here.

Decode dispatch: a CUDA tensor goes to the hand-written kernels
(ops/cuda/), a CPU tensor to their plain versions. Prefill attention is
plain torch ops, as it is plain XLA in the reference.

A pool is a tensor (values in the model dtype) or an fp8 ``QuantPool``
(ops/quant.py): every reader here gathers through ``gather_ctx``, which
dequantizes the latter to f32.
"""

from __future__ import annotations

import math
import os

import torch

from dynamo_tpu_torch.ops.quant import gather_dequant_pages, is_quant

NEG_INF = -1e30


def use_fused_decode() -> bool:
    """Fused KV-append + attention kernel (ops/cuda/fused_decode.py) on the
    decode path unless DYNAMO_FUSED_DECODE turns it off (0/false/off/no)."""
    env = (os.environ.get("DYNAMO_FUSED_DECODE") or "").strip().lower()
    return env not in ("0", "false", "off", "no")


def page_tiles(arr: torch.Tensor, page_size: int) -> torch.Tensor:
    """Prefill KV rows -> page-major write tiles:
    [..., T, KH, D] -> [n_tiles, KH, page_size, D] (leading dims fold into
    the tile count)."""
    kh, hd = arr.shape[-2], arr.shape[-1]
    return arr.reshape(-1, page_size, kh, hd).transpose(1, 2)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[.., S, kv_heads, D] -> [.., S, kv_heads*n_rep, D] (GQA expansion)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Materialize KV as [..., max_ctx, kv_heads, head_dim] from one layer's
    pages [num_pages, KH, page, D] and block tables [..., P]."""
    toks = pages[block_table]  # [..., P, KH, page, D]
    *lead, P, KH, page, D = toks.shape
    return toks.transpose(-3, -2).reshape(*lead, P * page, KH, D)


def pool_layer(pool, li: int):
    """One layer of a pool of either form."""
    return pool.layer(li) if is_quant(pool) else pool[li]


def gather_ctx(pool_l, block_table: torch.Tensor) -> torch.Tensor:
    """One layer's context [..., max_ctx, KH, D] for either pool form: a
    tensor gathers in its dtype, a QuantPool layer gathers and dequantizes
    to f32."""
    if is_quant(pool_l):
        return gather_dequant_pages(pool_l, block_table)
    return gather_pages(pool_l, block_table)


def causal_attention(
    q: torch.Tensor,  # [T, heads, D]
    k: torch.Tensor,  # [S, kv_heads, D]
    v: torch.Tensor,  # [S, kv_heads, D]
    q_positions: torch.Tensor,  # [T] absolute positions of the queries
    kv_len: int,  # number of valid kv tokens
    *,
    window: int = 0,  # sliding window (0 = full); key j needs j > pos - window
    sinks: torch.Tensor | None = None,  # [H] learned sink logits
) -> torch.Tensor:
    """Causal attention of new queries over (cached + new) keys.

    Key j is visible to query i iff j <= q_positions[i] and j < kv_len
    (and, with a sliding window, j > q_positions[i] - window). ``sinks``
    adds a per-head logit to the softmax normalization only. Returns
    [T, heads, D]. Softmax in f32 regardless of input dtype.
    """
    T, H, D = q.shape
    S, KH, _ = k.shape
    k = repeat_kv(k, H // KH)
    v = repeat_kv(v, H // KH)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("thd,shd->hts", q.float(), k.float()) * scale
    kv_pos = torch.arange(S, device=q.device)[None, :]
    mask = (kv_pos <= q_positions[:, None]) & (kv_pos < kv_len)
    if window:
        mask &= kv_pos > q_positions[:, None] - window
    logits = torch.where(mask[None], logits, NEG_INF)
    probs = _softmax_with_sinks(logits, sinks, H)
    out = torch.einsum("hts,shd->thd", probs, v.float())
    return out.to(q.dtype)


def batched_causal_attention(
    q: torch.Tensor,  # [N, T, heads, D]
    k: torch.Tensor,  # [N, S, kv_heads, D]
    v: torch.Tensor,  # [N, S, kv_heads, D]
    q_positions: torch.Tensor,  # [N, T]
    kv_len: torch.Tensor,  # [N] valid kv tokens per row (a device tensor)
    *,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
) -> torch.Tensor:
    """``causal_attention`` over N rows at once, each with its own context
    and length (the reference vmaps it). Query heads are grouped over their
    KV head instead of repeating K/V, and every length is a device tensor,
    so a CUDA graph can capture it. Returns [N, T, heads, D]."""
    N, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(N, T, KH, G, D)
    logits = torch.einsum("ntkgd,nskd->nkgts", qg, k.float()) * scale
    kv_pos = torch.arange(S, device=q.device)[None, None, :]
    pos = q_positions[:, :, None]
    mask = (kv_pos <= pos) & (kv_pos < kv_len.reshape(N, 1, 1))
    if window:
        mask &= kv_pos > pos - window
    logits = torch.where(mask[:, None], logits.reshape(N, H, T, S), NEG_INF)
    probs = _softmax_with_sinks(logits, sinks, H).reshape(N, KH, G, T, S)
    out = torch.einsum("nkgts,nskd->ntkgd", probs, v.float())
    return out.reshape(N, T, H, D).to(q.dtype)


def _softmax_with_sinks(
    logits: torch.Tensor, sinks: torch.Tensor | None, H: int
) -> torch.Tensor:
    """Softmax over the last dim; a sink is one more column (a virtual key
    with value 0) that is dropped after normalization. ``logits`` has the
    head dim at -3."""
    if sinks is None:
        return torch.softmax(logits, dim=-1)
    shape = [1] * logits.dim()
    shape[-3] = H
    sink_col = sinks.float().reshape(shape).expand(*logits.shape[:-1], 1)
    probs = torch.softmax(torch.cat([logits, sink_col], dim=-1), dim=-1)
    return probs[..., :-1]


def paged_decode_attention(
    q: torch.Tensor,  # [B, heads, D] (one new token per sequence)
    k_pages,  # one layer [num_pages, kv_heads, page_size, D], or a QuantPool's
    v_pages,
    block_tables: torch.Tensor,  # [B, max_pages_per_seq]
    seq_lens: torch.Tensor,  # [B] context length INCLUDING the new token
    *,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
    scale: float | None = None,  # softmax scale (default 1/sqrt(D))
    new_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Decode-step attention: each query attends to its full paged context
    (gather, then masked attention). ``new_kv=(k_new, v_new)`` [B, KH, D]
    overlays the new token's rows at position ``seq_lens - 1`` after the
    gather, which is the fused kernel's analytic new-token merge (exact
    rows over an fp8 pool's dequantized read-back). Masked V rows are
    zeroed where non-finite, so junk in a masked slot can never turn
    0-probability x V into NaN."""
    B, H, D = q.shape
    k = gather_ctx(k_pages, block_tables)  # [B, max_ctx, KH, D]
    v = gather_ctx(v_pages, block_tables)
    max_ctx = k.shape[1]
    if new_kv is not None:
        rows = torch.arange(B, device=q.device)
        pos = (seq_lens.long() - 1).clamp(0, max_ctx - 1)
        k = k.clone()
        v = v.clone()
        k[rows, pos] = new_kv[0].to(k.dtype)
        v[rows, pos] = new_kv[1].to(v.dtype)
    KH = k.shape[2]
    k = repeat_kv(k, H // KH).float()
    v = repeat_kv(v, H // KH).float()
    v = torch.where(torch.isfinite(v), v, 0.0)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    kv_pos = torch.arange(max_ctx, device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    mask = kv_pos < lens
    if window:
        mask &= kv_pos >= lens - window
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    probs = _softmax_with_sinks(logits[:, :, None, :], sinks, H)[:, :, 0]
    out = torch.einsum("bhs,bshd->bhd", probs, v)
    return out.to(q.dtype)


def decode_update_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [L, num_pages, KH, page, D] (updated in place)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, KH, D] new-token KV rows (post-rope)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    seq_lens: torch.Tensor,  # [B] int32, length INCLUDING the new token
    dst_page: torch.Tensor,  # [B] int32 pool page for the new row (0 = trash)
    dst_off: torch.Tensor,  # [B] int32
    *,
    layer: int,
    window: int = 0,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """The per-layer decode step: KV append + paged attention. One fused
    kernel (ops/cuda/fused_decode.py) by default; with DYNAMO_FUSED_DECODE=0
    the unfused pair, kv_write then paged_attention_v3. The pools are
    updated IN PLACE (the counterpart of the reference's input/output
    aliasing plus donation). Returns the attention output [B, H, D].
    fp8 QuantPools take the same routes, in the kernels' fp8 forms: on the
    unfused path kv_write's fp8 form is the quantized append (the
    reference's quant_append_rows, in one launch), and paged_attention_v3
    then reads the new row back at fp8, as the reference's Pallas v3
    route does."""
    D = q.shape[-1]
    if use_fused_decode():
        from dynamo_tpu_torch.ops.cuda.fused_decode import fused_decode_attention

        return fused_decode_attention(
            q, k_pages, v_pages, k_new, v_new, block_tables, seq_lens,
            dst_page, dst_off, layer=layer, window=window, sinks=sinks,
            scale=1.0 / math.sqrt(D),
        )
    from dynamo_tpu_torch.ops.cuda.kv_write import kv_write

    kv_write(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer=layer)
    return paged_decode_attention_auto(
        q, pool_layer(k_pages, layer), pool_layer(v_pages, layer),
        block_tables, seq_lens, window=window, sinks=sinks,
    )


def paged_decode_attention_auto(
    q: torch.Tensor,
    k_pages,  # one layer: [num_pages, KH, page, D], or a QuantPool's
    v_pages,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    window: int = 0,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Read-only decode attention: the paged_attention_v3 kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    from dynamo_tpu_torch.ops.cuda.paged_attention_v3 import (
        paged_decode_attention_v3,
    )

    return paged_decode_attention_v3(
        q, k_pages, v_pages, block_tables, seq_lens,
        window=window, sinks=sinks,
    )
