"""Fused paged decode attention + KV append: CUDA kernel + plain version.

Replaces the TPU kernel dynamo_tpu/ops/pallas/fused_decode.py:
_fused_decode_kernel (wrapper ``fused_decode_attention``), the per-layer
decode hot path, launched once per layer per decode step. Per sequence:
GQA paged attention of ``q`` over the pool's positions ``< seq_len - 1``;
the new token ``(k_new, v_new)`` merges analytically as one extra key;
sinks apply after it; the new row is written at ``(dst_page, dst_off)`` of
layer ``layer``, in place (page 0 is the trash page of inactive slots).
A sequence with ``seq_len == 1`` has an empty context and its output is
exactly the single-key merge.

Bound on the H100: bytes, as for paged_attention_v3: the live context's K
and V (``2 * ctx * KH * D`` elements per sequence) dominate; the append
adds ``2 * KH * D`` per sequence. The TPU kernel staged the destination
page through VMEM because Mosaic cannot store one row. Here the kernel
(csrc/fused_decode.cu, common.cuh) splits each (sequence, KV head)'s live
pages over ``S`` blocks as paged_attention_v3 does; the last split of each
(sequence, KV head) to take its ticket merges the partials, the new token
and the sinks, and only then stores that head's new row directly. Every
split has read its tiles before it takes its ticket, so no tile read
races the write; sequences never share a tail page. Against the unfused
pair it saves one launch per layer and the re-read of the freshly written
row.

fp8 branch (the TPU kernel's ``quantized=True``): the pools are
``QuantPool``s, e4m3 values with bf16 scales ``[L, num_pages, KH]``; the
new rows stay in the model dtype (q's), unquantized, so the analytic merge
is exact. Tiles dequantize on use, as in paged_attention_v3. The append
becomes a read-modify-write of the head's whole ``page x D`` run of the
destination page and its scale (ops/quant.py ``quant_append_rows``, the
same bits): the scale grows to ``bf16(max(old, amax|row| / 448))`` (from 0
when ``dst_off == 0``), the old rows re-encode by old/new, the new row
quantizes, all clipped to +-448. The TPU kernel staged that page through
VMEM and left the grown scales to an XLA scatter after the call; here the
last split writes both in place, under the same ticket argument, now
covering the whole run and its scale (csrc/common.cuh).
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.ops.attention import paged_decode_attention, pool_layer
from dynamo_tpu_torch.ops.cuda.build import (
    check,
    count_launch,
    counted,
    dtype_code,
    load_library,
    pool_code,
    stream_ptr,
)
from dynamo_tpu_torch.ops.cuda.kv_write import kv_write_plain
from dynamo_tpu_torch.ops.cuda.paged_attention_v3 import (
    check_attention_args,
    pool_parts,
    prescale,
    split_buffers,
)
from dynamo_tpu_torch.ops.quant import is_quant


def fused_decode_plain(
    q, k_pages, v_pages, k_new, v_new, block_tables, seq_lens, dst_page,
    dst_off, *, layer: int, window: int = 0, sinks=None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version: attention over the gathered context with the new
    rows overlaid at ``seq_len - 1`` (the analytic merge), then the
    append (the quantized append for fp8 pools)."""
    if not is_quant(k_pages):
        k_new = k_new.to(k_pages.dtype)
        v_new = v_new.to(v_pages.dtype)
    out = paged_decode_attention(
        prescale(q, scale), pool_layer(k_pages, layer),
        pool_layer(v_pages, layer), block_tables, seq_lens, window=window,
        sinks=sinks, scale=1.0, new_kv=(k_new, v_new),
    )
    kv_write_plain(k_pages, v_pages, k_new, v_new, dst_page, dst_off,
                   layer=layer)
    return out


@counted
def fused_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages,  # [L, num_pages, KH, page, D] or a QuantPool (updated in place)
    v_pages,
    k_new: torch.Tensor,  # [B, KH, D] new-token KV rows (post-rope), q's dtype
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32
    seq_lens: torch.Tensor,  # [B] int32 (length INCLUDING the new token)
    dst_page: torch.Tensor,  # [B] int32 (0 = trash page for inactive slots)
    dst_off: torch.Tensor,  # [B] int32
    *,
    layer: int,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H] learned sink logits
    scale: float | None = None,
) -> torch.Tensor:
    """One fused decode-attention + KV-append step over layer ``layer``.
    Returns the attention output [B, H, D]; the pools are updated in place.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return fused_decode_plain(
            q, k_pages, v_pages, k_new, v_new, block_tables, seq_lens,
            dst_page, dst_off, layer=layer, window=window, sinks=sinks,
            scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode: unsupported device {q.device}")
    if sinks is not None:
        sinks = sinks.float().contiguous()
    if k_pages.ndim != 5 or not 0 <= layer < k_pages.shape[0]:
        raise ValueError(f"fused_decode: pools must be [L, NP, KH, page, D] "
                         f"with layer {layer} < L")
    check_attention_args(q, k_pages, v_pages, block_tables, seq_lens, sinks,
                         "fused_decode")
    B, H, D = q.shape
    L, NP, KH, page, _ = k_pages.shape
    rows = (k_new, v_new, dst_page, dst_off)
    if any(t.device != q.device or not t.is_contiguous() for t in rows):
        raise ValueError("fused_decode: new rows/indices must be contiguous "
                         "on the pools' device")
    if k_new.shape != (B, KH, D) or v_new.shape != (B, KH, D):
        raise ValueError(f"fused_decode: new rows must be [{B}, {KH}, {D}]")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("fused_decode: new rows must have q's dtype")
    if dst_page.shape != (B,) or dst_off.shape != (B,):
        raise ValueError("fused_decode: dst_page/dst_off must be [B]")
    if dst_page.dtype != torch.int32 or dst_off.dtype != torch.int32:
        raise TypeError("fused_decode: dst_page/dst_off must be int32")
    if k_new.data_ptr() % 16 or v_new.data_ptr() % 16:
        raise ValueError("fused_decode: new rows must be 16-byte aligned")
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    P = block_tables.shape[1]
    S, ws, tickets = split_buffers(q, KH, P)
    k_vals, k_scale = pool_parts(k_pages)
    v_vals, v_scale = pool_parts(v_pages)
    rc = load_library().dtt_fused_decode(
        q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        k_new.data_ptr(), v_new.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), dst_page.data_ptr(), dst_off.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), S,
        B, H, KH, D, page, P, NP, layer, window, scale,
        dtype_code(q.dtype), pool_code(k_vals.dtype), stream_ptr(q),
    )
    check(rc, "fused_decode")
    count_launch(fused_decode_attention, fp8=k_scale is not None)
    return out
