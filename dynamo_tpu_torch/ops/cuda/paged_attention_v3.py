"""Read-only paged decode attention: CUDA kernel + its plain version.

Replaces the TPU kernel
dynamo_tpu/ops/pallas/paged_attention_v3.py:_decode_kernel_v3 (wrapper
``paged_decode_attention_v3``): GQA decode attention of ``q [B, H, D]`` over
one layer's page-major pool ``[num_pages, KH, page, D]`` through
``block_tables [B, P]``, positions ``< seq_len`` (the new token is already in
the pool), with an optional sliding window (keys ``>= seq_len - window``),
per-head sink logits (denominator only) and a softmax ``scale`` (default
1/sqrt(D)). Softmax in f32. The query is pre-scaled and rounded to its
dtype, as the TPU wrapper does.

Bound on the H100: bytes. Each live context token costs ``2 * KH * D``
pool elements read (K and V) against ``4 * H * D`` flops, under one flop
per byte at bf16, far below the ~295 the card needs to be compute bound.
The TPU kernel's windowed DMA pipeline, block-diagonal score matmul and
cross-program prefetch are Mosaic machinery with no counterpart here. The
kernel (csrc/paged_attention_v3.cu, common.cuh) splits each (sequence, KV
head)'s live pages over ``S`` blocks (``num_splits``), streams each
split's ``[page, D]`` K/V tiles through a ring of bulk copies kept in
flight, serves all G query heads of the KV head from each tile (f32 online
softmax), and merges the splits' partials in the same launch: the last
split of each (sequence, KV head) to take its ticket does the merge. Each
(sequence, KV head) uses at most one of the ``S`` splits per 8 live pages
(at least one split); the rest leave at once. It reads only pages below
``ceil(seq_len / page)`` (and from the window's first page): pages a
sequence has not reached, and the trash page, are never read. The host
never reads ``seq_lens``, so a launch can be captured in a CUDA graph.
Eager launches share one ticket buffer per (device, stream): two streams
never share one, and stream order finishes one launch before the next
starts, so the tickets are clean. A captured launch has tickets of its own
(``split_buffers``).

fp8 branch (the TPU kernel's ``quantized=True``): the pools are one
layer's ``QuantPool`` slices, e4m3 values ``[num_pages, KH, page, D]``
and bf16 scales ``[num_pages, KH]``. The kernel reads each tile's two
scales itself (``scale[block_tables[b, p], kh]``; the TPU wrapper
pre-gathered them only because Mosaic indexes VMEM statically) and
dequantizes on use. Half the bytes of bf16 per live token; the query and
output stay in the model dtype.
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.ops.attention import paged_decode_attention
from dynamo_tpu_torch.ops.cuda.build import (
    check,
    count_launch,
    counted,
    dtype_code,
    load_library,
    pool_code,
    stream_ptr,
)
from dynamo_tpu_torch.ops.quant import FP8_DTYPE, SCALE_DTYPE, is_quant

PAGE_SIZES = (16,)
HEAD_DIMS = (64, 128)
MAX_SPLITS = 64  # csrc/common.cuh kMaxSplits

_sm_counts: dict[int, int] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def num_splits(B: int, KH: int, P: int, sms: int) -> int:
    """Blocks per (sequence, KV head): ``B * KH * S`` near twice the card's
    ``sms`` SMs (rounded, so B=32 x KH=8 on 132 SMs stays at one split,
    which measured faster than two), at least 1 and at most the ``P``
    pages of a block table row (a split then holds at least one page slot)
    and MAX_SPLITS (the merge's shared-memory room)."""
    bk = max(B * KH, 1)
    want = (2 * sms + bk // 2) // bk
    return max(1, min(want, P, MAX_SPLITS))


def split_buffers(q: torch.Tensor, KH: int, P: int):
    """(S, workspace, tickets) for one launch on ``q``'s device and current
    stream. The workspace ``[B, KH, S, G, D + 2]`` f32 takes each split's
    partial (acc, m, l); the tickets, one int per (sequence, KV head), are
    zero on entry and the kernel leaves them zero. An eager launch takes
    its stream's ticket buffer; a launch captured in a CUDA graph takes
    tickets of its own, zeroed inside the graph and kept by the graph's
    memory pool, so no eager launch and no other graph ever shares them
    (whatever stream the graph is replayed on, and however the eager
    buffer grows meanwhile)."""
    B, H, D = q.shape
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    S = num_splits(B, KH, P, _sm_counts[dev])
    ws = torch.empty((B, KH, S, H // KH, D + 2), dtype=torch.float32,
                     device=q.device)
    if torch.cuda.is_current_stream_capturing():
        return S, ws, torch.zeros(B * KH, dtype=torch.int32, device=q.device)
    key = (dev, stream_ptr(q))
    tk = _tickets.get(key)
    if tk is None or tk.numel() < B * KH:
        tk = torch.zeros(max(B * KH, 2 * (tk.numel() if tk is not None else 0)),
                         dtype=torch.int32, device=q.device)
        _tickets[key] = tk
    return S, ws, tk


def prescale(q: torch.Tensor, scale: float | None) -> torch.Tensor:
    """q * scale rounded to q's dtype (the TPU wrappers' pre-scaling)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).to(q.dtype)


def paged_attention_v3_plain(
    q, k_pages, v_pages, block_tables, seq_lens, *,
    window: int = 0, sinks=None, scale: float | None = None,
) -> torch.Tensor:
    """Plain version: gather the context, masked f32 softmax."""
    return paged_decode_attention(
        prescale(q, scale), k_pages, v_pages, block_tables, seq_lens,
        window=window, sinks=sinks, scale=1.0,
    )


def pool_parts(pool):
    """(values, scales or None) of a pool of either form."""
    return (pool.vals, pool.scale) if is_quant(pool) else (pool, None)


def check_attention_args(q, k_pool, v_pool, block_tables, seq_lens, sinks,
                         name: str) -> None:
    """Validation shared by both attention kernels' wrappers. The pools are
    tensors of q's dtype, or fp8 QuantPools (one layer or all) whose scales
    have the values' leading dims."""
    if is_quant(k_pool) != is_quant(v_pool):
        raise TypeError(f"{name}: K and V pools must be of one form")
    k_layer, k_scale = pool_parts(k_pool)
    v_layer, v_scale = pool_parts(v_pool)
    tensors = [q, k_layer, v_layer, block_tables, seq_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
        if k_layer.dtype != FP8_DTYPE or v_layer.dtype != FP8_DTYPE:
            raise TypeError(f"{name}: QuantPool values must be float8_e4m3fn")
        if k_scale.dtype != SCALE_DTYPE or v_scale.dtype != SCALE_DTYPE:
            raise TypeError(f"{name}: QuantPool scales must be bfloat16")
        if (k_scale.shape != k_layer.shape[:-2]
                or v_scale.shape != v_layer.shape[:-2]):
            raise ValueError(f"{name}: scales must be [..., num_pages, KH]")
    elif not q.dtype == k_layer.dtype == v_layer.dtype:
        raise TypeError(f"{name}: q and plain pools must share a dtype")
    if sinks is not None:
        tensors.append(sinks)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    B, H, D = q.shape
    KH, page, Dk = k_layer.shape[-3:]
    if k_layer.shape != v_layer.shape or Dk != D:
        raise ValueError(f"{name}: pool shape {tuple(k_layer.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if H % KH or not 1 <= H // KH <= 16:
        raise ValueError(f"{name}: {H} query heads over {KH} KV heads "
                         "(needs a group size in 1..16)")
    if page not in PAGE_SIZES or D not in HEAD_DIMS:
        raise ValueError(f"{name}: page {page} / head dim {D} not supported "
                         f"(pages {PAGE_SIZES}, head dims {HEAD_DIMS})")
    dtype_code(q.dtype)
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be [B, P]")
    if seq_lens.shape != (B,):
        raise ValueError(f"{name}: seq_lens must be [B]")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables/seq_lens must be int32")
    if sinks is not None and (sinks.shape != (H,) or sinks.dtype != torch.float32):
        raise ValueError(f"{name}: sinks must be float32 [H]")
    if any(t.data_ptr() % 16 for t in (q, k_layer, v_layer)):
        raise ValueError(f"{name}: q and the pools must be 16-byte aligned")


@counted
def paged_decode_attention_v3(
    q: torch.Tensor,  # [B, H, D]
    k_pages,  # [num_pages, KH, page, D], or a QuantPool layer slice
    v_pages,
    block_tables: torch.Tensor,  # [B, P] int32
    seq_lens: torch.Tensor,  # [B] int32 (length INCLUDING the new token)
    *,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H] learned sink logits
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over one layer of the page-major cache (plain or
    fp8 pools). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return paged_attention_v3_plain(
            q, k_pages, v_pages, block_tables, seq_lens,
            window=window, sinks=sinks, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_v3: unsupported device {q.device}")
    if sinks is not None:
        sinks = sinks.float().contiguous()
    check_attention_args(q, k_pages, v_pages, block_tables, seq_lens, sinks,
                         "paged_attention_v3")
    if k_pages.ndim != 4:
        raise ValueError("paged_attention_v3: pools must be one layer "
                         "[num_pages, KH, page, D]")
    B, H, D = q.shape
    _, KH, page, _ = k_pages.shape
    k_vals, k_scale = pool_parts(k_pages)
    v_vals, v_scale = pool_parts(v_pages)
    out = torch.empty_like(q)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    P = block_tables.shape[1]
    S, ws, tickets = split_buffers(q, KH, P)
    rc = load_library().dtt_paged_attention_v3(
        q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        block_tables.data_ptr(), seq_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), S,
        B, H, KH, D, page, P, window, scale,
        dtype_code(q.dtype), pool_code(k_vals.dtype), stream_ptr(q),
    )
    check(rc, "paged_attention_v3")
    count_launch(paged_decode_attention_v3, fp8=k_scale is not None)
    return out
