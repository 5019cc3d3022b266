"""Token KV writes into the paged cache: CUDA kernel + its plain version.

Replaces the TPU kernel dynamo_tpu/ops/pallas/kv_write.py:_kv_write_kernel
(wrapper ``kv_write_pallas``) and its dispatcher ``write_new_kv``: N new
K/V rows ``[N, KH, D]`` land in layer ``layer`` at
``(dst_page[n], :, dst_off[n])`` of the pools ``[L, num_pages, KH, page,
D]``, in place. Duplicate writes to trash page 0 are allowed and leave
garbage there.

bf16/f32 pools. Bound on the H100: bytes, a copy of ``2 * N * KH * D``
elements (read once, written once) plus 2N indices, no arithmetic. The TPU
kernel had to read-modify-write whole pages because Mosaic cannot DMA a
single row; on Hopper a row store is direct, so the kernel
(csrc/kv_write.cu) gives each row one block whose threads store it with
16-byte vector stores and moves exactly the row bytes. At decode shapes
(N = 8 rows of 2 KB) one launch moves 64 KB, so launch latency, not
bandwidth, sets its time.

fp8 pools (``QuantPool``). The reference's dispatcher sends a quantized
pool to ``quant_append_rows`` (ops/quant.py here), which needs its rows on
distinct pages, so its verify forward lands a verify's rows one position
at a time. The kernel's fp8 form computes the same function in one launch
for any rows: the rows of one page apply in ascending index, each a full
requantizing append on that page (scale growth, re-encode of the page's
values, the new row spliced in, all back to e4m3 before the next row),
pages in parallel, rows on trash page 0 skipped. One launch per layer thus
replaces W position calls of ~15 PyTorch ops each per pool. Bound: bytes,
each touched (page, KV head) run read and written once with its scale,
plus the rows; at ~1 MB per verify-shaped launch its few dependent trips
to memory set the time (csrc/kv_write.cu has the design). The plain
version applies the rows in rounds, round r holding each page's r-th row:
one ``quant_append_rows`` call per pool and round, the reference's own
route; it reads the round count on the host.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.cuda.build import (
    check,
    count_launch,
    counted,
    dtype_code,
    load_library,
    pool_code,
    stream_ptr,
)
from dynamo_tpu_torch.ops.quant import is_quant, quant_append_rows


def append_rounds(dst_page: torch.Tensor) -> torch.Tensor:
    """Per row, the number of earlier rows (lower index) aimed at its page;
    rows on trash page 0 are all round 0. [N] int64."""
    pg = dst_page.long()
    n = pg.shape[0]
    same = (pg[:, None] == pg[None, :]) & (pg != 0)[:, None]
    earlier = torch.ones(n, n, dtype=torch.bool, device=pg.device).tril(-1)
    return (same & earlier).sum(dim=1)


def kv_write_plain(
    k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor,
    dst_page: torch.Tensor, dst_off: torch.Tensor, *, layer: int,
) -> None:
    """Plain version: one ``index_put_`` per pool (in place); fp8 pools
    take ``quant_append_rows`` once per pool and round (module notes)."""
    if is_quant(k_pages):
        rounds = append_rounds(dst_page)
        for r in range(int(rounds.max()) + 1 if rounds.numel() else 0):
            sel = (rounds == r).nonzero().squeeze(1)
            pg, off = dst_page[sel], dst_off[sel]
            quant_append_rows(k_pages, k_new[sel], pg, off, layer)
            quant_append_rows(v_pages, v_new[sel], pg, off, layer)
        return
    page = dst_page.long()
    off = dst_off.long()
    k_pages[layer][page, :, off] = k_new.to(k_pages.dtype)
    v_pages[layer][page, :, off] = v_new.to(v_pages.dtype)


def _check_args(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer):
    quant = is_quant(k_pages)
    if quant != is_quant(v_pages):
        raise TypeError("kv_write: K and V pools must be of one form")
    vals = (k_pages.vals, v_pages.vals) if quant else (k_pages, v_pages)
    scales = (k_pages.scale, v_pages.scale) if quant else ()
    tensors = (*vals, *scales, k_new, v_new, dst_page, dst_off)
    if any(t.device != k_pages.device for t in tensors):
        raise ValueError("kv_write: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kv_write: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (*vals, k_new, v_new)):
        raise ValueError("kv_write: pools and rows must be 16-byte aligned")
    if k_pages.ndim != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"kv_write: pools must be [L, NP, KH, page, D], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    L, NP, KH, page, D = k_pages.shape
    if quant and any(p.scale.shape != (L, NP, KH) or p.scale.dtype != torch.bfloat16
                     for p in (k_pages, v_pages)):
        raise ValueError(f"kv_write: fp8 scales must be bf16 [{L}, {NP}, {KH}]")
    N = k_new.shape[0]
    if k_new.shape != (N, KH, D) or v_new.shape != (N, KH, D):
        raise ValueError(f"kv_write: rows must be [N, {KH}, {D}], got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if dst_page.shape != (N,) or dst_off.shape != (N,):
        raise ValueError("kv_write: dst_page/dst_off must be [N]")
    if dst_page.dtype != torch.int32 or dst_off.dtype != torch.int32:
        raise TypeError("kv_write: dst_page/dst_off must be int32")
    if k_new.dtype != v_new.dtype or k_pages.dtype != v_pages.dtype or (
            not quant and k_pages.dtype != k_new.dtype):
        raise TypeError("kv_write: rows must have the pool dtype (or any on fp8)")
    if (D * k_new.element_size()) % 16:
        raise ValueError(f"kv_write: head dim {D} is not a 16-byte multiple")
    if not 0 <= layer < L:
        raise ValueError(f"kv_write: layer {layer} out of range [0, {L})")


@counted
def kv_write(
    k_pages,  # [L, num_pages, KH, page, D] or a QuantPool (updated in place)
    v_pages,
    k_new: torch.Tensor,  # [N, KH, D]
    v_new: torch.Tensor,
    dst_page: torch.Tensor,  # [N] int32 (0 = trash page)
    dst_off: torch.Tensor,  # [N] int32
    *,
    layer: int,
) -> None:
    """Write N new-token KV rows into layer ``layer``'s page slots, in
    place. CUDA tensors launch the kernel (its fp8 form on QuantPools);
    CPU tensors take the plain version."""
    if k_pages.device.type == "cpu":
        kv_write_plain(
            k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer=layer
        )
        return
    if k_pages.device.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {k_pages.device}")
    _check_args(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer)
    quant = is_quant(k_pages)
    L, NP, KH, page, D = k_pages.shape
    if quant:
        kp, vp = k_pages.vals, v_pages.vals
        ks, vs = k_pages.scale.data_ptr(), v_pages.scale.data_ptr()
    else:
        kp, vp, ks, vs = k_pages, v_pages, None, None
    rc = load_library().dtt_kv_write(
        kp.data_ptr(), vp.data_ptr(), ks, vs, k_new.data_ptr(), v_new.data_ptr(),
        dst_page.data_ptr(), dst_off.data_ptr(), k_new.shape[0], layer, NP, KH,
        page, D, dtype_code(k_new.dtype), pool_code(kp.dtype), stream_ptr(k_new),
    )
    check(rc, "kv_write")
    count_launch(kv_write, fp8=quant)
