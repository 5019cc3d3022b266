"""Token KV writes into the paged cache: CUDA kernel + its plain version.

Replaces the TPU kernel dynamo_tpu/ops/pallas/kv_write.py:_kv_write_kernel
(wrapper ``kv_write_pallas``): N new K/V rows ``[N, KH, D]`` land in layer
``layer`` at ``(dst_page[n], :, dst_off[n])`` of the pools
``[L, num_pages, KH, page, D]``, in place. Duplicate writes to trash page 0
are allowed and leave garbage there.

Bound on the H100: bytes. The work is a copy of ``2 * N * KH * D`` elements
(read once, written once) plus 2N indices; there is no arithmetic. The TPU
kernel had to read-modify-write whole pages because Mosaic cannot DMA a
single row; on Hopper a row store is direct, so the kernel
(csrc/kv_write.cu) gives each row one block whose threads store it with
16-byte vector stores and moves exactly the row bytes. At decode shapes
(N = 8 rows of 2 KB) one launch moves 64 KB, so launch latency, not
bandwidth, sets its time.

fp8 pools (``QuantPool``) never reach the kernel: the TPU kernel has no
fp8 branch, and the reference sends a quantized pool to its XLA
``quant_append_rows`` instead (dynamo_tpu/ops/pallas/kv_write.py
write_new_kv). So does this wrapper, on any device: ops/quant.py
``quant_append_rows`` in PyTorch ops, the same code as the plain version.
That is the reference's own route, not a fallback around a kernel; the
kv_write kernel launches 0 times on the fp8 path.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.cuda.build import (
    check,
    count_launch,
    counted,
    dtype_code,
    load_library,
    stream_ptr,
)
from dynamo_tpu_torch.ops.quant import is_quant, quant_append_rows


def kv_write_plain(
    k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor,
    dst_page: torch.Tensor, dst_off: torch.Tensor, *, layer: int,
) -> None:
    """Plain version: one ``index_put_`` per pool (in place); fp8 pools
    take the quantized append."""
    if is_quant(k_pages):
        quant_append_rows(k_pages, k_new, dst_page, dst_off, layer)
        quant_append_rows(v_pages, v_new, dst_page, dst_off, layer)
        return
    page = dst_page.long()
    off = dst_off.long()
    k_pages[layer][page, :, off] = k_new.to(k_pages.dtype)
    v_pages[layer][page, :, off] = v_new.to(v_pages.dtype)


def _check_args(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer):
    tensors = (k_pages, v_pages, k_new, v_new, dst_page, dst_off)
    if any(t.device != k_pages.device for t in tensors):
        raise ValueError("kv_write: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kv_write: tensors must be contiguous")
    if k_pages.dim() != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"kv_write: pools must be [L, NP, KH, page, D], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    L, _NP, KH, _page, D = k_pages.shape
    N = k_new.shape[0]
    if k_new.shape != (N, KH, D) or v_new.shape != (N, KH, D):
        raise ValueError(f"kv_write: rows must be [N, {KH}, {D}], got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if dst_page.shape != (N,) or dst_off.shape != (N,):
        raise ValueError("kv_write: dst_page/dst_off must be [N]")
    if dst_page.dtype != torch.int32 or dst_off.dtype != torch.int32:
        raise TypeError("kv_write: dst_page/dst_off must be int32")
    if not (k_pages.dtype == v_pages.dtype == k_new.dtype == v_new.dtype):
        raise TypeError("kv_write: rows must have the pool dtype")
    if (D * k_pages.element_size()) % 16:
        raise ValueError(f"kv_write: head dim {D} is not a 16-byte multiple")
    if not 0 <= layer < L:
        raise ValueError(f"kv_write: layer {layer} out of range [0, {L})")


@counted
def kv_write(
    k_pages: torch.Tensor,  # [L, num_pages, KH, page, D] (updated in place)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [N, KH, D]
    v_new: torch.Tensor,
    dst_page: torch.Tensor,  # [N] int32 (0 = trash page)
    dst_off: torch.Tensor,  # [N] int32
    *,
    layer: int,
) -> None:
    """Write N new-token KV rows into layer ``layer``'s page slots, in
    place. CUDA tensors launch the kernel; CPU tensors take the plain
    version; fp8 pools take ``quant_append_rows`` on any device (see the
    module notes)."""
    if k_pages.device.type == "cpu" or is_quant(k_pages):
        kv_write_plain(
            k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer=layer
        )
        return
    if k_pages.device.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {k_pages.device}")
    _check_args(k_pages, v_pages, k_new, v_new, dst_page, dst_off, layer)
    L, NP, KH, page, D = k_pages.shape
    lib = load_library()
    rc = lib.dtt_kv_write(
        k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), dst_page.data_ptr(), dst_off.data_ptr(),
        k_new.shape[0], layer, NP, KH, page, D, dtype_code(k_pages.dtype),
        stream_ptr(k_pages),
    )
    check(rc, "kv_write")
    count_launch(kv_write)
