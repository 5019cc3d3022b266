"""fp8 KV cache: the pool container and the codec (PyTorch forms).

The port's own copy of dynamo_tpu/ops/quant.py, GQA pools only. KV pages
quantize to ``float8_e4m3fn`` values with ONE bf16 scale per (layer, page,
KV head): ``vals [L, num_pages, KH, page, D]``, ``scale [L, num_pages, KH]``.
A page's scale only grows while one sequence holds it: an append computes
``max(old, amax(row) / 448)`` rounded to bf16, and the page's existing
values are re-encoded by ``old / new`` in the same pass. An append at row 0
means the page was just acquired, so the old scale counts as 0 there.
``scale == 0`` means an empty page (dequant gives zeros).

The codec gives the same bits as the JAX one: divisions in f32, the clip
to +-448 BEFORE every cast (e4m3fn has no infinity; casts differ between
frameworks past the range), one direct f32 -> e4m3 round-to-nearest-even
cast. Two CUDA kernels repeat this arithmetic in place: the fused decode
kernel's append (csrc/common.cuh) and kv_write's fp8 form
(csrc/kv_write.cu), which applies the rows aimed at one page in index
order, one full append each, so rows that share a page (a verify's
siblings) land in one launch. chip_smoke.py holds both kernels' pool bits
against ``quant_append_rows``.

The MLA latent pool (models/mla.py) has no head axis: ``vals [L,
num_pages, page, D]`` with ONE bf16 scale per row, ``scale [L, num_pages,
page]``. A row owns its scale, so an append is a plain store of the row
and its scale (``quant_append_rows`` on 2-D rows): no page
read-modify-write, and rows that share a page never requantize each
other. Prefill quantizes whole page tiles with ``head_axes=(2,)``.

Values are read and written through ``uint8`` views: PyTorch has no
gather or scatter kernel for ``float8_e4m3fn`` on every device.

The KVBM block codec (``pack_pages`` / ``unpack_pages`` /
``packed_block_ok``) carries whole quantized pages as ONE ``uint8 [L, n,
X]`` payload per pool: per (layer, page) the fp8 value bytes, then the bf16
scale bytes, for either scale layout. Packing and unpacking are pure byte
reinterpretation: no page takes a dequantize-requantize round trip.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # float8_e4m3fn max finite
SCALE_DTYPE = torch.bfloat16
_TINY = 1e-30  # division guard; never the stored scale

KV_DTYPES = ("bf16", "fp8")


def resolve_kv_dtype(value: str | None = None) -> str:
    """Normalize an EngineConfig.kv_dtype / DYN_KV_DTYPE setting. Empty or
    None consults DYN_KV_DTYPE (default bf16); an explicit value wins over
    the environment. "bf16" = unquantized pool in the model dtype, "fp8" =
    e4m3 values with per-page per-head bf16 scales."""
    v = (value or os.environ.get("DYN_KV_DTYPE") or "bf16").strip().lower()
    if v in ("bf16", "bfloat16", "native"):
        return "bf16"
    if v in ("fp8", "float8", "e4m3", "float8_e4m3fn"):
        return "fp8"
    raise ValueError(
        f"unknown kv_dtype {value!r} (DYN_KV_DTYPE): expected one of "
        f"{KV_DTYPES}"
    )


class QuantPool(NamedTuple):
    """One quantized KV pool: fp8 ``vals [L, NP, KH, page, D]`` and bf16
    ``scale [L, NP, KH]`` (GQA), or ``vals [L, NP, page, D]`` and ``scale
    [L, NP, page]`` (the MLA latent pool), or one layer's slices of both.
    ``shape``,
    ``dtype`` and ``device`` are the values', so shape-reading call sites
    work on either pool form."""

    vals: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.vals.shape

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ndim(self):
        return self.vals.ndim

    @property
    def device(self):
        return self.vals.device

    @property
    def nbytes(self) -> int:
        return self.vals.nbytes + self.scale.nbytes

    def layer(self, li: int) -> "QuantPool":
        """One layer's slices of both tensors (views)."""
        return QuantPool(self.vals[li], self.scale[li])


def is_quant(pool) -> bool:
    return isinstance(pool, QuantPool)


def init_quant_pool(vals_shape: tuple[int, ...], scale_ndim: int,
                    device: torch.device | str = "cpu") -> QuantPool:
    """Zero pool: fp8 zeros and zero scales (scale 0 == empty page)."""
    return QuantPool(
        torch.zeros(vals_shape, dtype=FP8_DTYPE, device=device),
        torch.zeros(vals_shape[:scale_ndim], dtype=SCALE_DTYPE, device=device),
    )


# ------------------------------------------------------------ codec math


def _over_fp8_max(x: torch.Tensor) -> torch.Tensor:
    """x / 448 as an IEEE division. Divided by a Python number, a CUDA
    tensor is multiplied by the number's reciprocal instead, which rounds
    differently (and so would the scale after its bf16 rounding)."""
    return x / torch.full_like(x, FP8_MAX)


def append_scale(old_scale_f32: torch.Tensor, rows_f32: torch.Tensor) -> torch.Tensor:
    """New per-head scale after appending ``rows`` (amax over the last
    axis), rounded through bf16 and returned as f32. Never below the old
    scale."""
    amax = rows_f32.abs().amax(dim=-1)
    ns = torch.maximum(old_scale_f32, _over_fp8_max(amax))
    return ns.to(SCALE_DTYPE).float()


def rescale_factor(old_scale_f32: torch.Tensor, new_scale_f32: torch.Tensor) -> torch.Tensor:
    """old / new, which re-encodes existing values under a grown scale (0
    for empty pages)."""
    return torch.where(
        new_scale_f32 > 0,
        old_scale_f32 / new_scale_f32.clamp(min=_TINY),
        0.0,
    )


def quant_values(x_f32: torch.Tensor, scale_f32: torch.Tensor) -> torch.Tensor:
    """x / scale clipped into the finite e4m3 range, still f32 (callers
    cast)."""
    q = torch.where(scale_f32 > 0, x_f32 / scale_f32.clamp(min=_TINY), 0.0)
    return q.clamp(-FP8_MAX, FP8_MAX)


def dequant(vals: torch.Tensor, scale_f32: torch.Tensor) -> torch.Tensor:
    """fp8 values -> f32 under a (broadcastable) f32 scale."""
    return vals.float() * scale_f32


def quant_page_tiles(
    tiles: torch.Tensor,  # [n, KH, page, D] (or [n, page, D] for MLA), any float dtype
    valid_tok: torch.Tensor,  # bool, broadcastable over tiles (True = real)
    head_axes: tuple[int, ...],  # axes reduced per scale entry
) -> tuple[torch.Tensor, torch.Tensor]:
    """Page-granular prefill quantization: zero the padded rows FIRST (they
    would otherwise inflate the page amax), then one scale per (page,
    head) with ``head_axes=(2, 3)``, or per (page, row) with ``(2,)`` on
    MLA tiles. Returns ``(vals fp8, scale bf16)``."""
    t = torch.where(valid_tok, tiles.float(), 0.0)
    s = _over_fp8_max(t.abs().amax(dim=head_axes)).to(SCALE_DTYPE)
    sf = s.float()
    expand = sf.reshape(sf.shape + (1,) * len(head_axes))
    return quant_values(t, expand).to(FP8_DTYPE), s


def quant_append_rows(
    pool: QuantPool,  # [L, NP, KH, page, D] or MLA [L, NP, page, D] (in place)
    rows: torch.Tensor,  # [N, KH, D] (MLA: [N, D]) new rows, unquantized
    dst_page: torch.Tensor,  # [N] pool pages (0 = trash)
    dst_off: torch.Tensor,  # [N] row offsets within the page
    layer: int,
) -> None:
    """Quantized KV append, in place. GQA rows: gather the destination
    pages, grow their scales by the new rows' amax (from 0 when
    ``dst_off == 0``: a page just acquired does not inherit its last
    occupant's scale), re-encode the old rows, splice the quantized rows
    in, scatter back. Rows must target distinct pages (duplicates on trash
    page 0 leave garbage there, by contract); ops/cuda/kv_write.py applies
    rows that share a page in rounds of distinct pages. MLA rows (2-D):
    each row's own scale ``append_scale(0, row)``, the row and its scale
    stored at (page, offset), nothing else touched, so rows may share
    pages."""
    pg = dst_page.long()
    off = dst_off.long()
    rows_f = rows.float()
    if rows.ndim == 2:
        ns = append_scale(torch.zeros_like(rows_f[:, 0]), rows_f)  # [N]
        row_q = quant_values(rows_f, ns[:, None]).to(FP8_DTYPE)
        pool.vals.view(torch.uint8)[layer, pg, off] = row_q.view(torch.uint8)
        pool.scale[layer, pg, off] = ns.to(SCALE_DTYPE)
        return
    page_size = pool.vals.shape[-2]
    old_s = pool.scale[layer][pg].float()  # [N, KH]
    old_s = torch.where((off == 0)[:, None], 0.0, old_s)
    ns = append_scale(old_s, rows_f)  # [N, KH]
    fac = rescale_factor(old_s, ns)
    vals_u8 = pool.vals.view(torch.uint8)[layer]
    page_f = vals_u8[pg].view(FP8_DTYPE).float() * fac[:, :, None, None]
    row_q = quant_values(rows_f, ns[:, :, None])  # [N, KH, D]
    hit = (torch.arange(page_size, device=rows.device)[None, None, :, None]
           == off[:, None, None, None])
    merged = torch.where(hit, row_q[:, :, None, :], page_f).clamp(-FP8_MAX, FP8_MAX)
    vals_u8[pg] = merged.to(FP8_DTYPE).view(torch.uint8)
    pool.scale[layer][pg] = ns.to(SCALE_DTYPE)


def gather_dequant_pages(
    pool_l: QuantPool,  # one layer: vals [NP, KH, page, D], scale [NP, KH]
    block_table: torch.Tensor,  # [..., P]
) -> torch.Tensor:
    """Quantized counterpart of ops.attention.gather_pages: the context as
    f32 ``[..., P * page, KH, D]``, dequantized."""
    bt = block_table.long()
    vals = pool_l.vals.view(torch.uint8)[bt].view(FP8_DTYPE)  # [..., P, KH, page, D]
    toks = dequant(vals, pool_l.scale[bt].float()[..., None, None])
    *lead, P, KH, page, D = toks.shape
    return toks.transpose(-3, -2).reshape(*lead, P * page, KH, D)


def gather_dequant_rows(
    pool_l: QuantPool,  # one layer: vals [NP, page, D], scale [NP, page]
    block_table: torch.Tensor,  # [..., P]
) -> torch.Tensor:
    """The MLA counterpart: the latent rows as f32 ``[..., P * page, D]``,
    each under its own scale."""
    bt = block_table.long()
    vals = pool_l.vals.view(torch.uint8)[bt].view(FP8_DTYPE)  # [..., P, page, D]
    rows = dequant(vals, pool_l.scale[bt].float()[..., None])
    *lead, P, page, D = rows.shape
    return rows.reshape(*lead, P * page, D)


# -------------------------------------------------------- KVBM block codec


def packed_bytes_per_page(pool: QuantPool) -> int:
    """Per-(layer, page) payload bytes of a packed tier block."""
    vals_n = 1
    for d in pool.vals.shape[2:]:
        vals_n *= d
    return vals_n * pool.vals.element_size() + packed_scale_bytes(pool)


def packed_scale_bytes(pool: QuantPool) -> int:
    """Per-(layer, page) scale-tail bytes of a packed tier block: the suffix
    of ``packed_bytes_per_page`` that ``packed_block_ok`` decodes."""
    scale_n = 1
    for d in pool.scale.shape[2:]:
        scale_n *= d
    return scale_n * pool.scale.element_size()


def pack_pages(pool: QuantPool, page_ids: torch.Tensor) -> torch.Tensor:
    """Whole pages ``page_ids [n]`` of both tensors as ONE ``uint8 [L, n,
    X]``: fp8 value bytes then bf16 scale bytes per (layer, page), the
    reference's byte order."""
    idx = page_ids.long()
    L, n = pool.vals.shape[0], idx.numel()
    vb = pool.vals.view(torch.uint8)[:, idx].reshape(L, n, -1)
    sb = pool.scale[:, idx].reshape(L, n, -1).view(torch.uint8)
    return torch.cat([vb, sb], dim=-1)


def unpack_pages(
    packed: torch.Tensor,  # [L, n, X] uint8
    vals_tail: tuple[int, ...],  # pool.vals.shape[2:]
    scale_tail: tuple[int, ...],  # pool.scale.shape[2:]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_pages``: (values as ``uint8 [L, n, *vals_tail]``,
    the fp8 bytes, and scales ``bf16 [L, n, *scale_tail]``)."""
    L, n, _X = packed.shape
    vn = 1
    for d in vals_tail:
        vn *= d
    vals = packed[:, :, :vn].reshape((L, n) + tuple(vals_tail))
    scale = packed[:, :, vn:].contiguous().view(SCALE_DTYPE)
    return vals, scale.reshape((L, n) + tuple(scale_tail))


def insert_packed_(pool: QuantPool, page_ids: torch.Tensor, packed: torch.Tensor) -> None:
    """Write packed blocks into pages ``page_ids`` of both tensors, in
    place (the pools keep their storage)."""
    vals, scale = unpack_pages(packed, tuple(pool.vals.shape[2:]),
                               tuple(pool.scale.shape[2:]))
    idx = page_ids.long()
    pool.vals.view(torch.uint8)[:, idx] = vals
    pool.scale[:, idx] = scale


def packed_block_ok(block: tuple, expect_nbytes: int, scale_tail_bytes: int) -> bool:
    """Host-side check of ONE tier block's parts before onboard: ``uint8 [L,
    X]`` with the expected length and FINITE scales (a corrupt scale would
    dequantize a whole page to NaN/inf). The bf16 scale tail decodes as its
    bits shifted into the top half of an f32."""
    for part in block:
        arr = np.asarray(part)
        if arr.dtype != np.uint8 or arr.ndim != 2:
            return False
        if arr.shape[-1] != expect_nbytes:
            return False
        tail = np.ascontiguousarray(arr[:, expect_nbytes - scale_tail_bytes:])
        f32 = (tail.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        if not np.isfinite(f32).all():
            return False
    return True
