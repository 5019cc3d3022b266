"""JPEG decode with the standard library and numpy, bit for bit the pixels
Pillow gives (libjpeg-turbo with its default settings: the ``JDCT_ISLOW``
integer IDCT and fancy upsampling).

- markers: SOI, APPn (JFIF, Adobe, the ``ICC_PROFILE`` segments assembled
  as Pillow assembles them, MPF), DQT (8- and 16-bit tables), DHT,
  SOF0/1/2, DRI, SOS, RSTn, COM and EOI;
- entropy decoding: Huffman codes through a 16-bit peek table, one Python
  step per code; baseline (sequential) scans, and progressive ones (DC
  first and refine, AC first and refine with EOB runs, successive
  approximation); restart intervals;
- pixels, vectorized over every block: ``jidctint.c``'s islow IDCT
  (13 constant bits, 2 pass-1 bits, its descale and range limit),
  ``jdsample.c``'s fancy upsampling for h2v1, h1v2 and h2v2 (edge samples
  replicated; replication at two or fewer columns, as libjpeg falls back
  there) and replication for other integral factors, ``jdcolor.c``'s
  fixed-point YCbCr to RGB tables; grey is replicated into three channels.

An MPO's frame 0 is the file's first JPEG, decoded here (mpo.py reads its
index and the other frames). Lossless, hierarchical, arithmetic-coded and
12-bit JPEG and four components (CMYK/YCCK) raise ValueError naming the
ROADMAP item that would port them; a truncated or corrupt file raises
``ValueError("undecodable image bytes: ...")``.
"""

from __future__ import annotations

import struct
from array import array

import numpy as np

from dynamo_tpu_torch.multimodal.formats import (
    ITEM_OTHER_FORMATS,
    check_size,
    undecodable,
)

__all__ = ["decode_jpeg"]

# natural (row-major) index of each zigzag position, padded with 63 as
# libjpeg pads it: a corrupt run past the block lands on the last entry
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16
_SOF_DECODED = {0xC0: False, 0xC1: False, 0xC2: True}  # marker -> progressive
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
                0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
                0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}

# jidctint.c: FIX(x) at 13 constant bits
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _post_idct_limit() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by ``x & 1023``: x + 128
    clipped to [0, 255] for x in [-512, 512), wrapping outside it."""
    m = np.arange(1024)
    return np.select([m < 128, m < 512, m < 896], [m + 128, 255, 0], m - 896).astype(np.uint8)


_RANGE_LIMIT = _post_idct_limit()


def _ycc_tables() -> tuple[np.ndarray, ...]:
    """jdcolor.c's build_ycc_rgb_table (16 scale bits)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


# ------------------------------------------------------------------ parse


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "bw", "bh", "nbx", "nby", "width",
                 "height", "coef")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None


def _huffman_lut(counts: bytes, symbols: bytes) -> list[int]:
    """A 16-bit peek table: entry ``(length << 8) | symbol`` for every
    16-bit window that starts with a code, 0 where none does."""
    lut = np.zeros(1 << 16, np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise undecodable("bad Huffman table")
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            lut[lo:hi] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data of one scan from ``pos``: its restart
    intervals with stuffed bytes removed, and the offset of the marker that
    ends it (the end of the data when none does)."""
    segs = []
    n, start = len(data), pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        j = i + 1
        while j < n and data[j] == 0xFF:  # fill bytes before a marker
            j += 1
        if j >= n:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = data[j]
        if m == 0 and j == i + 1:
            pos = j + 1
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = pos = j + 1
            continue
        return segs, j - 1


# zero bytes past a restart interval's data: more than one block's codes
# can read (64 coefficients of at most 32 bits each), so a read past the
# data stays in the windows until the block ends and its bounds check runs
_PAD = 264


def _windows(seg: bytes) -> array:
    """Big-endian 64-bit windows of ``seg`` at every byte offset (zeros
    past its end): a read of up to 57 bits at bit ``p`` is one index and
    one shift."""
    buf = np.frombuffer(seg + bytes(_PAD + 8), np.uint8).astype(np.uint64)
    n = len(seg) + _PAD
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w |= buf[i: i + n] << np.uint64(56 - 8 * i)
    out = array("Q")
    out.frombytes(w.tobytes())
    return out


# --------------------------------------------------------------- entropy


def _scan_blocks(scan: list[_Component], mcusx: int,
                 mcusy: int) -> list[list[tuple[int, int]]]:
    """Per MCU of a scan, its blocks as (index of the component in the
    scan, offset of the block's first coefficient)."""
    if len(scan) == 1:
        c = scan[0]
        base = (np.arange(c.nby)[:, None] * c.bw + np.arange(c.nbx)[None, :]) * 64
        return [[(0, b)] for b in base.reshape(-1).tolist()]
    units = []
    for si, c in enumerate(scan):
        vv, hh = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing="ij")
        units.append((si, vv.reshape(-1), hh.reshape(-1), c))
    my, mx = np.meshgrid(np.arange(mcusy), np.arange(mcusx), indexing="ij")
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    cols = []
    for si, vv, hh, c in units:
        base = ((my * c.v + vv[None]) * c.bw + mx * c.h + hh[None]) * 64
        cols.append([[(si, b) for b in row] for row in base.tolist()])
    return [sum((col[m] for col in cols), []) for m in range(mcusx * mcusy)]


def _intervals(mcus: list, segs: list[bytes], ri: int):
    """(windows, bit count, MCUs) per restart interval."""
    step = ri or len(mcus)
    n = -(-len(mcus) // step) if mcus else 0
    if len(segs) < n:
        raise undecodable("truncated JPEG scan")
    for k in range(n):
        yield _windows(segs[k]), 8 * len(segs[k]), mcus[k * step:(k + 1) * step]


def _decode_sequential(scan, luts, mcus, segs, ri) -> None:
    """A baseline scan: every coefficient of each block."""
    zz = _ZIGZAG
    coefs = [c.coef for c in scan]
    dcs = [luts[0][i] for i in range(len(scan))]
    acs = [luts[1][i] for i in range(len(scan))]
    for w, nbits, part in _intervals(mcus, segs, ri):
        p = 0
        pred = [0] * len(scan)
        for mcu in part:
            for si, base in mcu:
                coef, alut = coefs[si], acs[si]
                e = dcs[si][(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if not e:
                    raise undecodable("bad Huffman code in JPEG scan")
                p += e >> 8
                s = e & 0xFF
                if s:
                    v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    pred[si] += v
                coef[base] = pred[si]
                k = 1
                while k < 64:
                    e = alut[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise undecodable("bad Huffman code in JPEG scan")
                    p += e >> 8
                    s = e & 15
                    if s:
                        k += (e >> 4) & 15
                        v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        coef[base + zz[k]] = v
                        k += 1
                    elif (e & 0xF0) == 0xF0:
                        k += 16
                    else:
                        break
                if p > nbits:
                    raise undecodable("truncated JPEG scan")


def _decode_dc(scan, luts, mcus, segs, ri, ah: int, al: int) -> None:
    """A progressive DC scan: first (the difference, shifted by ``al``) or
    refine (one bit per block)."""
    coefs = [c.coef for c in scan]
    dcs = [luts[0][i] for i in range(len(scan))]
    for w, nbits, part in _intervals(mcus, segs, ri):
        p = 0
        pred = [0] * len(scan)
        for mcu in part:
            for si, base in mcu:
                if ah:
                    if (w[p >> 3] >> (63 - (p & 7))) & 1:
                        coefs[si][base] |= 1 << al
                    p += 1
                    continue
                e = dcs[si][(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if not e:
                    raise undecodable("bad Huffman code in JPEG scan")
                p += e >> 8
                s = e & 0xFF
                if s:
                    v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    pred[si] += v
                coefs[si][base] = pred[si] << al
            if p > nbits:
                raise undecodable("truncated JPEG scan")


def _decode_ac_first(coef, alut, mcus, segs, ri, ss: int, se: int, al: int) -> None:
    """A progressive AC first scan of one component (jdphuff.c
    decode_mcu_AC_first)."""
    zz = _ZIGZAG
    for w, nbits, part in _intervals(mcus, segs, ri):
        p = eobrun = 0
        for ((_, base),) in part:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = alut[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if not e:
                    raise undecodable("bad Huffman code in JPEG scan")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    coef[base + zz[k]] = v << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
                k += 1
            if p > nbits:
                raise undecodable("truncated JPEG scan")


def _decode_ac_refine(coef, alut, mcus, segs, ri, ss: int, se: int, al: int) -> None:
    """A progressive AC refinement scan of one component (jdphuff.c
    decode_mcu_AC_refine): new coefficients of magnitude ``1 << al``, and a
    correction bit for each one already nonzero on the way."""
    zz = _ZIGZAG
    p1, m1 = 1 << al, -1 << al
    for w, nbits, part in _intervals(mcus, segs, ri):
        p = eobrun = 0
        for ((_, base),) in part:
            k = ss
            if not eobrun:
                while k <= se:
                    e = alut[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise undecodable("bad Huffman code in JPEG scan")
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        s = p1 if (w[p >> 3] >> (63 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & ((1 << r) - 1)
                            p += r
                        break
                    # skip r zero coefficients, correcting the nonzero ones
                    while True:
                        i = base + zz[k]
                        c = coef[i]
                        if c:
                            if (w[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                                coef[i] = c + (p1 if c >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                        if k > se:
                            break
                    if s:
                        coef[base + zz[k]] = s
                    k += 1
            if eobrun:
                # past the end of band: a correction bit per nonzero coefficient
                while k <= se:
                    i = base + zz[k]
                    c = coef[i]
                    if c:
                        if (w[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                            coef[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1
            if p > nbits:
                raise undecodable("truncated JPEG scan")


# ---------------------------------------------------------------- pixels


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N, 8, 8] (row-major) -> samples uint8
    [N, 8, 8]: jidctint.c's jpeg_idct_islow, columns then rows."""

    def one_pass(x, shift: int):
        # the 1-D transform along axis 1 of [N, 8, M], descaled by ``shift``
        g = [x[:, i] for i in range(8)]
        z1 = (g[2] + g[6]) * _F0541
        tmp2 = z1 + g[6] * -_F1847
        tmp3 = z1 + g[2] * _F0765
        tmp0 = (g[0] + g[4]) << _CONST_BITS
        tmp1 = (g[0] - g[4]) << _CONST_BITS
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = g[7], g[5], g[3], g[1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * _F1175
        t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
        z1, z2 = z1 * -_F0899, z2 * -_F2562
        z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
        rnd = 1 << (shift - 1)
        outs = (t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                t13 - t0, t12 - t1, t11 - t2, t10 - t3)
        return np.stack([(o + rnd) >> shift for o in outs], axis=1)

    x = coef.astype(np.int64)
    ws = one_pass(x, _CONST_BITS - _PASS1_BITS)  # columns: [N, 8 rows, 8 cols]
    out = one_pass(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)  # rows
    return _RANGE_LIMIT[out.transpose(0, 2, 1) & 1023]


def _upsample(x: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """One component's samples [h, w] -> [h * vf, w * hf]: jdsample.c's
    fancy triangle filters for 2:1 horizontal, vertical or both (the rows
    above the first and below the last, and the columns beside the edges,
    replicated), replication otherwise and at two or fewer columns."""
    h, w = x.shape
    if hf == vf == 1:
        return x
    fancy_h = hf == 2 and w > 2
    if (hf, vf) == (1, 2) or (vf == 2 and hf == 2 and fancy_h):
        a = x.astype(np.int32)
        above = np.concatenate([a[:1], a[:-1]])
        below = np.concatenate([a[1:], a[-1:]])
        if hf == 1:  # h1v2
            out = np.empty((2 * h, w), np.uint8)
            out[0::2] = (3 * a + above + 1) >> 2
            out[1::2] = (3 * a + below + 2) >> 2
            return out
        rows = np.empty((2 * h, w), np.int32)  # h2v2: column sums, then across
        rows[0::2] = 3 * a + above
        rows[1::2] = 3 * a + below
        left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        out = np.empty((2 * h, 2 * w), np.uint8)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
        return out
    if (hf, vf) == (2, 1) and fancy_h:
        a = x.astype(np.int32)
        left = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
        right = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
        out = np.empty((h, 2 * w), np.uint8)
        out[:, 0::2] = (3 * a + left + 1) >> 2
        out[:, 1::2] = (3 * a + right + 2) >> 2
        return out
    return np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)


# ------------------------------------------------------------------ decode


def decode_jpeg(data: bytes, pixels: bool = True) -> tuple[np.ndarray | None, dict]:
    """JPEG bytes -> (uint8 [H, W, 3], info): the pixels of Pillow's
    ``Image.open(...).convert("RGB")``, and the ``icc_profile`` Pillow keeps
    in ``info`` (present when the file has ICC segments; None when their
    count is wrong, as Pillow leaves it). ``pixels=False`` stops at the
    frame header: (None, info)."""
    if data[:3] != b"\xff\xd8\xff":
        raise undecodable("not a JPEG file")
    n = len(data)
    pos = 2
    qt: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], list[int]] = {}
    comps: list[_Component] = []
    info: dict = {}
    icc: list[bytes] = []
    saw_jfif = False
    adobe = None
    ri = 0
    frame = None  # (progressive, width, height)
    eoi = False
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1  # junk between segments, skipped as Pillow skips it
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            eoi = True
            break
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            raise undecodable("truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        body = data[pos + 2: pos + length]
        if length < 2 or len(body) != length - 2:
            raise undecodable("truncated JPEG marker segment")
        pos += length
        if 0xE0 <= m <= 0xEF:
            if m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
                saw_jfif = True
            elif m == 0xE2 and body[:12] == b"ICC_PROFILE\x00" and frame is None:
                icc.append(body)
            elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif m == 0xDB:
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                size = 128 if pq else 64
                vals = body[k + 1: k + 1 + size]
                if len(vals) != size or tq > 3:
                    raise undecodable("bad JPEG quantization table")
                q = np.frombuffer(vals, ">u2" if pq else np.uint8).astype(np.int64)
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG[:64]] = q
                qt[tq] = nat
                k += 1 + size
        elif m == 0xC4:
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = body[k + 1: k + 17]
                total = sum(counts)
                syms = body[k + 17: k + 17 + total]
                if len(counts) != 16 or len(syms) != total or tc > 1 or th > 3:
                    raise undecodable("bad JPEG Huffman table")
                huff[(tc, th)] = _huffman_lut(counts, syms)
                k += 17 + total
        elif m == 0xDD:
            if len(body) != 2:
                raise undecodable("bad JPEG restart interval")
            (ri,) = struct.unpack(">H", body)
        elif m in _SOF_REFUSED or m == 0xCC:
            kind = _SOF_REFUSED.get(m, "arithmetic-coded")
            raise ValueError(f"{kind} JPEG is not decoded by this port ({ITEM_OTHER_FORMATS})")
        elif m in _SOF_DECODED:
            if frame is not None or len(body) < 6:
                raise undecodable("bad JPEG frame header")
            depth, height, width, nf = struct.unpack(">BHHB", body[:6])
            if depth == 12:
                raise ValueError(f"12-bit JPEG is not decoded by this port ({ITEM_OTHER_FORMATS})")
            if nf == 4:
                raise ValueError(f"CMYK/YCCK JPEG is not decoded by this port "
                                 f"({ITEM_OTHER_FORMATS})")
            if depth != 8 or nf not in (1, 3) or len(body) != 6 + 3 * nf:
                raise undecodable(f"JPEG of {nf} components at {depth} bits")
            if width == 0 or height == 0:
                raise undecodable("JPEG without a size (DNL is not supported)")
            check_size(width, height)
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                    raise undecodable("bad JPEG sampling factors")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (_SOF_DECODED[m], width, height)
            _layout(comps, width, height)
            if icc:
                icc.sort()  # Pillow's order: by sequence number
                info["icc_profile"] = (b"".join(s[14:] for s in icc)
                                       if icc[0][13] == len(icc) else None)
            if not pixels:
                return None, info
        elif m == 0xDA:
            if frame is None:
                raise undecodable("JPEG scan before its frame header")
            pos = _scan(data, pos, body, comps, qt, huff, ri, frame)
        elif m == 0xDC:
            raise undecodable("JPEG DNL marker")
        # COM, APP and other segments carry nothing for the pixels
    if frame is None or not comps or comps[0].coef is None:
        raise undecodable("JPEG without image data" if eoi or frame else "truncated JPEG")
    return _pixels(comps, frame, saw_jfif, adobe), info


def _layout(comps: list[_Component], width: int, height: int) -> None:
    """Each component's sample size and its block grid (padded to whole
    MCUs of the interleaved layout)."""
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcusx, mcusy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise undecodable("fractional JPEG sampling factors")
        c.width, c.height = -(-width * c.h // hmax), -(-height * c.v // vmax)
        c.nbx, c.nby = -(-c.width // 8), -(-c.height // 8)
        c.bw, c.bh = mcusx * c.h, mcusy * c.v
        c.coef = None


def _scan(data: bytes, pos: int, body: bytes, comps: list[_Component], qt: dict,
          huff: dict, ri: int, frame) -> int:
    """Decode one scan whose header is ``body`` and whose data starts at
    ``pos``; returns the offset of the marker after it."""
    progressive, width, height = frame
    ns = body[0] if body else 0
    if ns < 1 or len(body) != 4 + 2 * ns:
        raise undecodable("bad JPEG scan header")
    by_id = {c.cid: c for c in comps}
    scan, dcs, acs = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        c = by_id.get(cid)
        if c is None:
            raise undecodable("JPEG scan of an unknown component")
        if c.coef is None:  # the quantization table latches at the first scan
            if c.tq not in qt:
                raise undecodable("JPEG component without a quantization table")
            c.quant = qt[c.tq]
            c.coef = [0] * (c.bw * c.bh * 64)
        scan.append(c)
        dcs.append(t >> 4)
        acs.append(t & 15)
    ss, se, ahl = body[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    segs, end = _segments(data, pos)
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcus = _scan_blocks(scan, -(-width // (8 * hmax)), -(-height // (8 * vmax)))

    def tables(tc: int, ids: list[int]) -> list[list[int]]:
        try:
            return [huff[(tc, t)] for t in ids]
        except KeyError:
            raise undecodable("JPEG scan uses an undefined Huffman table") from None

    if not progressive:
        if ss != 0 or se != 63 or ahl:
            raise undecodable("bad sequential JPEG scan")
        _decode_sequential(scan, (tables(0, dcs), tables(1, acs)), mcus, segs, ri)
    elif ss == 0:
        if se != 0:
            raise undecodable("bad progressive JPEG scan")
        _decode_dc(scan, (tables(0, dcs) if not ah else [None] * ns,), mcus, segs, ri, ah, al)
    else:
        if ns != 1 or se < ss or se > 63:
            raise undecodable("bad progressive JPEG scan")
        (alut,) = tables(1, acs)
        fn = _decode_ac_refine if ah else _decode_ac_first
        fn(scan[0].coef, alut, mcus, segs, ri, ss, se, al)
    return end


def _pixels(comps: list[_Component], frame, saw_jfif: bool, adobe: int | None) -> np.ndarray:
    """IDCT, upsample and colour-convert the decoded coefficients."""
    _, width, height = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.coef is None:  # a component no scan carried
            c.coef, c.quant = [0] * (c.bw * c.bh * 64), np.ones(64, np.int64)
        coef = np.array(c.coef, np.int64).reshape(-1, 64) * c.quant
        px = _idct_islow(coef.reshape(-1, 8, 8)).reshape(c.bh, c.bw, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[: c.height, : c.width]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    # libjpeg's guess of the colour space: JFIF means YCbCr, else an Adobe
    # transform of 0 means RGB, else component ids "R", "G", "B" do
    if saw_jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = [c.cid for c in comps] == [82, 71, 66]
    if rgb_space:
        return np.stack(planes, axis=2)
    y, cb, cr = planes[0].astype(np.int64), planes[1], planes[2]
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)
