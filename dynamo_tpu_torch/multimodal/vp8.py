"""VP8 lossy keyframe decode with the standard library and numpy: the
Y, U and V planes libwebp 1.6 reconstructs (RFC 6386, as ``src/dec/`` runs
it), before its RGB output stage (yuv.py).

- the boolean decoder of ``bit_reader_inl_utils.h``: ``range - 1`` kept,
  the split ``(range * p) >> 8``, sign bits read as ``VP8GetSigned`` reads
  them, and the end of a partition found where libwebp finds it (a byte is
  needed and none is left), which fails the decode;
- the frame header: segments (quantizer and filter level, absolute or
  delta, the segment map tree), the filter header with its reference and
  mode deltas, one to eight token partitions, the quantizer indices and
  their deltas, the coefficient probability updates and the skip flag;
- the intra modes: 16x16 DC/V/H/TM, the ten 4x4 modes through the tree
  with their contexts, chroma DC/V/H/TM; DC at the frame's top and left
  edges as ``CheckMode`` picks it; borders of 127 above and 129 to the
  left; the above-right samples of a 4x4 block (the macroblock to the
  upper right, 127 on the first row, the last pixel above repeated on the
  right column, and the macroblock's top-right replicated down its
  right column of blocks);
- tokens with their band and neighbour contexts, the dequantization
  tables (Y2's DC doubled, its AC scaled by 155/100 and at least 8, chroma
  DC capped at index 117), coefficients kept in 16 bits;
- the inverse WHT and the inverse DCT (20091 / 35468), vectorized over
  every block of the frame (a residual does not depend on the prediction
  it is added to, only the clipping does), each block by the transform
  libwebp picks for it: the full one as its SSE2 code computes it (16-bit
  sums), ``TransformAC3`` or the DC one;
- the simple and normal loop filters with sharpness, interior limits and
  ``hev`` thresholds, macroblocks whose coefficients are all zero and
  that are not 4x4-predicted left without inner edges. libwebp filters
  macroblock by macroblock in raster order, and each macroblock's edges
  touch the ones to its left and above; macroblocks (x, y) with the same
  ``x + 2 y`` never overlap, so the filter runs one vector step per such
  wavefront, each edge one operation over all its macroblocks.

Scale bits are ignored, and the planes are cropped to the frame's width
and height. A malformed stream raises ``ValueError("undecodable image
bytes: ...")``.
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu_torch.multimodal.formats import undecodable

__all__ = ["decode_vp8", "vp8_size"]

_COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080")
_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c5845"
    "4b343c035759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e"
    "78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d"
    "515f40727e616f50717f6070")
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = tuple(range(4, 59)) + tuple(range(60, 117, 2)) + (
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # one past the last too
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 mode tree: a leaf is -mode (0 for B_DC_PRED)
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
# 16x16 and chroma modes, and the 4x4 ones (B_DC_PRED ... B_HU_PRED)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)

# (shift, range - 1 after it) for each range 1..255 the decoder can reach
_NORM = [(0, 0)] + [(7 ^ (r.bit_length() - 1), (r << (7 ^ (r.bit_length() - 1))) - 1)
                    for r in range(1, 256)]

_PROBA0 = [[[list(_COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:][:11]) for c in range(3)]
            for b in range(8)] for t in range(4)]
_UPDATE = [[[list(_COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11:][:11]) for c in range(3)]
            for b in range(8)] for t in range(4)]
_BMODES = [[list(_BMODES_PROBA[(a * 10 + b) * 9:][:9]) for b in range(10)] for a in range(10)]


class _Bits:
    """libwebp's VP8 boolean decoder over ``data[start:end]``."""

    __slots__ = ("data", "pos", "end", "value", "bits", "rng")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.rng = 0, -8, 254
        self._load()

    def _load(self) -> None:
        pos, end = self.pos, self.end
        if pos + 7 <= end:
            self.value = (self.value << 56) | int.from_bytes(self.data[pos: pos + 7], "big")
            self.pos, self.bits = pos + 7, self.bits + 56
        elif pos < end:
            self.value = (self.value << 8) | self.data[pos]
            self.pos, self.bits = pos + 1, self.bits + 8
        else:
            raise undecodable("Premature end-of-partition encountered (VP8)")

    def get(self, p: int) -> int:
        if self.bits < 0:
            self._load()
        bits = self.bits
        rng = self.rng
        split = (rng * p) >> 8
        if (self.value >> bits) > split:
            self.value -= (split + 1) << bits
            shift, self.rng = _NORM[rng - split]
            self.bits = bits - shift
            return 1
        shift, self.rng = _NORM[split + 1]
        self.bits = bits - shift
        return 0

    def signed(self, v: int) -> int:
        """``VP8GetSigned``: one bit at probability 1/2, always one shift."""
        if self.bits < 0:
            self._load()
        bits = self.bits
        split = self.rng >> 1
        self.bits = bits - 1
        if (self.value >> bits) > split:
            self.value -= (split + 1) << bits
            self.rng = (self.rng - 1) | 1
            return -v
        self.rng |= 1
        return v

    def value_of(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(0x80)
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.get(0x80) else v


def vp8_size(chunk: bytes) -> tuple[int, int]:
    """(width, height) of a VP8 keyframe, with ``VP8GetInfo``'s checks."""
    if len(chunk) < 10 or chunk[3:6] != b"\x9d\x01\x2a":
        raise undecodable("bad VP8 frame header")
    bits = chunk[0] | (chunk[1] << 8) | (chunk[2] << 16)
    w = (chunk[6] | (chunk[7] << 8)) & 0x3FFF
    h = (chunk[8] | (chunk[9] << 8)) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= len(chunk):
        raise undecodable("bad VP8 frame header")
    if w == 0 or h == 0:
        raise undecodable("VP8 frame of no size")
    return w, h


def _large(br: _Bits, p: list) -> int:
    """``GetLargeValue``: a token of 2 and up, with its extra bits."""
    get = br.get
    if not get(p[3]):
        return 2 if not get(p[4]) else 3 + get(p[5])
    if not get(p[6]):
        if not get(p[7]):
            return 5 + get(159)
        return 7 + 2 * get(165) + get(145)
    bit1 = get(p[8])
    cat = 2 * bit1 + get(p[9 + bit1])
    v = 0
    for prob in _CAT3456[cat]:
        v = v + v + get(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bits, prob: list, ctx: int, dq: tuple, n: int, out: list, base: int) -> int:
    """``GetCoeffs``: one block's tokens into ``out[base:base + 16]``
    (natural order, dequantized, wrapped to 16 bits) -> the index past the
    last non-zero coefficient."""
    get = br.get
    p = prob[n][ctx]
    while n < 16:
        if not get(p[0]):
            return n  # end of block
        while not get(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not get(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            v = _large(br, p)
            p = prob[n + 1][2]
        c = br.signed(v) * dq[n > 0]
        out[base + _ZIGZAG[n]] = ((c + 32768) & 0xFFFF) - 32768
        n += 1
    return 16


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


class _Header:
    __slots__ = ("width", "height", "mb_w", "mb_h", "use_segment", "update_map",
                 "absolute_delta", "quantizer", "filter_strength", "segment_probs",
                 "simple", "level", "sharpness", "use_lf_delta", "ref_lf_delta",
                 "mode_lf_delta", "filter_type", "parts", "dqm", "proba", "skip_p")


def _parse_header(chunk: bytes) -> tuple[_Header, _Bits]:
    """``VP8GetHeaders``: the frame header up to the probabilities, with the
    bit reader left at the first macroblock's modes."""
    w, h = vp8_size(chunk)
    hd = _Header()
    hd.width, hd.height = w, h
    hd.mb_w, hd.mb_h = (w + 15) >> 4, (h + 15) >> 4
    bits = chunk[0] | (chunk[1] << 8) | (chunk[2] << 16)
    part_len = bits >> 5
    size = len(chunk) - 10
    if part_len > size:
        raise undecodable("bad partition length (VP8)")
    br = _Bits(chunk, 10, 10 + part_len)
    get = br.get
    get(0x80)  # colour space
    get(0x80)  # clamping type (libwebp always clamps)
    # segment header
    hd.use_segment, hd.update_map, hd.absolute_delta = get(0x80), 0, 1
    hd.quantizer, hd.filter_strength = [0] * 4, [0] * 4
    hd.segment_probs = [255, 255, 255]
    if hd.use_segment:
        hd.update_map = get(0x80)
        if get(0x80):
            hd.absolute_delta = get(0x80)
            hd.quantizer = [br.signed_value(7) if get(0x80) else 0 for _ in range(4)]
            hd.filter_strength = [br.signed_value(6) if get(0x80) else 0 for _ in range(4)]
        if hd.update_map:
            hd.segment_probs = [br.value_of(8) if get(0x80) else 255 for _ in range(3)]
    # filter header
    hd.simple, hd.level, hd.sharpness = get(0x80), br.value_of(6), br.value_of(3)
    hd.use_lf_delta = get(0x80)
    hd.ref_lf_delta, hd.mode_lf_delta = [0] * 4, [0] * 4
    if hd.use_lf_delta and get(0x80):
        for i in range(4):
            if get(0x80):
                hd.ref_lf_delta[i] = br.signed_value(6)
        for i in range(4):
            if get(0x80):
                hd.mode_lf_delta[i] = br.signed_value(6)
    hd.filter_type = 0 if hd.level == 0 else 1 if hd.simple else 2
    # token partitions: sizes of all but the last, then the data
    pos, end = 10 + part_len, len(chunk)
    last = (1 << br.value_of(2)) - 1
    if end - pos < 3 * last:
        raise undecodable("cannot parse partitions (VP8)")
    start = pos + 3 * last
    hd.parts = []
    for p in range(last):
        psize = min(int.from_bytes(chunk[pos + 3 * p: pos + 3 * p + 3], "little"), end - start)
        hd.parts.append((start, start + psize))
        start += psize
    if start >= end:
        raise undecodable("cannot parse partitions (VP8)")
    hd.parts.append((start, end))
    # quantizers
    base_q0 = br.value_of(7)
    dq = [br.signed_value(4) if get(0x80) else 0 for _ in range(5)]
    hd.dqm = []
    for s in range(4):
        if hd.use_segment:
            q = hd.quantizer[s] + (0 if hd.absolute_delta else base_q0)
        elif s > 0:
            hd.dqm.append(hd.dqm[0])
            continue
        else:
            q = base_q0
        y1 = (_DC_TABLE[_clip(q + dq[0], 127)], _AC_TABLE[_clip(q, 127)])
        y2 = (_DC_TABLE[_clip(q + dq[1], 127)] * 2,
              max(8, (_AC_TABLE[_clip(q + dq[2], 127)] * 101581) >> 16))
        uv = (_DC_TABLE[_clip(q + dq[3], 117)], _AC_TABLE[_clip(q + dq[4], 127)])
        hd.dqm.append((y1, y2, uv))
    get(0x80)  # update_proba, ignored on a keyframe
    proba = [[[[(br.value_of(8) if get(_UPDATE[t][b][c][p]) else _PROBA0[t][b][c][p])
                for p in range(11)] for c in range(3)] for b in range(8)] for t in range(4)]
    hd.proba = [[proba[t][_BANDS[n]] for n in range(17)] for t in range(4)]
    hd.skip_p = br.value_of(8) if get(0x80) else None
    return hd, br


def _parse_frame(chunk: bytes, hd: _Header, br: _Bits):
    """Every macroblock's modes (partition 0) and coefficients (the token
    partitions), row by row as ``ParseFrame`` reads them."""
    mb_w, mb_h = hd.mb_w, hd.mb_h
    n_mb = mb_w * mb_h
    coeffs = [0] * (n_mb * 384)
    is4 = bytearray(n_mb)
    ymode = bytearray(n_mb * 16)  # the 16x16 mode, or the 16 4x4 modes
    uvmode = bytearray(n_mb)
    segment = bytearray(n_mb)
    inner = bytearray(n_mb)  # 4x4-predicted, or any non-zero coefficient
    # per block, libwebp's 2-bit code choosing its inverse transform: 3 when
    # a coefficient past the third is set, 2 past the first, else 1 for a
    # non-zero DC (``NzCodeBits``)
    codes = bytearray(n_mb * 24)
    parts = [_Bits(chunk, s, e) for s, e in hd.parts]
    get = br.get
    probs_seg = hd.segment_probs
    intra_t = bytearray(4 * mb_w)  # B_DC_PRED above the first row
    nz_top = [0] * mb_w  # per column: 4 Y bits, 2 U, 2 V (libwebp's nz_)
    nzdc_top = [0] * mb_w
    bands = hd.proba
    skip_p = hd.skip_p
    for mb_y in range(mb_h):
        # modes of the whole row first
        row_modes = []
        intra_l = [0, 0, 0, 0]
        for mb_x in range(mb_w):
            if hd.update_map:
                seg = (get(probs_seg[1]) if not get(probs_seg[0])
                       else get(probs_seg[2]) + 2)
            else:
                seg = 0
            skip = get(skip_p) if skip_p is not None else 0
            i4 = not get(145)
            top = intra_t[4 * mb_x: 4 * mb_x + 4]
            if not i4:
                m = ((TM_PRED if get(128) else H_PRED) if get(156)
                     else (V_PRED if get(163) else DC_PRED))
                modes = bytes([m])
                intra_t[4 * mb_x: 4 * mb_x + 4] = bytes([m] * 4)
                intra_l = [m] * 4
            else:
                out = bytearray(16)
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        prob = _BMODES[top[x]][left]
                        i = _YMODES_INTRA4[get(prob[0])]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + get(prob[i])]
                        left = -i
                        top[x] = left
                        out[4 * y + x] = left
                    intra_l[y] = left
                intra_t[4 * mb_x: 4 * mb_x + 4] = top
                modes = bytes(out)
            uv = (DC_PRED if not get(142) else V_PRED if not get(114)
                  else TM_PRED if get(183) else H_PRED)
            row_modes.append((seg, skip, i4, modes, uv))
        # then the row's tokens
        tb = parts[mb_y & (len(parts) - 1)]
        nz_left = 0
        nzdc_left = 0
        for mb_x in range(mb_w):
            seg, skip, i4, modes, uv = row_modes[mb_x]
            k = mb_y * mb_w + mb_x
            is4[k], segment[k], uvmode[k] = i4, seg, uv
            if i4:
                ymode[16 * k: 16 * k + 16] = modes
            else:
                ymode[16 * k] = modes[0]
            base = 384 * k
            if skip:
                nz_top[mb_x] = nz_left = 0
                if not i4:
                    nzdc_top[mb_x] = nzdc_left = 0
                inner[k] = i4
                continue
            y1, y2, uvq = hd.dqm[seg]
            if not i4:
                dc = [0] * 16
                nz = _coeffs(tb, bands[1], nzdc_top[mb_x] + nzdc_left, y2, 0, dc, 0)
                nzdc_top[mb_x] = nzdc_left = int(nz > 0)
                # the WHT's 16 outputs are the Y blocks' DCs
                wht = _wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
                wht = None
            tnz = nz_top[mb_x] & 0x0F
            lnz = nz_left & 0x0F
            bits_y = 0
            for y in range(4):
                lb = lnz & 1
                for x in range(4):
                    b = base + 16 * (4 * y + x)
                    if wht is not None:
                        coeffs[b] = wht[4 * y + x]
                    nz = _coeffs(tb, ac, lb + (tnz & 1), y1, first, coeffs, b)
                    lb = int(nz > first)
                    tnz = (tnz >> 1) | (lb << 7)
                    code = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[b] != 0)
                    codes[24 * k + 4 * y + x] = code
                    bits_y |= code
                tnz >>= 4
                lnz = (lnz >> 1) | (lb << 7)
            out_t, out_l = tnz, lnz >> 4
            bits_uv = 0
            for ch in (0, 2):
                tnz = nz_top[mb_x] >> (4 + ch)
                lnz = nz_left >> (4 + ch)
                for y in range(2):
                    lb = lnz & 1
                    for x in range(2):
                        b = base + 256 + 16 * (2 * ch + 2 * y + x)
                        nz = _coeffs(tb, bands[2], lb + (tnz & 1), uvq, 0, coeffs, b)
                        lb = int(nz > 0)
                        tnz = (tnz >> 1) | (lb << 3)
                        code = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[b] != 0)
                        codes[24 * k + 16 + 2 * ch + 2 * y + x] = code
                        bits_uv |= code
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lb << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            nz_top[mb_x], nz_left = out_t, out_l
            inner[k] = i4 or bool(bits_y or bits_uv)
    return coeffs, codes, is4, ymode, uvmode, segment, inner


def _wht(dc: list) -> list:
    """``TransformWHT``: the 16 Y2 coefficients -> each Y block's DC, in
    raster order of the blocks (16 bits, as libwebp stores them)."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1] = (a0 + a1) >> 3, (a3 + a2) >> 3
        out[4 * i + 2], out[4 * i + 3] = (a0 - a1) >> 3, (a3 - a2) >> 3
    return [((v + 32768) & 0xFFFF) - 32768 for v in out]


def _wrap16(x: np.ndarray) -> np.ndarray:
    return ((x + 32768) & 0xFFFF) - 32768


def _idct(c: np.ndarray) -> np.ndarray:
    """The inverse DCT over blocks [N, 16] (natural order, int16 values) ->
    the residuals [N, 4, 4] each adds to its prediction (``v >> 3``), as
    ``Transform_SSE2`` computes it: every sum wrapped to 16 bits and the
    products by 35468 / 2^16 and 85627 / 2^16 taken as ``mulhi(x, k) + x``
    with k = -30068 and 20091 (``TransformOne``'s values wherever no sum
    overflows, which is every well-formed stream)."""
    w = _wrap16

    def mul_k1(x):
        return (x * 20091) >> 16

    def mul_k2(x):
        return (x * -30068) >> 16

    def rotate(x1, x3):
        cc = w(w(x1 - x3) + w(mul_k2(x1) - mul_k1(x3)))
        d = w(w(x1 + x3) + w(mul_k1(x1) + mul_k2(x3)))
        return cc, d

    c = c.reshape(-1, 4, 4).astype(np.int64)
    a, b = w(c[:, 0] + c[:, 2]), w(c[:, 0] - c[:, 2])  # vertical pass, per column
    cc, d = rotate(c[:, 1], c[:, 3])
    t = np.stack([w(a + d), w(b + cc), w(b - cc), w(a - d)], axis=1)  # [N, k, column]
    dc = w(t[..., 0] + 4)  # horizontal pass, one output row per k
    a, b = w(dc + t[..., 2]), w(dc - t[..., 2])
    cc, d = rotate(t[..., 1], t[..., 3])
    return np.stack([w(a + d), w(b + cc), w(b - cc), w(a - d)], axis=2) >> 3


def _idct_ac3(c: np.ndarray) -> np.ndarray:
    """``TransformAC3``: only coefficients 0, 1 and 4 set, in int."""
    in0, in1, in4 = c[:, 0].astype(np.int64) + 4, c[:, 1].astype(np.int64), c[:, 4].astype(np.int64)
    c4, d4 = (in4 * 35468) >> 16, ((in4 * 20091) >> 16) + in4
    c1, d1 = (in1 * 35468) >> 16, ((in1 * 20091) >> 16) + in1
    rows = np.stack([in0 + d4, in0 + c4, in0 - c4, in0 - d4], axis=1)  # [N, 4]
    cols = np.stack([d1, c1, -c1, -d1], axis=1)
    return (rows[:, :, None] + cols[:, None, :]) >> 3


def _residuals(coeffs: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Each block's residual [n_mb, 24, 4, 4] by the transform libwebp
    picks (``DoTransform``, ``DoUVTransform``): for Y, the full one (code
    3), ``TransformAC3`` (2) or the DC one (1); a chroma plane takes the
    full one on all four blocks when any has code 2 or 3, else the DC one."""
    c = coeffs.reshape(-1, 24, 16)
    n = c.shape[0]
    codes = codes.reshape(n, 24).copy()
    for lo in (16, 20):  # per chroma plane: all full or all DC
        full = (codes[:, lo: lo + 4] >= 2).any(axis=1)
        codes[:, lo: lo + 4] = np.where(full[:, None], 3, 1)
    out = np.zeros((n, 24, 4, 4), np.int64)
    flat_c, flat_codes, flat = c.reshape(-1, 16), codes.reshape(-1), out.reshape(-1, 4, 4)
    for code, fn in ((3, _idct), (2, _idct_ac3)):
        sel = np.nonzero(flat_codes == code)[0]
        if sel.size:
            flat[sel] = fn(flat_c[sel])
    sel = np.nonzero(flat_codes == 1)[0]
    if sel.size:  # TransformDC
        flat[sel] = ((flat_c[sel, 0].astype(np.int64) + 4) >> 3)[:, None, None]
    return out


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _pred4(mode: int, t: list, left: list) -> list:
    """One 4x4 block's prediction (rows of 4): ``t`` is the top-left and
    the eight samples above and above-right, ``left`` the four to the left."""
    X, A, B, C, D, E, F, G, H = t
    I, J, K, L = left
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4] * 4
    if mode == B_TM:
        return [[min(255, max(0, top + lv - X)) for top in (A, B, C, D)] for lv in left]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row] * 4
    if mode == B_HE:
        return [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4, [_avg3(J, K, L)] * 4,
                [_avg3(K, L, L)] * 4]
    if mode == B_RD:
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]  # by x - y + 3
        return [[e[x - y + 3] for x in range(4)] for y in range(4)]
    if mode == B_LD:
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]  # by x + y
        return [[e[x + y] for x in range(4)] for y in range(4)]
    if mode == B_VR:
        return [[(X + A + 1) >> 1, (A + B + 1) >> 1, (B + C + 1) >> 1, (C + D + 1) >> 1],
                [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)],
                [_avg3(J, I, X), (X + A + 1) >> 1, (A + B + 1) >> 1, (B + C + 1) >> 1],
                [_avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]]
    if mode == B_VL:
        return [[(A + B + 1) >> 1, (B + C + 1) >> 1, (C + D + 1) >> 1, (D + E + 1) >> 1],
                [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)],
                [(B + C + 1) >> 1, (C + D + 1) >> 1, (D + E + 1) >> 1, _avg3(E, F, G)],
                [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]]
    if mode == B_HD:
        return [[(I + X + 1) >> 1, _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)],
                [(J + I + 1) >> 1, _avg3(J, I, X), (I + X + 1) >> 1, _avg3(I, X, A)],
                [(K + J + 1) >> 1, _avg3(K, J, I), (J + I + 1) >> 1, _avg3(J, I, X)],
                [(L + K + 1) >> 1, _avg3(L, K, J), (K + J + 1) >> 1, _avg3(K, J, I)]]
    # B_HU
    return [[(I + J + 1) >> 1, _avg3(I, J, K), (J + K + 1) >> 1, _avg3(J, K, L)],
            [(J + K + 1) >> 1, _avg3(J, K, L), (K + L + 1) >> 1, _avg3(K, L, L)],
            [(K + L + 1) >> 1, _avg3(K, L, L), L, L],
            [L, L, L, L]]


def _pred_block(mode: int, size: int, top: np.ndarray, left: np.ndarray, tl: int,
                mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction; DC as ``CheckMode`` picks it
    at the frame's edges."""
    if mode == DC_PRED:
        shift = 5 if size == 16 else 4
        if mb_x and mb_y:
            v = (int(top.sum()) + int(left.sum()) + size) >> shift
        elif mb_y:  # no left
            v = (int(top.sum()) + size // 2) >> (shift - 1)
        elif mb_x:  # no top
            v = (int(left.sum()) + size // 2) >> (shift - 1)
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == TM_PRED:
        return np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size))
    return np.broadcast_to(left[:, None], (size, size))


def _reconstruct(hd: _Header, is4, ymode, uvmode, res_y: np.ndarray,
                 res_u: np.ndarray, res_v: np.ndarray):
    """Prediction plus residual, macroblock by macroblock (``ReconstructRow``)
    -> unfiltered Y [16 mb_h, 16 mb_w] and U, V [8 mb_h, 8 mb_w] (int32)."""
    mb_w, mb_h = hd.mb_w, hd.mb_h
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int32)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    work = np.zeros((17, 21), np.int32)  # row 0: top-left, 16 above, 4 above-right
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            k = mb_y * mb_w + mb_x
            y0, x0 = 16 * mb_y, 16 * mb_x
            if mb_y == 0:
                tl, top, tr = 127, np.full(16, 127, np.int32), np.full(4, 127, np.int32)
            else:
                tl = 129 if mb_x == 0 else int(Y[y0 - 1, x0 - 1])
                top = Y[y0 - 1, x0: x0 + 16]
                tr = (Y[y0 - 1, x0 + 16: x0 + 20] if mb_x < mb_w - 1
                      else np.full(4, Y[y0 - 1, x0 + 15], np.int32))
            left = (np.full(16, 129, np.int32) if mb_x == 0
                    else Y[y0: y0 + 16, x0 - 1])
            res = res_y[k]  # [16 blocks, 4, 4]
            if is4[k]:
                work[0, 0], work[0, 1:17], work[0, 17:21] = tl, top, tr
                work[1:17, 0] = left
                work[4, 17:21] = work[8, 17:21] = work[12, 17:21] = tr
                modes = ymode[16 * k: 16 * k + 16]
                for n in range(16):
                    r, c = n >> 2, n & 3
                    t = work[4 * r, 4 * c: 4 * c + 9].tolist()
                    lft = work[4 * r + 1: 4 * r + 5, 4 * c].tolist()
                    p = np.array(_pred4(modes[n], t, lft), np.int32)
                    work[4 * r + 1: 4 * r + 5, 4 * c + 1: 4 * c + 5] = np.clip(p + res[n], 0, 255)
                Y[y0: y0 + 16, x0: x0 + 16] = work[1:17, 1:17]
            else:
                p = _pred_block(ymode[16 * k], 16, top, left, tl, mb_x, mb_y)
                r16 = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0: y0 + 16, x0: x0 + 16] = np.clip(p + r16, 0, 255)
            cy, cx = 8 * mb_y, 8 * mb_x
            for P, R in ((U, res_u), (V, res_v)):
                if mb_y == 0:
                    ctl, ctop = 127, np.full(8, 127, np.int32)
                else:
                    ctl = 129 if mb_x == 0 else int(P[cy - 1, cx - 1])
                    ctop = P[cy - 1, cx: cx + 8]
                cleft = np.full(8, 129, np.int32) if mb_x == 0 else P[cy: cy + 8, cx - 1]
                p = _pred_block(uvmode[k], 8, ctop, cleft, ctl, mb_x, mb_y)
                r8 = R[k].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                P[cy: cy + 8, cx: cx + 8] = np.clip(p + r8, 0, 255)
    return Y, U, V


# ------------------------------------------------------------ loop filter


def _strengths(hd: _Header) -> list:
    """``PrecomputeFilterStrengths``: per segment and 4x4-ness,
    (limit, interior limit, hev threshold); a limit of 0 filters nothing."""
    out = []
    for s in range(4):
        if hd.use_segment:
            base = hd.filter_strength[s] + (0 if hd.absolute_delta else hd.level)
        else:
            base = hd.level
        row = []
        for i4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0] + (hd.mode_lf_delta[0] if i4 else 0)
            level = _clip(level, 63)
            if level == 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if hd.sharpness > 0:
                ilevel >>= 2 if hd.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - hd.sharpness)
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def _sclip1(v):  # [-1020, 1020] -> [-128, 127]
    return np.clip(v, -128, 127)


def _sclip2(v):  # [-112, 112] -> [-16, 15]
    return np.clip(v, -16, 15)


def _clip1(v):  # [-255, 511] -> [0, 255]
    return np.clip(v, 0, 255)


def _edge(b: np.ndarray, pos: int, axis: int, on: np.ndarray, thresh: np.ndarray,
          ithresh: np.ndarray, hev_t: np.ndarray, kind: str) -> None:
    """One edge of every block in ``b`` [n, S, S] filtered in place: the
    edge lies before index ``pos`` along ``axis`` (1: a horizontal edge,
    filtering down the columns; 2: a vertical edge, along the rows) and
    runs over indices 4.. of the other axis. ``on`` [n] selects the blocks;
    ``kind`` is "mb" (6 taps), "inner" (4 taps) or "simple" (2 taps)."""
    if not on.any():
        return
    sel = np.nonzero(on)[0]
    v = b[sel]
    if axis == 2:
        v = v.transpose(0, 2, 1)  # taps along axis 1 from here on
    p3, p2, p1, p0, q0, q1, q2, q3 = (v[:, pos + k, 4:] for k in range(-4, 4))
    t2 = (2 * thresh[sel] + 1)[:, None]
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind == "simple":
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        new = {-1: _clip1(p0 + a2), 0: _clip1(q0 - a1)}
        hev = need
    else:
        it = ithresh[sel][:, None]
        need &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
                 & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
        ht = hev_t[sel][:, None]
        hev = (np.abs(p1 - p0) > ht) | (np.abs(q1 - q0) > ht)
        # hev: DoFilter2 on p0, q0
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        h_p0, h_q0 = _clip1(p0 + a2), _clip1(q0 - a1)
        if kind == "mb":  # DoFilter6
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            new = {-3: _clip1(p2 + a3), -2: _clip1(p1 + a2), -1: _clip1(p0 + a1),
                   0: _clip1(q0 - a1), 1: _clip1(q1 - a2), 2: _clip1(q2 - a3)}
        else:  # DoFilter4
            a = 3 * (q0 - p0)
            a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            new = {-2: _clip1(p1 + a3), -1: _clip1(p0 + a2), 0: _clip1(q0 - a1),
                   1: _clip1(q1 - a3)}
        new[-1] = np.where(hev, h_p0, new[-1])
        new[0] = np.where(hev, h_q0, new[0])
        for k in new:
            if k not in (-1, 0):
                new[k] = np.where(hev, v[:, pos + k, 4:], new[k])
    for k, val in new.items():
        cur = v[:, pos + k, 4:]
        v[:, pos + k, 4:] = np.where(need, val, cur)
    if axis == 2:
        v = v.transpose(0, 2, 1)
    b[sel] = v


def _loop_filter(hd: _Header, Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                 segment, is4, inner) -> None:
    """``DoFilter`` for every macroblock, in place, one vector step per
    wavefront of macroblocks with the same ``x + 2 y``."""
    if hd.filter_type == 0:
        return
    mb_w, mb_h = hd.mb_w, hd.mb_h
    st = _strengths(hd)
    k = np.arange(mb_w * mb_h)
    params = np.array([st[segment[i]][is4[i]] for i in range(mb_w * mb_h)],
                      np.int64).reshape(-1, 3)
    limit, ilevel, hev_t = params[:, 0], params[:, 1], params[:, 2]
    inner_on = np.frombuffer(bytes(inner), np.uint8).astype(bool) & (limit > 0)
    xs, ys = k % mb_w, k // mb_w
    left_on, top_on = (xs > 0) & (limit > 0), (ys > 0) & (limit > 0)
    simple = hd.filter_type == 1
    # planes with a 4-sample margin above and to the left
    Yp = np.zeros((16 * mb_h + 4, 16 * mb_w + 4), np.int32)
    Yp[4:, 4:] = Y
    planes = [(Yp, 16)]
    if not simple:
        Up = np.zeros((8 * mb_h + 4, 8 * mb_w + 4), np.int32)
        Vp = np.zeros_like(Up)
        Up[4:, 4:], Vp[4:, 4:] = U, V
        planes += [(Up, 8), (Vp, 8)]
    wave = xs + 2 * ys
    for t in range(int(wave.max()) + 1):
        ids = np.nonzero(wave == t)[0]
        if not ids.size:
            continue
        lim, il, ht = limit[ids], ilevel[ids], hev_t[ids]
        lon, ton, ion = left_on[ids], top_on[ids], inner_on[ids]
        for P, s in planes:
            r = (ys[ids] * s)[:, None, None] + np.arange(s + 4)[None, :, None]
            c = (xs[ids] * s)[:, None, None] + np.arange(s + 4)[None, None, :]
            b = P[r, c]
            inner_pos = (8, 12, 16) if s == 16 else (8,)
            if simple:
                _edge(b, 4, 2, lon, lim + 4, il, ht, "simple")
                for pos in inner_pos:
                    _edge(b, pos, 2, ion, lim, il, ht, "simple")
                _edge(b, 4, 1, ton, lim + 4, il, ht, "simple")
                for pos in inner_pos:
                    _edge(b, pos, 1, ion, lim, il, ht, "simple")
            else:
                _edge(b, 4, 2, lon, lim + 4, il, ht, "mb")
                for pos in inner_pos:
                    _edge(b, pos, 2, ion, lim, il, ht, "inner")
                _edge(b, 4, 1, ton, lim + 4, il, ht, "mb")
                for pos in inner_pos:
                    _edge(b, pos, 1, ion, lim, il, ht, "inner")
            P[r, c] = b
    Y[...] = Yp[4:, 4:]
    if not simple:
        U[...], V[...] = Up[4:, 4:], Vp[4:, 4:]


def decode_vp8(chunk: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A VP8 keyframe (the payload of a ``VP8 `` chunk) -> (Y [H, W],
    U [(H+1)//2, (W+1)//2], V) uint8, the planes libwebp decodes."""
    hd, br = _parse_header(chunk)
    coeffs, codes, is4, ymode, uvmode, segment, inner = _parse_frame(chunk, hd, br)
    res = _residuals(np.array(coeffs, np.int64), np.frombuffer(bytes(codes), np.uint8))
    Y, U, V = _reconstruct(hd, is4, ymode, uvmode, res[:, :16], res[:, 16:20], res[:, 20:])
    _loop_filter(hd, Y, U, V, segment, is4, inner)
    w, h = hd.width, hd.height
    return (Y[:h, :w].astype(np.uint8), U[: (h + 1) // 2, : (w + 1) // 2].astype(np.uint8),
            V[: (h + 1) // 2, : (w + 1) // 2].astype(np.uint8))
