"""VP8L (WebP lossless) decode with the standard library and numpy: the
ARGB pixels libwebp 1.6's ``src/dec/vp8l_dec.c`` decodes.

- the bit reader, least significant bit first, and its end of stream:
  reading past ``8 * max(len, 8)`` bits fails the decode (a stream
  shorter than 8 bytes reads zeros up to 64 bits, as libwebp's window
  does), checked where libwebp checks it;
- prefix codes: the simple code (one or two symbols, the first of 1 or 8
  bits), the normal code through the code-length code (its order,
  repeat codes 16, 17 and 18, the optional ``max_symbol``), with
  ``BuildHuffmanTable``'s checks: one used symbol is a code of no bits,
  any other code must be complete. Decoding is one table lookup per
  symbol (a second level past 10 bits);
- the meta prefix image (entropy image) choosing a group of five codes per
  tile, the colour cache (``0x1e35a7bd`` hash), LZ77 lengths and
  distances with the 120-entry distance map, overlapping copies;
- the four transforms, undone in reverse order: subtract-green and
  cross-colour vectorized over the image, colour indexing (the delta-coded
  palette, 1, 2 or 4 bits per pixel bundled in green, indices past the
  palette black and transparent) vectorized, and the predictor's 14 modes
  (15 and 16 as black) per tile: modes that do not read the left pixel one
  vector operation per tile, mode 1 a running sum, the others per pixel
  on packed ARGB ints as libwebp computes them.

``decode_vp8l`` takes a ``VP8L`` chunk's payload; ``decode_argb_stream``
takes a headerless stream of a known size (WebP's lossless alpha).
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu_torch.multimodal.formats import check_size, undecodable

__all__ = ["decode_argb_stream", "decode_vp8l", "vp8l_info"]

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# (dy << 4) | (8 - dx) of the 120 short distance codes
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c5845"
    "4b343c035759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e"
    "78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d"
    "515f40727e616f50717f6070")
_ALPHABET = (256 + 24, 256, 256, 256, 40)  # green (+ lengths, + cache), red, blue, alpha, distance
_ROOT_BITS = 10


class _Reader:
    """LSB-first bits of ``data``, zero-padded past its end."""

    __slots__ = ("data", "pos", "val", "nbits", "limit")

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(16)
        self.pos, self.val, self.nbits = 0, 0, 0
        self.limit = 8 * max(len(data), 8)

    def consumed(self) -> int:
        return 8 * self.pos - self.nbits

    def check(self) -> None:
        if self.consumed() > self.limit:
            raise undecodable("premature end of VP8L stream")

    def fill(self) -> None:
        """At least 32 bits in the window."""
        if self.nbits < 32:
            pos = self.pos
            if pos + 4 > len(self.data):
                raise undecodable("premature end of VP8L stream")
            self.val |= int.from_bytes(self.data[pos: pos + 4], "little") << self.nbits
            self.pos, self.nbits = pos + 4, self.nbits + 32

    def seek(self, c: int) -> None:
        """Continue reading at bit ``c`` of the stream."""
        self.pos, self.val, self.nbits = c >> 3, 0, 0
        self.bits(c & 7)

    def bits(self, n: int) -> int:
        if self.nbits < n:
            self.fill()
        v = self.val & ((1 << n) - 1)
        self.val >>= n
        self.nbits -= n
        return v


class _Code:
    """A prefix code's lookup: ``table[peek & mask]`` is ``sym << 5 | len``,
    or ``-(start << 5 | bits)`` for a second-level table at ``start``."""

    __slots__ = ("table", "mask", "single")

    def __init__(self, lengths: list[int]):
        used = [(ln, s) for s, ln in enumerate(lengths) if ln]
        if not used:
            raise undecodable("VP8L prefix code with no symbols")
        if len(used) == 1:  # a code of no bits
            self.single, self.table, self.mask = used[0][1], [used[0][1] << 5], 0
            return
        self.single = None
        counts = [0] * 16
        for ln, _ in used:
            counts[ln] += 1
        left = 1
        for ln in range(1, 16):
            left = 2 * left - counts[ln]
            if left < 0:
                raise undecodable("over-subscribed VP8L prefix code")
        if left:
            raise undecodable("incomplete VP8L prefix code")
        used.sort()
        maxlen = used[-1][0]
        root = min(maxlen, _ROOT_BITS)
        table = [0] * (1 << root)
        code, prev = 0, used[0][0]
        long_codes: dict[int, list] = {}
        for ln, s in used:
            code <<= ln - prev
            prev = ln
            rev = int(format(code, f"0{ln}b")[::-1], 2)
            if ln <= root:
                entry = (s << 5) | ln
                for k in range(rev, 1 << root, 1 << ln):
                    table[k] = entry
            else:
                long_codes.setdefault(rev & ((1 << root) - 1), []).append((rev >> root, ln, s))
            code += 1
        for low, codes in long_codes.items():
            sub = max(ln for _, ln, _ in codes) - root
            start = len(table)
            table.extend([0] * (1 << sub))
            for hi, ln, s in codes:
                for k in range(hi, 1 << sub, 1 << (ln - root)):
                    table[start + k] = (s << 5) | ln
            table[low] = -((start << 5) | sub)
        self.table, self.mask = table, (1 << root) - 1

    def lookup(self, v: int) -> tuple[int, int]:
        """(symbol, length) of the code at the low bits of ``v``."""
        e = self.table[v & self.mask]
        if e < 0:
            e = -e
            e = self.table[(e >> 5) + ((v >> _ROOT_BITS) & ((1 << (e & 31)) - 1))]
        return e >> 5, e & 31

    def read(self, br: _Reader) -> int:
        if self.single is not None:
            return self.single
        if br.nbits < 32:
            br.fill()
        e = self.table[br.val & self.mask]
        if e < 0:
            e = -e
            e = self.table[(e >> 5) + ((br.val >> _ROOT_BITS) & ((1 << (e & 31)) - 1))]
        ln = e & 31
        br.val >>= ln
        br.nbits -= ln
        return e >> 5


def _code_lengths(br: _Reader, alphabet: int) -> list[int]:
    """One prefix code's lengths (``ReadHuffmanCode``)."""
    lengths = [0] * max(alphabet, 256)
    if br.bits(1):  # simple code
        n = br.bits(1) + 1
        lengths[br.bits(8 if br.bits(1) else 1)] = 1
        if n == 2:
            lengths[br.bits(8)] = 1
        br.check()
        return lengths[:alphabet]
    cl = [0] * 19
    for i in range(br.bits(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.bits(3)
    lcode = _Code(cl)
    if br.bits(1):
        max_symbol = 2 + br.bits(2 + 2 * br.bits(3))
        if max_symbol > alphabet:
            raise undecodable("VP8L code lengths past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lcode.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.bits(extra) + offset
            if sym + repeat > alphabet:
                raise undecodable("VP8L code length repeat past the alphabet")
            lengths[sym: sym + repeat] = [prev if c == 16 else 0] * repeat
            sym += repeat
    br.check()
    return lengths[:alphabet]


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


class _Stream:
    """One VP8L image stream: transforms (the main image only), colour
    cache, prefix codes and the entropy-coded pixels."""

    def __init__(self, br: _Reader):
        self.br = br
        self.transforms: list[tuple] = []

    def image(self, width: int, height: int, level0: bool, alpha_8b: bool = False
              ) -> np.ndarray:
        """-> ARGB uint32 [height, width] (after the inverse transforms
        when ``level0``)."""
        br = self.br
        xsize = width
        seen = 0
        if level0:
            while br.bits(1):
                kind = br.bits(2)
                if seen & (1 << kind):
                    raise undecodable("VP8L transform repeated")
                seen |= 1 << kind
                if kind in (0, 1):  # predictor, cross-colour
                    bits = br.bits(3) + 2
                    sub = self.image(_sub(xsize, bits), _sub(height, bits), False)
                    self.transforms.append((kind, xsize, bits, sub))
                elif kind == 3:  # colour indexing
                    n = br.bits(8) + 1
                    bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                    pal = self.image(n, 1, False).reshape(-1)
                    self.transforms.append((kind, xsize, bits, _palette(pal, bits)))
                    xsize = _sub(xsize, bits)
                else:
                    self.transforms.append((2, xsize, 0, None))
        cache_bits = 0
        if br.bits(1):
            cache_bits = br.bits(4)
            if not 1 <= cache_bits <= 11:
                raise undecodable("bad VP8L colour cache size")
        groups, group_of, hbits = self._codes(xsize, height, cache_bits, level0)
        only_palette = (len(self.transforms) == 1 and self.transforms[0][0] == 3
                        and cache_bits == 0
                        and all(g is None or g[5] is not None for g in groups))
        px = self._pixels(xsize, height, cache_bits, groups, group_of, hbits,
                          tolerate_end=alpha_8b and only_palette)
        argb = np.array(px, np.uint32).reshape(height, xsize)
        if level0:
            for t in reversed(self.transforms):
                argb = _inverse(t, argb)
        return argb

    def _codes(self, xsize: int, height: int, cache_bits: int, level0: bool):
        br = self.br
        group_of, hbits, n_groups = None, 0, 1
        if level0 and br.bits(1):
            hbits = br.bits(3) + 2
            himg = self.image(_sub(xsize, hbits), _sub(height, hbits), False)
            group_of = ((himg >> 8) & 0xFFFF).astype(np.int64)
            n_groups = int(group_of.max()) + 1
        br.check()
        alphabets = list(_ALPHABET)
        alphabets[0] += (1 << cache_bits) if cache_bits else 0
        used = None if group_of is None else set(np.unique(group_of).tolist())
        groups = []
        for g in range(n_groups):
            codes = [_Code(_code_lengths(br, a)) for a in alphabets]
            red, blue, alpha = codes[1].single, codes[2].single, codes[3].single
            # red, blue and alpha of no bits: a literal is green alone
            arb = (None if None in (red, blue, alpha)
                   else (alpha << 24) | (red << 16) | blue)
            groups.append((*codes, arb) if used is None or g in used else None)
        return groups, (None if group_of is None else group_of.reshape(-1).tolist()), hbits

    def _pixels(self, width: int, height: int, cache_bits: int, groups, group_of,
                hbits: int, tolerate_end: bool) -> list:
        br = self.br
        total = width * height
        px = [0] * total
        cache = [0] * (1 << cache_bits) if cache_bits else None
        cache_shift = 32 - cache_bits
        cached = 0  # pixels before this one are in the cache
        limit = br.limit
        hxs = _sub(width, hbits) if group_of is not None else 0
        mask = (1 << hbits) - 1 if group_of is not None else -1
        i = x = y = 0
        green, red, blue, alpha, dist, arb = groups[group_of[0] if group_of is not None else 0]
        while i < total:
            if group_of is not None and (x & mask) == 0:
                green, red, blue, alpha, dist, arb = groups[
                    group_of[(y >> hbits) * hxs + (x >> hbits)]]
            if tolerate_end and br.consumed() > limit:
                raise undecodable("premature end of VP8L stream")
            if tolerate_end and limit - br.consumed() < 64:
                # a symbol that may read past the end: as libwebp reads it
                i, x, y, eos = _tail_symbol(br, px, i, x, y, width, green, dist)
                if eos:
                    break
                if group_of is not None and (x & mask) and i < total:
                    green, red, blue, alpha, dist, arb = groups[
                        group_of[(y >> hbits) * hxs + (x >> hbits)]]
                continue
            code = green.read(br)
            if code < 256:
                if arb is None:
                    r = red.read(br)
                    b = blue.read(br)
                    px[i] = (alpha.read(br) << 24) | (r << 16) | (code << 8) | b
                else:
                    px[i] = arb | (code << 8)
                i += 1
                x += 1
                if x == width:
                    x = 0
                    y += 1
            elif code < 280:
                length = _prefix_value(code - 256, br)
                d = _prefix_value(dist.read(br), br)
                if d > 120:
                    d -= 120
                else:
                    dc = _CODE_TO_PLANE[d - 1]
                    d = max(1, (dc >> 4) * width + 8 - (dc & 15))
                if i < d or total - i < length:
                    raise undecodable("bad VP8L backward reference")
                if d >= length:
                    px[i: i + length] = px[i - d: i - d + length]
                else:
                    pat = px[i - d: i]
                    px[i: i + length] = (pat * (length // d + 1))[:length]
                i += length
                x += length
                while x >= width:
                    x -= width
                    y += 1
                if group_of is not None and (x & mask) and i < total:
                    green, red, blue, alpha, dist, arb = groups[
                        group_of[(y >> hbits) * hxs + (x >> hbits)]]
            elif cache is not None and code < 280 + len(cache):
                while cached < i:
                    v = px[cached]
                    cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> cache_shift] = v
                    cached += 1
                px[i] = cache[code - 280]
                i += 1
                x += 1
                if x == width:
                    x = 0
                    y += 1
            else:
                raise undecodable("bad VP8L symbol")
        if not tolerate_end:
            br.check()
        elif i < total:
            raise undecodable("premature end of VP8L stream")
        return px


def _tail_symbol(br: _Reader, px: list, i: int, x: int, y: int, width: int, green: _Code,
                 dist: _Code) -> tuple[int, int, int, bool]:
    """One symbol of the 8-bit alpha path (``DecodeAlphaData``) within 64
    bits of the end, read as libwebp's reader reads it: past the data its
    64-bit window wraps (``bit_pos & 63``), a ``ReadBits`` that ends past it
    sets end-of-stream and rewinds to the window's start, later
    ``ReadBits`` give 0, a refill past the end rewinds too. Returns (i, x,
    y, end of stream); raises where libwebp fails the decode."""
    limit = br.limit
    start = limit - 64
    data = br.data
    c = br.consumed()
    eos = False

    def prefetch(at: int) -> int:
        if at >= limit:
            at = start + ((at - start) & 63)
        v = int.from_bytes(data[at >> 3: (at >> 3) + 5], "little") >> (at & 7)
        return v & ((1 << max(limit - at, 0)) - 1)

    def symbol(code: _Code) -> int:
        nonlocal c
        if code.single is not None:
            return code.single
        sym, ln = code.lookup((prefetch(c) & 0xFF) | ((prefetch(c + 8) & 0x7F) << 8))
        c += ln
        return sym

    def read_bits(n: int) -> int:
        nonlocal c, eos
        if eos:
            c = start
            return 0
        v = prefetch(c) & ((1 << n) - 1)
        c += n
        if c > limit:
            eos, c = True, start
        return v

    def prefix_value(sym: int) -> int:
        if sym < 4:
            return sym + 1
        extra = (sym - 2) >> 1
        return ((2 + (sym & 1)) << extra) + read_bits(extra) + 1

    code = symbol(green)
    if code < 256:
        px[i] = code << 8
        i, x = i + 1, x + 1
        if x == width:
            x, y = 0, y + 1
    elif code < 280:
        length = prefix_value(code - 256)
        dsym = symbol(dist)
        if c - start >= 32 and (eos or c > limit):  # the refill before the extra bits
            eos, c = True, start
        d = prefix_value(dsym)
        if d > 120:
            d -= 120
        else:
            dc = _CODE_TO_PLANE[d - 1]
            d = max(1, (dc >> 4) * width + 8 - (dc & 15))
        if i < d or len(px) - i < length:
            raise undecodable("bad VP8L backward reference")
        pat = px[i - d: i]
        px[i: i + length] = (pat * (length // d + 1))[:length]
        i, x = i + length, x + length
        while x >= width:
            x, y = x - width, y + 1
    else:
        raise undecodable("bad VP8L symbol")
    eos = eos or c > limit
    if not eos:
        br.seek(c)
    return i, x, y, eos


def _prefix_value(sym: int, br: _Reader) -> int:
    """An LZ77 length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.bits(extra) + 1


def _palette(pal: np.ndarray, bits: int) -> np.ndarray:
    """``ExpandColorMap``: the delta-coded palette summed per byte, padded
    with transparent black to ``1 << (8 >> bits)`` entries."""
    b = pal.view(np.uint8).reshape(-1, 4)
    full = np.zeros((1 << (8 >> bits), 4), np.uint8)
    full[: len(b)] = np.cumsum(b, axis=0, dtype=np.uint8)[: len(full)]
    return full.view(np.uint32).reshape(-1)


def _channels(argb: np.ndarray) -> np.ndarray:
    """ARGB uint32 [...] -> uint8 [..., 4] in memory order B, G, R, A."""
    return np.ascontiguousarray(argb, "<u4").view(np.uint8).reshape(argb.shape + (4,))


def _pack(ch: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(ch, np.uint8).view("<u4").reshape(ch.shape[:-1]).astype(np.uint32)


def _inverse(t: tuple, argb: np.ndarray) -> np.ndarray:
    kind, xsize, bits, data = t
    h = argb.shape[0]
    if kind == 2:  # add green to red and blue
        ch = _channels(argb)
        ch[..., 0] += ch[..., 1]
        ch[..., 2] += ch[..., 1]
        return _pack(ch)
    if kind == 1:  # cross colour
        m = _channels(data).astype(np.int8).astype(np.int32)  # [th, tw, 4]
        m = np.repeat(np.repeat(m, 1 << bits, axis=0), 1 << bits, axis=1)[:h, :xsize]
        ch = _channels(argb).astype(np.int32)
        green = ch[..., 1].astype(np.uint8).astype(np.int8).astype(np.int32)
        red = (ch[..., 2] + ((m[..., 0] * green) >> 5)) & 0xFF
        blue = ch[..., 0] + ((m[..., 1] * green) >> 5)
        blue = (blue + ((m[..., 2] * red.astype(np.uint8).astype(np.int8)) >> 5)) & 0xFF
        ch[..., 2], ch[..., 0] = red, blue
        return _pack(ch.astype(np.uint8))
    if kind == 3:  # colour indexing
        idx = ((argb >> 8) & 0xFF).astype(np.int64)
        if bits:
            per = 1 << bits
            bpp = 8 >> bits
            x = np.arange(xsize)
            idx = (idx[:, x >> bits] >> ((x & (per - 1)) * bpp)) & ((1 << bpp) - 1)
        return data[idx]
    return _predict(argb, xsize, bits, data)


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _clamp_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        v = ((a >> s) & 0xFF) + ((b >> s) & 0xFF) - ((c >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(a: int, b: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        x, y = (a >> s) & 0xFF, (b >> s) & 0xFF
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))  # C division truncates
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _select(t: int, l: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        c = (tl >> sh) & 0xFF
        s += abs(((l >> sh) & 0xFF) - c) - abs(((t >> sh) & 0xFF) - c)
    return t if s <= 0 else l


def _pred_left(mode: int, left: int, t: int, tr: int, tl: int) -> int:
    """The predictors that read the left pixel, on packed ARGB."""
    if mode == 5:
        return _avg2(_avg2(left, tr), t)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, t)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, left, tl)
    if mode == 12:
        return _clamp_full(left, t, tl)
    return _clamp_half(_avg2(left, t), tl)  # 13


def _predict(res: np.ndarray, width: int, bits: int, modes_img: np.ndarray) -> np.ndarray:
    """The predictor transform undone row by row (``PredictorInverseTransform``)."""
    h = res.shape[0]
    out = np.zeros((h, width), np.uint32)
    rc = _channels(res)
    # row 0: black, then each pixel from its left
    first = rc[0].copy()
    first[0, 3] = (int(first[0, 3]) + 255) & 0xFF  # + 0xff000000
    out[0] = _pack(np.cumsum(first, axis=0, dtype=np.uint8))
    modes = ((modes_img >> 8) & 0xF).astype(np.int64)
    tile = 1 << bits
    for y in range(1, h):
        up = out[y - 1]
        upc = _channels(up).astype(np.int32)
        # top-right of the last column is the row's own first pixel: kept
        # per pixel below
        row = np.zeros(width, np.uint32)
        resy = res[y]
        row[0] = _add(int(resy[0]), int(up[0]))
        trow = modes[y >> bits]
        upl = None
        x = 1
        while x < width:
            x_end = min((x & ~(tile - 1)) + tile, width)
            m = int(trow[x >> bits])
            if m in (0, 2, 3, 4, 8, 9, 14, 15):
                if m in (0, 14, 15):
                    pred = np.zeros((x_end - x, 4), np.int32)
                    pred[:, 3] = 255
                elif m == 2:
                    pred = upc[x:x_end]
                elif m == 4:
                    pred = upc[x - 1: x_end - 1]
                else:
                    trc = upc[x + 1: x_end + 1]
                    if x_end == width:  # the last column's top-right: this row's first
                        trc = np.concatenate([trc, _channels(row[:1]).astype(np.int32)])
                    if m == 3:
                        pred = trc
                    elif m == 8:
                        pred = (upc[x - 1: x_end - 1] + upc[x:x_end]) >> 1
                    else:  # 9
                        pred = (upc[x:x_end] + trc) >> 1
                row[x:x_end] = _pack((_channels(resy[x:x_end]).astype(np.int32) + pred) & 0xFF)
            elif m == 1:
                seg = _channels(resy[x:x_end]).copy()
                seg[0] = (seg[0].astype(np.int32) + _channels(row[x - 1: x])[0]) & 0xFF
                row[x:x_end] = _pack(np.cumsum(seg, axis=0, dtype=np.uint8))
            else:
                if upl is None:
                    upl = up.tolist()
                rl = resy[x:x_end].tolist()
                left = int(row[x - 1])
                vals = []
                for k in range(x, x_end):
                    tr = upl[k + 1] if k + 1 < width else int(row[0])
                    left = _add(rl[k - x], _pred_left(m, left, upl[k], tr, upl[k - 1]))
                    vals.append(left)
                row[x:x_end] = vals
            x = x_end
        out[y] = row
    return out


def vp8l_info(chunk: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a ``VP8L`` chunk's payload, with
    ``VP8LGetInfo``'s checks."""
    if len(chunk) < 5 or chunk[0] != 0x2F or chunk[4] >> 5:
        raise undecodable("bad VP8L header")
    bits = int.from_bytes(chunk[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def decode_vp8l(chunk: bytes) -> np.ndarray:
    """A ``VP8L`` chunk's payload -> ARGB uint32 [H, W]."""
    w, h, _ = vp8l_info(chunk)
    check_size(w, h)
    br = _Reader(chunk)
    br.bits(8)
    br.bits(32)
    return _Stream(br).image(w, h, True)


def decode_argb_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """A headerless VP8L stream of ``width`` x ``height`` (the lossless
    alpha of an ``ALPH`` chunk) -> ARGB uint32 [height, width]."""
    return _Stream(_Reader(data)).image(width, height, True, alpha_8b=True)
