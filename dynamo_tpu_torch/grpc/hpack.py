"""HPACK, HTTP/2's header compression (RFC 7541), for the gRPC server.

``Decoder`` reads what a client sends: the static and dynamic tables, the
dynamic table's size updates and eviction, integer and string literals and
Huffman-coded strings. ``Encoder`` writes the server's header blocks: plain
(not Huffman-coded) literals, which are legal, with incremental indexing
for the headers a response repeats (``:status``, ``content-type``,
``grpc-status`` ...), so that every later response names them by index.

The Huffman code is canonical: ``HUFFMAN_LENGTHS`` (the code length of
each of the 256 octets and EOS, RFC 7541 Appendix B) determines every
code: ordering the symbols by (length, symbol) and counting up gives them.
"""

from __future__ import annotations

from bisect import bisect_right

STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""),
    ("from", ""), ("host", ""), ("if-match", ""), ("if-modified-since", ""),
    ("if-none-match", ""), ("if-range", ""), ("if-unmodified-since", ""),
    ("last-modified", ""), ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
_STATIC_INDEX: dict[tuple[str, str], int] = {}
_STATIC_NAME: dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_INDEX.setdefault((_n, _v), _i)
    _STATIC_NAME.setdefault(_n, _i)

ENTRY_OVERHEAD = 32  # an entry's size is len(name) + len(value) + 32 octets
DEFAULT_TABLE_SIZE = 4096
MAX_STRING = 1 << 20  # a longer literal is refused (no header is that long)

# code length (bits) of octets 0..255 and of EOS (256)
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28,
    30, 28, 28, 28, 28, 28, 28, 28, 28, 28, 6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8,
    6, 6, 6, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10, 13, 6, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6, 15, 5, 6, 5,
    6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5, 6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13,
    28, 20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23, 24, 24, 22, 23,
    24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24, 22, 21, 20, 22, 22, 23, 23, 21, 23,
    22, 22, 24, 21, 22, 23, 23, 21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22,
    22, 23, 26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25, 19, 21, 26,
    27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27, 20, 24, 20, 21, 22, 21, 21, 23,
    22, 22, 25, 25, 24, 24, 26, 23, 26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27,
    27, 27, 26, 30,
)
EOS = 256
_MAX_LEN = 30


class HpackError(ValueError):
    """A header block that breaks RFC 7541 (a COMPRESSION_ERROR)."""


def huffman_codes() -> list[tuple[int, int]]:
    """(code, length) of each symbol 0..256, derived from the lengths."""
    order = sorted(range(257), key=lambda s: (HUFFMAN_LENGTHS[s], s))
    codes: list[tuple[int, int]] = [(0, 0)] * 257
    code, prev = 0, HUFFMAN_LENGTHS[order[0]]
    for s in order:
        code <<= HUFFMAN_LENGTHS[s] - prev
        prev = HUFFMAN_LENGTHS[s]
        codes[s] = (code, prev)
        code += 1
    return codes


def _decode_tables():
    """A canonical decoder's tables: for each code length L in use, the
    30-bit left-justified limit below which a window holds a code of at
    most L bits, the first code of length L and where its symbols start."""
    order = sorted(range(257), key=lambda s: (HUFFMAN_LENGTHS[s], s))
    codes = huffman_codes()
    limits, lengths, firsts, starts = [], [], [], []
    for i, s in enumerate(order):
        code, n = codes[s]
        if not lengths or lengths[-1] != n:
            lengths.append(n)
            firsts.append(code)
            starts.append(i)
            limits.append(0)
        limits[-1] = (code + 1) << (_MAX_LEN - n)
    return limits, lengths, firsts, starts, order


_LIMITS, _LENGTHS, _FIRSTS, _STARTS, _SYMBOLS = _decode_tables()


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded string literal. Padding longer than 7 bits,
    padding that is not EOS's leading ones, and an EOS inside the string
    raise ``HpackError``."""
    total = 8 * len(data)
    if not total:
        return b""
    n = int.from_bytes(data, "big")
    out = bytearray()
    pos = 0
    while pos < total:
        left = total - pos
        if left >= _MAX_LEN:
            window = (n >> (left - _MAX_LEN)) & ((1 << _MAX_LEN) - 1)
        else:  # past the end the window reads ones: EOS's prefix
            window = ((n & ((1 << left) - 1)) << (_MAX_LEN - left)) | (
                (1 << (_MAX_LEN - left)) - 1)
        k = bisect_right(_LIMITS, window)
        length = _LENGTHS[k]
        if length > left:  # the tail is padding
            if left > 7:
                raise HpackError("Huffman padding longer than 7 bits")
            if n & ((1 << left) - 1) != (1 << left) - 1:
                raise HpackError("Huffman padding is not EOS's prefix")
            break
        sym = _SYMBOLS[_STARTS[k] + (window >> (_MAX_LEN - length)) - _FIRSTS[k]]
        if sym == EOS:
            raise HpackError("EOS inside a Huffman-coded string")
        out.append(sym)
        pos += length
    return bytes(out)


def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytearray:
    """An HPACK integer in a ``prefix_bits``-bit prefix, the first octet's
    high bits set to ``flags``."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytearray([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return out


def decode_int(data, pos: int, prefix_bits: int) -> tuple[int, int]:
    """(value, next position) of the integer whose prefix starts at ``pos``."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 28:
            raise HpackError("integer overflow")


def _encode_string(s: bytes) -> bytearray:
    out = encode_int(len(s), 7)  # H bit 0: a plain literal
    out += s
    return out


def _decode_string(data, pos: int) -> tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huffman = data[pos] & 0x80
    n, pos = decode_int(data, pos, 7)
    if n > MAX_STRING or pos + n > len(data):
        raise HpackError("string literal past the block's end")
    raw = bytes(data[pos:pos + n])
    return (huffman_decode(raw) if huffman else raw), pos + n


class _Table:
    """The dynamic table: newest entry first, evicted from the oldest."""

    def __init__(self, max_size: int = DEFAULT_TABLE_SIZE):
        self.entries: list[tuple[str, str]] = []
        self.size = 0
        self.max_size = max_size

    def add(self, name: str, value: str) -> None:
        n = len(name.encode()) + len(value.encode()) + ENTRY_OVERHEAD
        self.entries.insert(0, (name, value))
        self.size += n
        self._evict()

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.entries:
            name, value = self.entries.pop()
            self.size -= len(name.encode()) + len(value.encode()) + ENTRY_OVERHEAD

    def get(self, index: int) -> tuple[str, str]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if index < 1 or i >= len(self.entries):
            raise HpackError(f"header index {index} out of range")
        return self.entries[i]


class Decoder:
    """Decodes one connection's header blocks, in the order they came.
    ``max_table_size`` is this side's SETTINGS_HEADER_TABLE_SIZE: a size
    update above it is an error."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self.max_table_size = max_table_size
        self.table = _Table(max_table_size)

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        """The (name, value) pairs of one complete header block. Names and
        values are Latin-1 text of the wire's octets."""
        headers: list[tuple[str, str]] = []
        data = memoryview(block)
        pos, end = 0, len(data)
        allow_update = True
        while pos < end:
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = decode_int(data, pos, 7)
                if index == 0:
                    raise HpackError("header index 0")
                headers.append(self.table.get(index))
            elif b & 0xE0 == 0x20:  # dynamic table size update
                if not allow_update:
                    raise HpackError("table size update after a header field")
                size, pos = decode_int(data, pos, 5)
                if size > self.max_table_size:
                    raise HpackError(f"table size {size} above the {self.max_table_size} "
                                     "this side allows")
                self.table.resize(size)
                continue
            else:  # a literal: with incremental indexing (01), without (0000) or never (0001)
                indexing = b & 0xC0 == 0x40
                index, pos = decode_int(data, pos, 6 if indexing else 4)
                if index:
                    name = self.table.get(index)[0]
                else:
                    raw, pos = _decode_string(data, pos)
                    name = raw.decode("latin-1")
                raw, pos = _decode_string(data, pos)
                value = raw.decode("latin-1")
                headers.append((name, value))
                if indexing:
                    self.table.add(name, value)
            allow_update = False
        return headers


class Encoder:
    """Encodes this side's header blocks. ``INDEXED`` names the headers
    added to the dynamic table when first sent; every other header is a
    literal without indexing. ``set_max_table_size`` follows the peer's
    SETTINGS_HEADER_TABLE_SIZE: the next block starts with a size update."""

    INDEXED = frozenset((":status", "content-type", "grpc-status", "grpc-encoding",
                         "grpc-accept-encoding"))

    def __init__(self):
        self.table = _Table(DEFAULT_TABLE_SIZE)
        self._pending_size: int | None = None

    def set_max_table_size(self, size: int) -> None:
        if size != self.table.max_size:
            self._pending_size = size

    def encode(self, headers) -> bytes:
        out = bytearray()
        if self._pending_size is not None:
            out += encode_int(self._pending_size, 5, 0x20)
            self.table.resize(self._pending_size)
            self._pending_size = None
        for name, value in headers:
            index = _STATIC_INDEX.get((name, value))
            if index is None:
                for i, entry in enumerate(self.table.entries):
                    if entry == (name, value):
                        index = len(STATIC_TABLE) + 1 + i
                        break
            if index is not None:
                out += encode_int(index, 7, 0x80)
                continue
            name_b, value_b = name.encode("latin-1"), value.encode("latin-1")
            indexing = name in self.INDEXED and (
                len(name_b) + len(value_b) + ENTRY_OVERHEAD <= self.table.max_size)
            name_index = _STATIC_NAME.get(name, 0)
            if indexing:
                out += encode_int(name_index, 6, 0x40)
            else:
                out += encode_int(name_index, 4, 0x00)
            if not name_index:
                out += _encode_string(name_b)
            out += _encode_string(value_b)
            if indexing:
                self.table.add(name, value)
        return bytes(out)
