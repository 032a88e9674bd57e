"""A Zstandard frame decoder (RFC 8878) in Python and numpy.

It reads what ``tdal``'s checkpoints hold twice over (OCDBT's b-tree nodes and zarr's
chunks are both zstd frames) on a machine without the ``zstandard`` package. It covers
the whole frame format except dictionaries: raw, RLE and compressed blocks; literals of
all four types with one or four Huffman streams; sequences in the predefined, RLE,
FSE-compressed and repeat modes; the three repeat offsets; the window and the frame
content size; frames back to back and skippable frames; and the content checksum (the
low 32 bits of XXH64). Corrupt input raises ``ValueError``.

The Huffman-coded literals are nearly every byte of a weight file. They are decoded
with numpy: each bit position of a stream gets the symbol and code length that a
decoder standing there would read (one table lookup over a sliding window of the
stream's bits), and the chain of positions the decoder actually visits is followed by
pointer doubling: jumps of ``_STRIDE`` codes are composed over the whole stream, a short
Python loop walks the stream in such jumps, and the codes between are filled in by
``_STRIDE`` vectorised steps. Sequences and FSE tables are decoded in plain Python.

``decompress(data)`` returns the concatenated content of every frame in ``data``.
"""

from __future__ import annotations

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
_SKIPPABLE_LO, _SKIPPABLE_HI = 0x184D2A50, 0x184D2A5F
_BLOCK_MAX = 1 << 17
_HUF_MAX_BITS = 11
_STRIDE = 16  # codes per doubling jump in the Huffman chain

# Literal length and match length codes (RFC 8878 3.1.1.3.2.1.1).
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# Predefined distributions (RFC 8878 3.1.1.3.2.2).
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of the three code tables.
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (35, 9), (31, 8), (52, 9)


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, in order; skippable frames are
    passed over. Raises ``ValueError`` on anything that is not a valid frame."""
    buf = bytes(data)
    if not buf:
        raise ValueError("zstd: empty input")
    out, pos = [], 0
    while pos < len(buf):
        magic = int.from_bytes(_take(buf, pos, 4), "little")
        if _SKIPPABLE_LO <= magic <= _SKIPPABLE_HI:
            size = int.from_bytes(_take(buf, pos + 4, 4), "little")
            _take(buf, pos + 8, size)
            pos += 8 + size
            continue
        if magic != ZSTD_MAGIC:
            raise ValueError(f"zstd: bad frame magic {magic:#010x} at byte {pos}")
        content, pos = _frame(buf, pos + 4)
        out.append(content)
    return b"".join(out)


def _take(buf, pos: int, n: int):
    if n < 0 or pos + n > len(buf):
        raise ValueError("zstd: input ends inside a frame")
    return buf[pos:pos + n]


class _FrameState:
    """What a frame's blocks hand on to the next: the Huffman table, the three
    sequence tables and the repeat offsets."""

    def __init__(self):
        self.huf = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _frame(buf: bytes, pos: int):
    desc = _take(buf, pos, 1)[0]
    pos += 1
    fcs_flag, single, checksum, did_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    if desc & 0x08:
        raise ValueError("zstd: reserved bit set in the frame header")
    window = None
    if not single:
        wd = _take(buf, pos, 1)[0]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    if int.from_bytes(_take(buf, pos, did_size), "little"):
        raise ValueError("zstd: frames that need a dictionary are not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(_take(buf, pos, fcs_size), "little") + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    if single:
        window = fcs
    limit = min(window, _BLOCK_MAX)
    state, out = _FrameState(), bytearray()
    while True:
        hdr = int.from_bytes(_take(buf, pos, 3), "little")
        pos += 3
        last, btype, bsize = hdr & 1, (hdr >> 1) & 3, hdr >> 3
        if btype == 3:
            raise ValueError("zstd: reserved block type")
        if bsize > limit:
            raise ValueError(f"zstd: block of {bsize} bytes exceeds the limit {limit}")
        if btype == 0:
            out += _take(buf, pos, bsize)
            pos += bsize
        elif btype == 1:
            out += _take(buf, pos, 1) * bsize
            pos += 1
        else:
            before = len(out)
            _compressed_block(_take(buf, pos, bsize), out, state, window)
            if len(out) - before > limit:
                raise ValueError("zstd: block decodes to more than the block limit")
            pos += bsize
        if fcs is not None and len(out) > fcs:
            raise ValueError("zstd: frame decodes to more than its content size")
        if last:
            break
    if fcs is not None and len(out) != fcs:
        raise ValueError(f"zstd: frame decodes to {len(out)} bytes, header says {fcs}")
    if checksum:
        want = int.from_bytes(_take(buf, pos, 4), "little")
        pos += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
    return bytes(out), pos


# -- bit readers ---------------------------------------------------------------------


class _BackBits:
    """zstd's backward bit stream: the last byte's highest set bit marks the end, and
    bits are read from there towards the first byte. Reading past the first byte
    yields zeros and sets ``overflow``."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: bit stream lacks its end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    @property
    def overflow(self) -> bool:
        return self.pos < 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo >= 0:
            chunk = int.from_bytes(self.data[lo >> 3:(lo + n + 7) >> 3], "little")
            return (chunk >> (lo & 7)) & ((1 << n) - 1)
        if lo + n <= 0:
            return 0
        chunk = int.from_bytes(self.data[:(lo + n + 7) >> 3], "little")
        return (chunk << -lo) & ((1 << n) - 1)


# -- FSE -------------------------------------------------------------------------------


def _fse_read_ncount(data: bytes, max_symbol: int, max_log: int):
    """An FSE table description (RFC 8878 4.1.1): (probabilities, accuracy log, bytes
    read)."""
    head = data[:512]
    bits = int.from_bytes(head, "little")
    avail = 8 * len(head)
    if avail < 4:
        raise ValueError("zstd: truncated FSE table description")
    log = (bits & 0xF) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} exceeds {max_log}")
    pos = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    probs = []
    prev_zero = False
    while remaining > 1:
        if prev_zero:
            while True:
                rep = (bits >> pos) & 3
                pos += 2
                probs.extend([0] * rep)
                if rep != 3:
                    break
            if len(probs) > max_symbol + 1:
                raise ValueError("zstd: FSE table has too many symbols")
            if pos > avail:
                raise ValueError("zstd: truncated FSE table description")
        mx = (2 * threshold - 1) - remaining
        v = (bits >> pos) & (threshold - 1)
        if v < mx:
            count = v
            pos += nbits - 1
        else:
            count = (bits >> pos) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            pos += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        prev_zero = count == 0
        if len(probs) > max_symbol + 1 or remaining < 1 or pos > avail:
            raise ValueError("zstd: corrupt FSE table description")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("zstd: corrupt FSE table description")
    return probs, log, (pos + 7) >> 3


def _fse_table(probs, log: int):
    """Decoding table (symbol, bits, base) lists of size 2**log (RFC 8878 4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(p)
    step = (size >> 1) + (size >> 3) + 3
    mask, pos = size - 1, 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: corrupt FSE distribution")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return sym, nb, base, log


_PREDEFINED = {}


def _predefined(kind: str):
    if kind not in _PREDEFINED:
        probs, log = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT, "ml": _ML_DEFAULT}[kind]
        _PREDEFINED[kind] = _fse_table(probs, log)
    return _PREDEFINED[kind]


# -- Huffman ---------------------------------------------------------------------------


def _huf_weights(data: bytes):
    """Huffman tree description (RFC 8878 4.2.1): (listed weights, bytes read)."""
    head = data[0]
    if head >= 128:
        n = head - 127
        raw = _take(data, 1, (n + 1) // 2)
        weights = [(raw[i // 2] >> 4) if i % 2 == 0 else (raw[i // 2] & 15) for i in range(n)]
        return weights, 1 + (n + 1) // 2
    comp = _take(data, 1, head)
    probs, log, used = _fse_read_ncount(comp, 255, 6)
    sym, nb, base, _ = _fse_table(probs, log)
    bits = _BackBits(comp[used:])
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.overflow:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.overflow:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ValueError("zstd: too many Huffman weights")
    if len(weights) > 255:
        raise ValueError("zstd: too many Huffman weights")
    return weights, 1 + head


def _huf_table(data: bytes):
    """((symbol, code length) lookup arrays of size 2**max_bits, max_bits), bytes
    read."""
    weights, used = _huf_weights(data)
    if any(w > _HUF_MAX_BITS for w in weights):
        raise ValueError("zstd: Huffman weight out of range")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > _HUF_MAX_BITS or rest & (rest - 1):
        raise ValueError("zstd: corrupt Huffman tree")
    weights = weights + [rest.bit_length()]
    counts = [0] * (max_bits + 1)
    for w in weights:
        counts[w] += 1
    if counts[1] < 2 or counts[1] & 1:
        raise ValueError("zstd: corrupt Huffman tree")
    start, pos = [0] * (max_bits + 1), 0
    for w in range(1, max_bits + 1):
        start[w] = pos
        pos += counts[w] << (w - 1)
    sym = np.zeros(1 << max_bits, np.uint8)
    nb = np.zeros(1 << max_bits, np.uint8)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            sym[start[w]:start[w] + n] = s
            nb[start[w]:start[w] + n] = max_bits + 1 - w
            start[w] += n
    return (sym, nb, max_bits), used


def _huf_stream(src: bytes, n: int, table) -> np.ndarray:
    """Decode ``n`` symbols from one backward Huffman stream, vectorised (see the
    module docstring)."""
    sym_tab, nb_tab, max_bits = table
    if not src or src[-1] == 0:
        raise ValueError("zstd: Huffman stream lacks its end marker")
    total = 8 * (len(src) - 1) + src[-1].bit_length() - 1
    if n == 0:
        if total:
            raise ValueError("zstd: Huffman stream has bits left over")
        return np.zeros(0, np.uint8)
    # window[p] = the max_bits stream bits just below bit position p (zeros below 0),
    # built a byte at a time for each of the 8 bit offsets
    pad = np.zeros(len(src) + 5, np.uint32)
    pad[2:2 + len(src)] = np.frombuffer(src, np.uint8)
    words = pad[:-2] | (pad[1:-1] << 8) | (pad[2:] << 16)
    by_offset = np.empty((len(words), 8), np.uint16)
    for r in range(8):
        by_offset[:, r] = (words >> r) & ((1 << max_bits) - 1)
    # intp indices throughout: numpy gathers fastest with np.take on its own index type
    window = by_offset.reshape(-1)[16 - max_bits:16 - max_bits + total + 1].astype(np.intp)
    nbits = np.take(nb_tab, window)
    # the position after the code read at p; below 0 only off the path or in a corrupt
    # stream (checked on the path below), where numpy's negative indices stay in range
    nxt = np.arange(total + 1, dtype=np.intp) - nbits
    jump = nxt
    for _ in range(_STRIDE.bit_length() - 1):
        jump = np.take(jump, jump)
    starts = [total]
    p = total
    for _ in range((n - 1) // _STRIDE):
        p = int(jump[p])
        starts.append(p)
    path = np.empty((_STRIDE, len(starts)), np.intp)
    path[0] = starts
    for t in range(1, _STRIDE):
        np.take(nxt, path[t - 1], out=path[t])
    path = path.T.reshape(-1)[:n]
    if path.min() <= 0 or (np.take(nbits, path) > path).any() or nxt[path[-1]] != 0:
        raise ValueError("zstd: corrupt Huffman stream")
    return np.take(sym_tab, np.take(window, path))


def _literals(blk: bytes, state: _FrameState):
    """The literals section of a compressed block: (literals, bytes read)."""
    b0 = blk[0]
    ltype, sf = b0 & 3, (b0 >> 2) & 3
    if ltype in (0, 1):
        if sf in (0, 2):
            regen, hl = b0 >> 3, 1
        elif sf == 1:
            regen, hl = (b0 >> 4) + (_take(blk, 1, 1)[0] << 4), 2
        else:
            h = _take(blk, 1, 2)
            regen, hl = (b0 >> 4) + (h[0] << 4) + (h[1] << 12), 3
        if regen > _BLOCK_MAX:
            raise ValueError("zstd: literals exceed the block limit")
        if ltype == 0:
            return _take(blk, hl, regen), hl + regen
        return _take(blk, hl, 1) * regen, hl + 1
    if sf < 2:
        h = int.from_bytes(_take(blk, 0, 3), "little")
        regen, comp, hl = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, 3
    elif sf == 2:
        h = int.from_bytes(_take(blk, 0, 4), "little")
        regen, comp, hl = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF, 4
    else:
        h = int.from_bytes(_take(blk, 0, 5), "little")
        regen, comp, hl = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF, 5
    if regen > _BLOCK_MAX:
        raise ValueError("zstd: literals exceed the block limit")
    data = _take(blk, hl, comp)
    if ltype == 2:
        if not data:
            raise ValueError("zstd: missing Huffman tree description")
        state.huf, used = _huf_table(data)
        data = data[used:]
    elif state.huf is None:
        raise ValueError("zstd: treeless literals without an earlier Huffman table")
    if sf == 0:
        lits = _huf_stream(data, regen, state.huf)
    else:
        jt = _take(data, 0, 6)
        sizes = [int.from_bytes(jt[i:i + 2], "little") for i in (0, 2, 4)]
        sizes.append(len(data) - 6 - sum(sizes))
        seg = (regen + 3) // 4
        counts = [seg, seg, seg, regen - 3 * seg]
        if sizes[3] < 0 or counts[3] < 0:
            raise ValueError("zstd: corrupt Huffman jump table")
        parts, pos = [], 6
        for size, count in zip(sizes, counts):
            parts.append(_huf_stream(data[pos:pos + size], count, state.huf))
            pos += size
        lits = np.concatenate(parts)
    return lits.tobytes(), hl + comp


# -- sequences -------------------------------------------------------------------------


def _seq_table(blk: bytes, pos: int, mode: int, kind: str, state: _FrameState):
    max_symbol, max_log = {"ll": _LL_LIMITS, "of": _OF_LIMITS, "ml": _ML_LIMITS}[kind]
    if mode == 0:
        table = _predefined(kind)
    elif mode == 1:
        s = _take(blk, pos, 1)[0]
        if s > max_symbol:
            raise ValueError(f"zstd: RLE {kind} code {s} out of range")
        table, pos = ([s], [0], [0], 0), pos + 1
    elif mode == 2:
        probs, log, used = _fse_read_ncount(blk[pos:], max_symbol, max_log)
        table, pos = _fse_table(probs, log), pos + used
    else:
        table = state.tables[kind]
        if table is None:
            raise ValueError(f"zstd: repeat mode for the {kind} table without an earlier one")
    state.tables[kind] = table
    return table, pos


def _compressed_block(blk: bytes, out: bytearray, state: _FrameState, window: int):
    if not blk:
        raise ValueError("zstd: empty compressed block")
    lits, pos = _literals(blk, state)
    b0 = _take(blk, pos, 1)[0]
    if b0 == 0:
        if pos + 1 != len(blk):
            raise ValueError("zstd: bytes after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + _take(blk, pos + 1, 1)[0], pos + 2
    else:
        b = _take(blk, pos + 1, 2)
        nseq, pos = b[0] + (b[1] << 8) + 0x7F00, pos + 3
    modes = _take(blk, pos, 1)[0]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the compression modes")
    (ll_sym, ll_nb, ll_base, ll_log), pos = _seq_table(blk, pos, modes >> 6, "ll", state)
    (of_sym, of_nb, of_base, of_log), pos = _seq_table(blk, pos, (modes >> 4) & 3, "of", state)
    (ml_sym, ml_nb, ml_base, ml_log), pos = _seq_table(blk, pos, (modes >> 2) & 3, "ml", state)
    bits = _BackBits(blk[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = state.rep
    lp, nlits = 0, len(lits)
    for i in range(nseq):
        llc, ofc, mlc = ll_sym[ll_s], of_sym[of_s], ml_sym[ml_s]
        if ofc > 31:
            raise ValueError("zstd: offset code out of range")
        ofv = (1 << ofc) + read(ofc)
        ml = _ML_BASE[mlc] + read(_ML_BITS[mlc])
        ll = _LL_BASE[llc] + read(_LL_BITS[llc])
        if ofv > 3:
            off = ofv - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            elif idx == 1:
                off = rep[1]
                rep = [off, rep[0], rep[2]]
            elif idx == 2:
                off = rep[2]
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[0] - 1
                rep = [off, rep[0], rep[1]]
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if bits.overflow:
            raise ValueError("zstd: sequences bit stream overrun")
        if lp + ll > nlits:
            raise ValueError("zstd: sequence reads past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        if off == 0 or off > len(out) or off > window:
            raise ValueError(f"zstd: match offset {off} out of range")
        if off >= ml:
            start = len(out) - off
            out += out[start:start + ml]
        else:
            pattern = out[-off:]
            out += (pattern * (ml // off + 1))[:ml]
    if bits.pos != 0:
        raise ValueError("zstd: sequences bit stream has bits left over")
    state.rep = rep
    out += lits[lp:]


# -- XXH64 -----------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash whose low 32 bits are zstd's content checksum)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        nstripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=nstripes * 4).tolist()
        for i in range(0, 4 * nstripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        pos = nstripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= data[pos] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        pos += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
