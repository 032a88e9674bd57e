"""The port's zstd decoder (``tdal_torch.runtime.zstd``) against the ``zstandard``
package: every frame that ``zstandard`` writes here decodes to the bytes it was given,
at levels 1, 3 and 19, with and without the content checksum and the content size,
over f32 weights, zeros, text and random bytes, several frames and skippable frames
back to back, and a hypothesis-driven corpus. Over that corpus every literals type,
both Huffman stream counts, both Huffman tree encodings and every sequence table mode
are decoded at least once. Corrupt frames raise ``ValueError``."""

import hashlib

import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from tdal_torch.runtime import zstd

torch.set_num_threads(2)

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _corpus():
    rng = np.random.default_rng(0)
    fan_in = 3 * 3 * 64
    return {
        "f32 weights": (rng.standard_normal(120_000) * np.sqrt(2 / fan_in))
        .astype(np.float32).tobytes(),
        "zeros": bytes(300_000),
        "text": (ROOT / "ROADMAP.md").read_bytes()[:150_000],
        "random": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
    }


CORPUS = _corpus()


def _compress(data: bytes, level: int, checksum: bool) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=checksum).compress(data)


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", sorted(CORPUS))
def test_decoder_matches_zstandard(kind, level, checksum):
    data = CORPUS[kind]
    assert zstd.decompress(_compress(data, level, checksum)) == data


def test_streamed_frames_back_to_back_with_skippable_frames():
    """Frames without a content size (zstandard's stream writer, as tensorstore writes
    zarr chunks), one after another, with a skippable frame between them."""
    parts, out = [], b""
    for i, level in enumerate((1, 3, 19)):
        data = CORPUS["text"][i * 1000:(i + 1) * 40_000]
        obj = zstandard.ZstdCompressor(level=level).compressobj()
        parts.append(obj.compress(data) + obj.flush())
        out += data
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"abcde"
    assert zstd.decompress(parts[0] + skippable + parts[1] + parts[2]) == out
    assert zstd.decompress(_compress(b"", 3, True)) == b""


def test_xxh64_reference_values():
    """XXH64 of the reference implementation's test strings."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


@settings(max_examples=40, deadline=None, database=None)
@given(pieces=st.lists(st.tuples(st.binary(min_size=1, max_size=40),
                                 st.integers(1, 300)), min_size=1, max_size=25),
       level=st.sampled_from([-3, 1, 3, 9, 19]), checksum=st.booleans())
def test_decoder_property(pieces, level, checksum):
    """Repeated random pieces (matches at many offsets and lengths, literals of every
    kind) decode to themselves."""
    data = b"".join(p * n for p, n in pieces)
    assert zstd.decompress(_compress(data, level, checksum)) == data


def test_every_block_form_is_decoded(monkeypatch):
    """Over the corpus (and small inputs), the decoder meets raw, RLE, Huffman and
    treeless literals, one and four Huffman streams, FSE-coded and direct Huffman
    weights, and the predefined, RLE, FSE and repeat modes of the sequence tables."""
    seen = set()
    literals, weights, table = zstd._literals, zstd._huf_weights, zstd._seq_table

    def spy_literals(blk, state):
        seen.add(("literals", blk[0] & 3))
        if blk[0] & 3 >= 2:
            seen.add(("streams", 1 if (blk[0] >> 2) & 3 == 0 else 4))
        return literals(blk, state)

    def spy_weights(data):
        seen.add(("weights", "direct" if data[0] >= 128 else "fse"))
        return weights(data)

    def spy_table(blk, pos, mode, kind, state):
        seen.add(("mode", mode))
        return table(blk, pos, mode, kind, state)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_huf_weights", spy_weights)
    monkeypatch.setattr(zstd, "_seq_table", spy_table)
    rng = np.random.default_rng(1)
    # a second block whose unmatched bytes are all 7: RLE literals
    first = bytes(rng.integers(0, 256, 140_000, np.uint8))
    starts = rng.integers(0, 130_000, 2000)
    rle = first + b"".join(first[k:k + 60] + b"\x07" for k in starts)
    samples = [*CORPUS.values(), rle,
               bytes(rng.integers(0, 8, 5000, np.uint8)),  # 8 symbols: direct weights
               bytes(rng.integers(97, 105, 200, np.uint8)),  # one Huffman stream
               bytes(rng.integers(0, 2, 200_000, np.uint8) * 200),  # treeless literals
               b"x" * 40 + b"yz" * 30]
    for data in samples:
        for level in (1, 19):
            assert zstd.decompress(_compress(data, level, False)) == data
    want = {("literals", t) for t in range(4)} | {("streams", 1), ("streams", 4)} | \
        {("weights", "direct"), ("weights", "fse")} | {("mode", m) for m in range(4)}
    assert want <= seen, want - seen


def _flips(frame: bytes, n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = bytearray(frame)
        i = int(rng.integers(4, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        yield bytes(b)


@pytest.mark.parametrize("kind", ["f32 weights", "text"])
def test_corrupt_frames_raise(kind):
    """A bit flipped anywhere past the magic of a frame with a checksum, or a frame cut
    short, raises ValueError: the decoder never returns other bytes."""
    data = CORPUS[kind][:20_000]
    frame = _compress(data, 3, True)
    for bad in _flips(frame, 60, seed=len(kind)):
        with pytest.raises(ValueError):
            zstd.decompress(bad)
    for cut in (1, 5, 9, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])


def test_malformed_headers_raise():
    frame = _compress(b"hello world" * 20, 3, False)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + frame[1:])
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(frame[:4] + bytes([frame[4] | 0x08]) + frame[5:])
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = obj.compress(b"hello world" * 20) + obj.flush()
    assert streamed[4] & 0x23 == 0  # window descriptor, no dictionary id, no content size
    with_dict = streamed[:4] + bytes([streamed[4] | 1]) + streamed[5:6] + b"\x05" + streamed[6:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)
    with pytest.raises(ValueError, match="empty"):
        zstd.decompress(b"")
    # a frame whose content-size field disagrees with its blocks
    sized = bytearray(_compress(b"abc" * 100, 3, True))
    sized[5] ^= 1  # the low byte of the one-byte content size
    with pytest.raises(ValueError):
        zstd.decompress(bytes(sized))


def test_decoding_is_deterministic_across_block_boundaries():
    """A 1 MB stream of weights, four blocks a frame: equal to the input's digest."""
    data = (np.random.default_rng(2).standard_normal(262_144) * 0.05).astype(
        np.float32).tobytes()
    out = zstd.decompress(_compress(data, 1, False))
    assert hashlib.sha256(out).digest() == hashlib.sha256(data).digest()
