"""The port's zstd decoder (neoplanner_tpu_torch/io/zstd.py, built from
io/zstd_cc/zstd_decode.cc) against the zstandard package's encoder and
decoder: every level from -5 to 19 on random f32 bytes, text and long runs
of 0, 1, 128 KiB - 1, 128 KiB, 128 KiB + 1 and ~4 MB, with and without the
content checksum and the content size; concatenated and skippable frames;
streamed frames of many blocks; and the frames of the orbax checkpoints.
The decoder's branch counts show that the cases reach every literals,
table and block mode. A dictionary frame, a reserved bit, a flipped
checksum, a truncated or corrupted frame and a size mismatch raise
ValueError."""

import os

import numpy as np
import pytest
import zstandard

from neoplanner_tpu_torch.io import zstd
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LEVELS = (-5, 1, 3, 9, 19)
SIZES = (0, 1, 128 * 1024 - 1, 128 * 1024, 128 * 1024 + 1, 4_000_000)
KINDS = ("f32", "text", "runs")
# (checksum, content size), cycled over the cases
FLAGS = ((True, True), (False, False), (True, False), (False, True))

_DATA = {}


def _data(kind: str, size: int) -> bytes:
    """size bytes of kind, from a numpy seed."""
    if (kind, size) not in _DATA:
        rng = np.random.default_rng(KINDS.index(kind))
        if kind == "f32":        # weights-like floats: normal, scaled
            d = (rng.standard_normal(size // 4 + 1) * 0.05).astype(
                np.float32).tobytes()
        elif kind == "text":     # words from a vocabulary, some numbers
            vocab = [bytes(rng.integers(97, 123, rng.integers(1, 10)))
                     for _ in range(400)] + [b"%d" % k for k in range(100)]
            words = rng.choice(len(vocab), size // 3 + 8)
            d = b" ".join(vocab[w] for w in words)
        else:                    # long runs of random bytes
            parts, n = [], 0
            while n <= size:
                run = bytes([int(rng.integers(256))]) * int(
                    rng.integers(1, 3000))
                parts.append(run)
                n += len(run)
            d = b"".join(parts)
        _DATA[(kind, size)] = d[:size]
    return _DATA[(kind, size)]


CASES = [(lv, sz, kd) for lv in LEVELS for sz in SIZES for kd in KINDS]


@pytest.mark.parametrize("level,size,kind", CASES,
                         ids=[f"l{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_matches_zstandard(level, size, kind):
    checksum, content_size = FLAGS[CASES.index((level, size, kind)) % 4]
    data = _data(kind, size)
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_streamed_frame_of_many_blocks(checksum, content_size):
    """A frame written in 7 KiB pieces with flushes between them: many
    small blocks whose matches reach into earlier blocks, its tables and
    repeat offsets carried from block to block."""
    data = _data("text", 600_000)
    cctx = zstandard.ZstdCompressor(level=7, write_checksum=checksum,
                                    write_content_size=content_size)
    cobj = cctx.compressobj(size=len(data) if content_size else -1)
    parts = []
    for i in range(0, len(data), 7 * 1024):
        parts.append(cobj.compress(data[i:i + 7 * 1024]))
        parts.append(cobj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK))
    parts.append(cobj.flush())
    frame = b"".join(parts)
    zstd.branch_counts(reset=True)
    assert zstd.decompress(frame) == data
    seen = zstd.branch_counts()
    assert seen["match_into_earlier_block"] > 0
    assert seen["repeat_table"] > 0 and seen["treeless_literals"] > 0


def test_concatenated_and_skippable_frames():
    a, b = _data("text", 50_000), _data("f32", 70_000)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    data = (zstandard.ZstdCompressor(level=3).compress(a) + skip
            + zstandard.ZstdCompressor(level=1, write_checksum=True)
            .compress(b) + skip)
    zstd.branch_counts(reset=True)
    assert zstd.decompress(data, len(a) + len(b)) == a + b
    assert zstd.branch_counts()["skippable_frame"] == 2


def _special():
    """(data, level) that reach the rarer branches: an RLE block and RLE
    sequence tables (one byte repeated), raw blocks (random bytes), RLE
    literals (128 KiB of random bytes, then 3000 copies of 40-byte pieces
    of them, each after a zero byte: every literal of the later blocks is
    that zero), 4-bit Huffman weights and a single Huffman stream (300
    bytes of an 8-symbol alphabet)."""
    rng = np.random.default_rng(7)
    base = rng.bytes(128 * 1024)
    pieces = b"".join(b"\x00" + base[o:o + 40]
                      for o in rng.integers(1, len(base) - 64, 3000))
    p = np.arange(1, 9, dtype=float) ** 2
    return ((b"\x07" * 300_000, 3),
            (np.random.default_rng(4).bytes(200_000), 3),
            (base + pieces, 19),
            (bytes(np.random.default_rng(6).choice(
                8, 300, p=p / p.sum()).astype(np.uint8)), 3))


@pytest.mark.parametrize("index", range(4))
def test_special_inputs(index):
    data, _ = _special()[index]
    for level in LEVELS:
        frame = zstandard.ZstdCompressor(level=level).compress(data)
        assert zstd.decompress(frame, len(data)) == data


def test_cases_reach_every_branch():
    """Every literals mode, table mode, block type, Huffman weight header,
    repeat offset kind and frame flag of the format is decoded by the
    cases of this file (counted by the decoder)."""
    zstd.branch_counts(reset=True)
    for level, size, kind in CASES:
        if size in (1, 128 * 1024, 4_000_000) or level in (-5, 19):
            checksum, content_size = FLAGS[
                CASES.index((level, size, kind)) % 4]
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=checksum,
                write_content_size=content_size).compress(
                _data(kind, size))
            zstd.decompress(frame)
    for data, level in _special():
        zstd.decompress(zstandard.ZstdCompressor(level=level).compress(data))
    seen = zstd.branch_counts()
    missing = sorted(k for k, v in seen.items()
                     if v == 0 and k != "skippable_frame")
    assert not missing, f"branches no case reached: {missing}"


def test_checkpoint_frames():
    """The zarr chunks of the committed smallconv checkpoint (frames
    without a content size, read through the OCDBT store) decode to the
    arrays' byte sizes, as zstandard decodes them."""
    from neoplanner_tpu_torch.io import ocdbt
    store = ocdbt.OcdbtStore(os.path.join(ROOT, "artifacts",
                                          "planner_net_smallconv"))
    n = 0
    for key in store.list():
        if key.endswith(b".zarray"):
            continue
        raw = store.read(key)
        want = zstandard.ZstdDecompressor().decompressobj().decompress(raw)
        assert zstd.decompress(raw) == want
        n += 1
    assert n == 26


def _frame(data=b"abc" * 1000, **kw) -> bytearray:
    return bytearray(zstandard.ZstdCompressor(level=3, **kw).compress(data))


def test_dictionary_frame_raises():
    samples = [_data("text", 2000)[i * 40:] for i in range(40)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(
        _data("text", 5000))
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


def test_flipped_checksum_raises():
    frame = _frame(write_checksum=True)
    frame[-1] ^= 0x10
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_reserved_bit_raises():
    frame = _frame()
    frame[4] |= 0x08
    with pytest.raises(ValueError, match="reserved"):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("cut", [1, 5, 20])
def test_truncated_frame_raises(cut):
    frame = _frame(_data("text", 20_000))
    with pytest.raises(ValueError):
        zstd.decompress(bytes(frame[:-cut]))


def test_corrupt_streams_raise():
    """Every single-bit flip past the header of a checksummed frame either
    raises or is caught by the checksum: none returns other bytes."""
    data = _data("text", 3000)
    frame = _frame(data, write_checksum=True)
    for pos in range(6, len(frame) - 4):
        bad = bytearray(frame)
        bad[pos] ^= 1 << (pos % 8)
        try:
            out = zstd.decompress(bytes(bad))
        except ValueError:
            continue
        assert out == data, pos


def test_size_mismatch_and_bad_input_raise():
    data = _data("f32", 10_000)
    frame = bytes(_frame(data, write_content_size=False))
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress(frame, len(data) + 1)
    with pytest.raises(ValueError):
        zstd.decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(ValueError):
        zstd.decompress(b"")
