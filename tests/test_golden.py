"""Format-freeze golden corpus.

Committed archives of fixed inputs; any unintentional change to the
on-disk contract (format/SPEC.md) — transform text, bzip2/gzip payload,
metadata serialization, footer — trips a byte comparison.  Intentional
format changes must bump FORMAT_VERSION and rerun tests/make_golden.py.

Corpus:
  golden.starch             bzip2, 4 records, note
  golden_gzip.starch        gzip backend
  golden_multiblock.starch  3+ bzip2 blocks in one stream (level 1)
  golden_nofinal.starch     input without a trailing newline
  golden_v10.starch         metadata v1.0 (no blockBitOffsets field)
"""

import json
import os

import pytest

from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
from starch3_tpu.config import CompressionMethod, EncodeConfig
from starch3_tpu.format.archive import FOOTER_LEN, StarchReader

from tests.make_golden import GOLDEN_BED, multiblock_bed

HERE = os.path.dirname(__file__)


def _fixture(name: str) -> bytes:
    with open(os.path.join(HERE, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize(
    "name,bed,config",
    [
        ("golden.starch", GOLDEN_BED, EncodeConfig(note="golden")),
        (
            "golden_gzip.starch",
            GOLDEN_BED,
            EncodeConfig(note="golden", method=CompressionMethod.GZIP),
        ),
        (
            "golden_multiblock.starch",
            None,  # built lazily: 30k records
            EncodeConfig(note="golden", block_size_100k=1),
        ),
        ("golden_nofinal.starch", GOLDEN_BED[:-1], EncodeConfig(note="golden")),
    ],
)
def test_archive_bytes_frozen(name, bed, config):
    """Re-encoding the fixed input must reproduce the committed archive
    byte-for-byte (encode-side freeze)."""
    if bed is None:
        bed = multiblock_bed()
    assert compress_bed_bytes(bed, config) == _fixture(name)


@pytest.mark.parametrize(
    "name",
    [
        "golden.starch",
        "golden_gzip.starch",
        "golden_multiblock.starch",
        "golden_nofinal.starch",
        "golden_v10.starch",
    ],
)
def test_golden_decodes(name):
    """Every committed archive must decode to its original input
    (decode-side freeze; covers v1.0 metadata, which the encoder no
    longer produces)."""
    want = multiblock_bed() if "multiblock" in name else GOLDEN_BED
    if "nofinal" in name:
        want = want[:-1]
    assert decompress_starch_bytes(_fixture(name)) == want


def test_multiblock_fixture_really_multiblock():
    meta = StarchReader.from_bytes(_fixture("golden_multiblock.starch")).metadata
    assert len(meta.streams[0].block_bit_offsets) >= 3


def test_v10_fixture_lacks_block_offsets():
    """The v1.0 fixture must genuinely be version 1.0 (no
    block_bit_offsets anywhere); readers default the index to empty and
    decode sequentially."""
    raw = _fixture("golden_v10.starch")
    assert b"block_bit_offsets" not in raw
    foot = raw[-FOOTER_LEN:]
    meta = json.loads(raw[int(foot[:20].decode()) : -FOOTER_LEN].decode())
    assert meta["version"]["minor"] == 0
    reader = StarchReader.from_bytes(raw)
    assert reader.metadata.streams[0].block_bit_offsets == []


class TestRandomisedBlocks:
    """Legacy bzip2 <= 0.9.0 randomised-block decode parity (the one
    bzip2 behavior the reference's bundled libbz2 had that round 2
    lacked).  Fixtures are constructed from the published RAND table
    (codec/randtable.py) since no modern compressor emits them; the
    system bunzip2 binary cross-validates the fixture itself."""

    @staticmethod
    def _make_randomised_stream(data: bytes) -> bytes:
        import numpy as np

        from starch3_tpu.codec import huffman
        from starch3_tpu.codec.bitio import BitWriter
        from starch3_tpu.codec.bwt import bwt_best
        from starch3_tpu.codec.crc32 import combine_block_crc, crc32_bytes
        from starch3_tpu.codec.encoder import (
            STREAM_END_MAGIC,
            write_block_header,
        )
        from starch3_tpu.codec.mtf import mtf_rle2
        from starch3_tpu.codec.randtable import derandomize
        from starch3_tpu.codec.rle1 import rle1_split_blocks

        crc = crc32_bytes(data)
        (blk,) = rle1_split_blocks(data, 9)  # payloads fit one block
        rle = np.frombuffer(blk.data, dtype=np.uint8)
        randomised = derandomize(rle)  # involution: randomise == derandomise
        last, ptr = bwt_best(randomised)
        mtf = mtf_rle2(last)
        plan = huffman.build_plan(mtf.symbols, mtf.freq, mtf.alpha_size)
        bw = BitWriter()
        bw.write_bytes_msb(b"BZh9")
        write_block_header(
            bw, crc, ptr, mtf.in_use, plan.n_groups, plan.lengths,
            plan.selectors_mtf, randomised=True,
        )
        syms = mtf.symbols.astype(np.int64)
        gids = plan.group_ids
        bw.write_array(plan.codes[gids, syms], plan.lengths[gids, syms])
        bw.write(STREAM_END_MAGIC, 48)
        bw.write(combine_block_crc(0, crc), 32)
        return bw.getvalue()

    def _payloads(self, rng):
        from tests.conftest import make_bed_text

        return [
            b"hello randomised world\n" * 40,
            bytes(make_bed_text(rng, n=500)),
            bytes(rng.integers(0, 256, 70_000, dtype="u1").data),
        ]

    def test_python_decoder_accepts(self, rng):
        from starch3_tpu.codec.decoder import bz2_decompress

        for data in self._payloads(rng):
            stream = self._make_randomised_stream(data)
            assert bz2_decompress(stream) == data

    def test_native_decoder_accepts(self, rng):
        import pytest

        from starch3_tpu.runtime import bz2_decompress_native, get_lib

        if get_lib() is None:
            pytest.skip("native runtime unavailable")
        for data in self._payloads(rng):
            stream = self._make_randomised_stream(data)
            assert bz2_decompress_native(stream, len(data)) == data

    def test_device_decode_path_accepts(self, rng):
        from tests.conftest import skip_if_asan

        skip_if_asan()
        from starch3_tpu.parallel.pipeline import decode_streams

        data = self._payloads(rng)[1]
        stream = self._make_randomised_stream(data)
        assert decode_streams([stream]) == [data]

    def test_system_bunzip2_accepts_fixture(self, rng, tmp_path):
        """The independent consumer proves the fixture is real legacy
        bzip2 format, not something only this repo understands."""
        import shutil
        import subprocess

        import pytest

        if shutil.which("bunzip2") is None:
            pytest.skip("no system bunzip2")
        data = self._payloads(rng)[0]
        p = tmp_path / "fix.bz2"
        p.write_bytes(self._make_randomised_stream(data))
        r = subprocess.run(
            ["bunzip2", "-c", str(p)], capture_output=True, timeout=60
        )
        assert r.returncode == 0, r.stderr.decode()
        assert r.stdout == data
