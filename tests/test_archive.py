"""Archive format + end-to-end pipeline tests (SURVEY.md §4 golden-format)."""

import bz2

import numpy as np

import pytest

from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes, list_chromosomes
from starch3_tpu.config import CompressionMethod, EncodeConfig
from starch3_tpu.errors import FormatError
from starch3_tpu.format.archive import (
    ARCHIVE_MAGIC,
    FOOTER_LEN,
    StarchReader,
    StarchWriter,
)

from tests.conftest import make_bed_text


class TestArchiveContainer:
    def test_magic_bytes(self):
        # must match the reference header exactly (starch3api.hpp:907-910)
        assert ARCHIVE_MAGIC == bytes([0xCA, 0x5C, 0xAD, 0x1A])
        w = StarchWriter()
        data = w.finish()
        assert data[:4] == ARCHIVE_MAGIC
        assert data[-4:] == ARCHIVE_MAGIC

    def test_metadata_roundtrip(self):
        w = StarchWriter(note="hello world")
        w.add_stream(
            "chr1", b"STREAMBYTES",
            uncompressed_size=100, line_count=5,
            base_count_nonunique=50, base_count_unique=40,
        )
        r = StarchReader.from_bytes(w.finish())
        assert r.metadata.note == "hello world"
        s = r.metadata.streams[0]
        assert (s.chromosome, s.size, s.line_count) == ("chr1", 11, 5)
        assert r.stream_bytes("chr1") == b"STREAMBYTES"

    def test_corrupt_metadata_detected(self):
        w = StarchWriter()
        w.add_stream(
            "chr1", b"x", uncompressed_size=1, line_count=1,
            base_count_nonunique=1, base_count_unique=1,
        )
        data = bytearray(w.finish())
        data[-FOOTER_LEN - 2] ^= 0xFF  # flip a metadata byte
        with pytest.raises(FormatError):
            StarchReader.from_bytes(bytes(data))

    def test_bad_magic_rejected(self):
        with pytest.raises(FormatError):
            StarchReader.from_bytes(b"nope" + b"\x00" * 200)


class TestEndToEnd:
    def test_roundtrip_3col(self, rng):
        bed = make_bed_text(rng, n=5000)
        archive = compress_bed_bytes(bed)
        assert decompress_starch_bytes(archive) == bed

    def test_roundtrip_remainder(self, rng):
        bed = make_bed_text(rng, n=5000, with_remainder=True)
        archive = compress_bed_bytes(bed)
        assert decompress_starch_bytes(archive) == bed

    def test_streams_are_plain_bzip2(self, rng):
        # each chromosome stream must be an independent, complete bzip2
        # stream (consumable by any bzip2 tool)
        bed = make_bed_text(rng, n=3000, chroms=("chr1", "chr2"))
        reader = StarchReader.from_bytes(compress_bed_bytes(bed))
        for meta, stream in reader.iter_streams():
            assert stream[:3] == b"BZh"
            assert len(bz2.decompress(stream)) == meta.uncompressed_size

    def test_gzip_backend(self, rng):
        bed = make_bed_text(rng, n=2000)
        cfg = EncodeConfig(method=CompressionMethod.GZIP)
        archive = compress_bed_bytes(bed, cfg)
        assert decompress_starch_bytes(archive) == bed

    def test_determinism(self, rng):
        bed = make_bed_text(rng, n=2000)
        assert compress_bed_bytes(bed) == compress_bed_bytes(bed)

    def test_gzip_multi_member_streams(self, rng):
        """Large gzip streams are written as concatenated independent
        members with the boundaries in the metadata block index
        (format/SPEC.md): standard tools still decode them, and the
        member-parallel decode path reproduces the input."""
        import gzip as gzip_mod

        bed = make_bed_text(rng, n=4000, chroms=("chr1", "chr2"))
        cfg = EncodeConfig(
            method=CompressionMethod.GZIP, gzip_segment_bytes=1024
        )
        archive = compress_bed_bytes(bed, cfg)
        reader = StarchReader.from_bytes(archive)
        for meta, stream in reader.iter_streams():
            offs = meta.block_bit_offsets
            assert len(offs) > 1  # genuinely segmented
            assert offs[0] == 0 and all(o % 8 == 0 for o in offs)
            # an independent consumer (stdlib gzip) decodes the whole
            # multi-member concatenation transparently
            assert len(gzip_mod.decompress(stream)) == meta.uncompressed_size
            # each indexed slice is a self-contained member
            bounds = [o // 8 for o in offs] + [len(stream)]
            parts = [
                gzip_mod.decompress(stream[bounds[k] : bounds[k + 1]])
                for k in range(len(offs))
            ]
            assert sum(len(p) for p in parts) == meta.uncompressed_size
        # serial (workers=1) and member-parallel (workers=4) decodes agree
        assert decompress_starch_bytes(archive, workers=1) == bed
        assert decompress_starch_bytes(archive, workers=4) == bed

    def test_gzip_many_member_serial_decode(self, rng):
        """The serial (index-free) decoder walks hundreds of members via
        bounded chunk feeding — including members far smaller than the
        feed chunk (carry path) — and matches the input."""
        from starch3_tpu.api import _decompress_stream, _gzip_members
        from starch3_tpu.config import EncodeConfig as EC

        text = bytes(rng.integers(32, 127, 200_000, dtype="u1").data)
        cfg = EC(method=CompressionMethod.GZIP, gzip_segment_bytes=512)
        stream, offs = _gzip_members(text, cfg)
        assert len(offs) == (len(text) + 511) // 512
        assert _decompress_stream(stream, "gzip") == text
        # corrupting a middle member surfaces as FormatError, not garbage
        bad = bytearray(stream)
        bad[len(stream) // 2] ^= 0xFF
        with pytest.raises(FormatError):
            _decompress_stream(bytes(bad), "gzip")

    def test_gzip_empty_stream_is_corruption(self):
        """A zero-length gzip stream is corruption, not empty text: the
        encoder emits a ~20-byte member even for empty input
        (_gzip_members), so b'' must fail like any truncated member."""
        from starch3_tpu.api import _decompress_stream, _gzip_members
        from starch3_tpu.config import EncodeConfig as EC

        cfg = EC(method=CompressionMethod.GZIP)
        stream, _offs = _gzip_members(b"", cfg)
        assert len(stream) > 0
        assert _decompress_stream(stream, "gzip") == b""
        with pytest.raises(FormatError):
            _decompress_stream(b"", "gzip")

    def test_gzip_small_stream_stays_single_member(self, rng):
        """At or under one segment the stream is one member with no
        index — byte-compatible with pre-index archives (the
        golden_gzip fixture freezes the whole archive)."""
        bed = make_bed_text(rng, n=50)
        archive = compress_bed_bytes(
            bed, EncodeConfig(method=CompressionMethod.GZIP)
        )
        meta = StarchReader.from_bytes(archive).metadata.streams[0]
        assert meta.block_bit_offsets == []

    def test_gzip_random_access_on_segmented_archive(self, rng):
        from starch3_tpu.api import extract_chromosome

        bed = make_bed_text(rng, n=3000, chroms=("chr1", "chr2", "chr3"))
        cfg = EncodeConfig(
            method=CompressionMethod.GZIP, gzip_segment_bytes=2048
        )
        archive = compress_bed_bytes(bed, cfg)
        joined = b"".join(
            extract_chromosome(archive, c) for c in ("chr1", "chr2", "chr3")
        )
        assert joined == bed

    def test_gzip_streaming_encode_identical(self, tmp_path, rng):
        import io

        from starch3_tpu.api import compress_bed_file

        bed = make_bed_text(rng, n=4000, chroms=("chr1", "chr2"))
        cfg = EncodeConfig(
            method=CompressionMethod.GZIP, gzip_segment_bytes=1024
        )
        p = tmp_path / "in.bed"
        p.write_bytes(bed)
        out = io.BytesIO()
        compress_bed_file(str(p), out, cfg)
        assert out.getvalue() == compress_bed_bytes(bed, cfg)

    def test_note_in_metadata(self, rng):
        bed = make_bed_text(rng, n=100)
        archive = compress_bed_bytes(bed, EncodeConfig(note="my note"))
        assert StarchReader.from_bytes(archive).metadata.note == "my note"

    def test_list(self, rng):
        bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2", "chr3"))
        rows = list_chromosomes(compress_bed_bytes(bed))
        assert [r["chromosome"] for r in rows] == ["chr1", "chr2", "chr3"]
        assert all(r["lineCount"] == 300 for r in rows)

    def test_empty_input(self):
        archive = compress_bed_bytes(b"")
        assert decompress_starch_bytes(archive) == b""


class TestStreamingFileEncode:
    def test_identical_to_bytes_api(self, tmp_path, rng):
        import io

        from starch3_tpu.api import compress_bed_bytes, compress_bed_file

        parts = []
        for c in ["chr1", "chr10", "chr2"]:
            n = int(rng.integers(200, 2000))
            starts = np.cumsum(rng.integers(1, 400, n))
            parts.append(
                b"".join(
                    b"%s\t%d\t%d\n" % (c.encode(), s, s + int(l))
                    for s, l in zip(starts.tolist(), rng.integers(1, 200, n).tolist())
                )
            )
        bed = b"".join(parts)
        p = tmp_path / "in.bed"
        p.write_bytes(bed)
        want = compress_bed_bytes(bed)
        for chunk in (1 << 12, 1 << 16, 1 << 24):
            fh = io.BytesIO()
            compress_bed_file(str(p), fh, chunk_bytes=chunk)
            assert fh.getvalue() == want

    def test_non_contiguous_raises(self, tmp_path):
        import io

        import pytest

        from starch3_tpu.api import compress_bed_file
        from starch3_tpu.errors import BedParseError

        p = tmp_path / "bad.bed"
        p.write_bytes(b"chr1\t1\t2\nchr2\t1\t2\nchr1\t5\t9\n")
        with pytest.raises(BedParseError):
            compress_bed_file(str(p), io.BytesIO(), chunk_bytes=8)


def test_no_trailing_newline_roundtrip():
    """Inputs whose final line lacks a newline must round-trip
    byte-exactly (metadata finalNewline flag); newline-terminated
    archives are byte-unchanged by the flag (omitted when True)."""
    import io

    from starch3_tpu.api import (
        compress_bed_bytes,
        compress_bed_file,
        decompress_starch_bytes,
        decompress_starch_file,
    )

    bed_nl = b"chr1\t1\t5\nchr2\t9\t12\n"
    bed_no = bed_nl[:-1]
    a_nl = compress_bed_bytes(bed_nl)
    a_no = compress_bed_bytes(bed_no)
    assert decompress_starch_bytes(a_nl) == bed_nl
    assert decompress_starch_bytes(a_no) == bed_no
    assert decompress_starch_bytes(a_no, workers=1) == bed_no
    assert b'"finalNewline":false' in a_no and b"finalNewline" not in a_nl


def test_no_trailing_newline_streaming(tmp_path):
    import io

    from starch3_tpu.api import (
        compress_bed_bytes,
        compress_bed_file,
        decompress_starch_file,
    )

    bed = b"chr1\t1\t5\nchr2\t9\t12"
    p = tmp_path / "in.bed"
    p.write_bytes(bed)
    fh = io.BytesIO()
    compress_bed_file(str(p), fh, chunk_bytes=7)
    assert fh.getvalue() == compress_bed_bytes(bed)
    ap = tmp_path / "a.starch"
    ap.write_bytes(fh.getvalue())
    out = io.BytesIO()
    decompress_starch_file(str(ap), out)
    assert out.getvalue() == bed


class TestStreamingJaxQueue:
    def test_use_jax_streams_through_device_queue(self, tmp_path, rng):
        """compress_bed_file(use_jax=True) must NOT fall back to a
        whole-file read: chromosomes flush
        through the shared device queue in bounded windows, and the
        archive is byte-identical to the bytes API either way."""
        from tests.conftest import skip_if_asan

        skip_if_asan()
        import io

        from starch3_tpu.api import compress_bed_bytes, compress_bed_file
        from starch3_tpu.config import EncodeConfig

        parts = []
        for c in ["chr1", "chr2", "chr3", "chrX"]:
            n = int(rng.integers(300, 1500))
            starts = np.cumsum(rng.integers(1, 400, n))
            parts.append(
                b"".join(
                    b"%s\t%d\t%d\n" % (c.encode(), s, s + int(l))
                    for s, l in zip(starts.tolist(), rng.integers(1, 200, n).tolist())
                )
            )
        bed = b"".join(parts)
        p = tmp_path / "in.bed"
        p.write_bytes(bed)
        want = compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        fh = io.BytesIO()
        compress_bed_file(str(p), fh, EncodeConfig(use_jax=True), chunk_bytes=1 << 14)
        assert fh.getvalue() == want


@pytest.mark.slow
class TestGigabyteScale:
    """BASELINE configs 4-5 regime: a >= 1 GB corpus through the
    streaming encode/decode paths with bounded memory.  Both the generator AND the encode/decode run in
    SUBPROCESSES so peak-RSS measures only the product paths — immune
    to whatever earlier tests inflated this process's ru_maxrss to."""

    GEN = r'''
import hashlib, sys
import numpy as np
out, target = sys.argv[1], int(sys.argv[2])
gen = np.random.default_rng(11)
digest = hashlib.sha256()
written = 0
n_per = 2_000_000
with open(out, "wb") as f:
    c = 0
    while written < target:
        c += 1
        name = f"chr{c}".encode()
        starts = 10_000 + np.cumsum(gen.integers(1, 1500, n_per))
        lens = gen.integers(20, 400, n_per)
        for lo in range(0, n_per, 250_000):
            s_sl = starts[lo : lo + 250_000].tolist()
            l_sl = lens[lo : lo + 250_000].tolist()
            chunk = b"\n".join(
                name + b"\t%d\t%d" % (s, s + l) for s, l in zip(s_sl, l_sl)
            ) + b"\n"
            f.write(chunk)
            digest.update(chunk)
            written += len(chunk)
print(digest.hexdigest(), written)
'''

    # child worker: encode + decode with this process's own (clean)
    # ru_maxrss as the memory witness; prints one JSON result line
    RUN = r'''
import hashlib, json, resource, sys, time
from starch3_tpu.api import compress_bed_file, decompress_starch_file
in_path, out_path, in_digest, written = (
    sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))

t0 = time.perf_counter()
with open(out_path, "wb") as fh:
    compress_bed_file(in_path, fh)
enc_dt = time.perf_counter() - t0

class Hasher:
    def __init__(self):
        self.h = hashlib.sha256(); self.n = 0
    def write(self, b):
        self.h.update(b); self.n += len(b)

sink = Hasher()
t0 = time.perf_counter()
decompress_starch_file(out_path, sink)
dec_dt = time.perf_counter() - t0
print(json.dumps({
    "enc_dt": enc_dt, "dec_dt": dec_dt,
    "out_n": sink.n, "out_digest": sink.h.hexdigest(),
    "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
}))
'''

    def test_1gb_round_trip_bounded_memory(self, tmp_path):
        import json
        import os
        import subprocess
        import sys

        target = 1_100_000_000  # > 1 GB
        in_path = tmp_path / "big.bed"
        gen_script = tmp_path / "gen.py"
        gen_script.write_text(self.GEN)
        r = subprocess.run(
            [sys.executable, str(gen_script), str(in_path), str(target)],
            capture_output=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        in_digest, written = r.stdout.split()
        in_digest, written = in_digest.decode(), int(written)
        assert written >= 1_000_000_000

        run_script = tmp_path / "run.py"
        run_script.write_text(self.RUN)
        out_path = tmp_path / "big.starch"
        r = subprocess.run(
            [sys.executable, str(run_script), str(in_path), str(out_path),
             in_digest, str(written)],
            capture_output=True, timeout=600,
            env={
                **os.environ,
                "PYTHONPATH": os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))
                ),
            },
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        res = json.loads(r.stdout.decode().strip().splitlines()[-1])
        assert res["out_n"] == written
        assert res["out_digest"] == in_digest, "1 GB round trip not byte-exact"
        peak = res["peak_rss_mb"]
        print(
            f"\n1GB scale: encode {written/res['enc_dt']/1e6:.1f} MB/s, "
            f"decode {written/res['dec_dt']/1e6:.1f} MB/s, "
            f"peak RSS {peak:.0f} MB"
        )
        # constant-memory claim: peak RSS stays ~0.5x this corpus and,
        # more importantly, is CORPUS-INDEPENDENT: the bound is the fixed
        # 256 MB inflight window + a few in-flight chromosome texts +
        # numpy/jax baseline (~170 MB) — a 10 GB corpus peaks the same
        assert peak < 800, f"peak RSS {peak:.0f} MB — streaming window leaked"

        # stdin leg: the SAME corpus through
        # a real pipe must stream with the same bounded memory and
        # byte-identical archive (reference behavior: the producer is
        # O(1)-memory on stdin too, starch3api.hpp:158-199)
        pipe_script = tmp_path / "pipe.py"
        pipe_script.write_text(self.PIPE)
        out2 = tmp_path / "big2.starch"
        r = subprocess.run(
            ["/bin/sh", "-c",
             f"cat {in_path} | {sys.executable} {pipe_script} {out2}"],
            capture_output=True, timeout=600,
            env={
                **os.environ,
                "PYTHONPATH": os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))
                ),
            },
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        res2 = json.loads(r.stdout.decode().strip().splitlines()[-1])
        assert res2["peak_rss_mb"] < 800, res2
        import filecmp

        assert filecmp.cmp(out_path, out2, shallow=False), (
            "pipe archive != named-file archive"
        )
        print(
            f"1GB stdin pipe: encode {written/res2['enc_dt']/1e6:.1f} MB/s, "
            f"peak RSS {res2['peak_rss_mb']:.0f} MB"
        )

    PIPE = r'''
import json, resource, sys, time
from starch3_tpu.api import compress_bed_stream
t0 = time.perf_counter()
with open(sys.argv[1], "wb") as fh:
    compress_bed_stream(sys.stdin.buffer, fh)
print(json.dumps({
    "enc_dt": time.perf_counter() - t0,
    "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
}))
'''
