"""Parallel-subsystem tests: mesh sharding, assembly, manifest, multihost.

Runs on the 8-virtual-device CPU mesh (conftest).  Determinism asserts
implement SURVEY.md §4's "archive bytes independent of host count".
"""

import numpy as np
import pytest

from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
from starch3_tpu.bed.parser import parse_bed
from starch3_tpu.parallel.assemble import Manifest, assemble_ordered, input_digest
from starch3_tpu.parallel.distributed import (
    corpus_fingerprint,
    encode_corpus_multihost,
    shard_chromosomes,
)
from starch3_tpu.parallel.mesh import make_block_mesh, pad_batch

from tests.conftest import make_bed_text


class TestMesh:
    def test_mesh_all_devices(self):
        mesh = make_block_mesh()
        assert mesh.devices.size == 8
        assert mesh.axis_names == ("blocks",)

    def test_mesh_subset(self):
        assert make_block_mesh(4).devices.size == 4

    def test_pad_batch(self):
        assert pad_batch(5, 8) == 8
        assert pad_batch(8, 8) == 8
        assert pad_batch(9, 8) == 16
        assert pad_batch(1, 1) == 1


class TestMultihostSharding:
    def test_round_robin(self):
        chroms = [f"chr{i}" for i in range(10)]
        all_assigned = []
        for h in range(3):
            all_assigned += shard_chromosomes(chroms, 3, h)
        assert sorted(all_assigned) == list(range(10))

    def test_host_count_invariance(self, rng):
        """Archive bytes must not depend on how many hosts encoded."""
        bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2", "chr3", "chrX"))
        blocks = parse_bed(bed)
        order = [b.chrom for b in blocks]

        archives = []
        for n_hosts in (1, 2, 4):
            results = {}
            for h in range(n_hosts):
                results.update(
                    encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=h)
                )
            archives.append(assemble_ordered(order, results))
        assert archives[0] == archives[1] == archives[2]
        # and the gathered archive equals the single-process API's output
        assert archives[0] == compress_bed_bytes(bed)
        assert decompress_starch_bytes(archives[0]) == bed

    def test_host_count_invariance_gzip_segmented(self, rng):
        """The segmented gzip tier composes with multihost sharding:
        member boundaries are input-derived, so archives (including the
        metadata member index) are byte-identical for any host count and
        equal to the single-process API's output."""
        from starch3_tpu.config import CompressionMethod, EncodeConfig

        cfg = EncodeConfig(
            method=CompressionMethod.GZIP, gzip_segment_bytes=1024
        )
        bed = make_bed_text(rng, n=1200, chroms=("chr1", "chr2", "chr3"))
        blocks = parse_bed(bed)
        order = [b.chrom for b in blocks]
        archives = []
        for n_hosts in (1, 3):
            results = {}
            for h in range(n_hosts):
                results.update(
                    encode_corpus_multihost(
                        blocks, config=cfg, num_hosts=n_hosts, host_id=h
                    )
                )
            archives.append(assemble_ordered(order, results, compression="gzip"))
        assert archives[0] == archives[1]
        assert archives[0] == compress_bed_bytes(bed, cfg)
        assert decompress_starch_bytes(archives[0]) == bed

    def test_fingerprint_stable(self, rng):
        texts = [bytes(rng.integers(0, 255, 100, dtype=np.uint8)) for _ in range(3)]
        assert corpus_fingerprint(texts) == corpus_fingerprint(list(texts))


class TestManifestResume:
    def test_resume_skips_done(self, tmp_path, rng):
        path = str(tmp_path / "manifest.jsonl")
        m = Manifest.load(path)
        digest = input_digest(b"some transformed text")
        assert not m.has("chr1", digest)
        m.record("chr1", digest, "chr1.bz2", {"size": 10})
        # reload from disk: the entry survives the "crash"
        m2 = Manifest.load(path)
        assert m2.has("chr1", digest)
        # changed input invalidates the entry
        assert not m2.has("chr1", input_digest(b"different text"))


class TestDeviceRle2Pipeline:
    def test_full_device_pipeline_byte_identical(self, rng):
        """use_jax + device_rle2: BWT/MTF/RLE2 all on device, archive
        bytes identical to the host path (multi-chrom, multi-block)."""
        from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
        from starch3_tpu.config import EncodeConfig

        parts = []
        for c in (1, 2):
            starts = np.cumsum(rng.integers(1, 400, 2500))
            parts.append(
                b"".join(
                    b"chr%d\t%d\t%d\n" % (c, s, s + int(l))
                    for s, l in zip(
                        starts.tolist(), rng.integers(1, 200, 2500).tolist()
                    )
                )
            )
        bed = b"".join(parts)
        a = compress_bed_bytes(bed, EncodeConfig(use_jax=True, device_rle2=True))
        assert a == compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        assert decompress_starch_bytes(a) == bed

    def test_alphabet_class_routing_bit_exact(self, rng):
        """Blocks of every alphabet class (<=16, 17..32, 33..64, >64
        distinct bytes) — including mixed classes inside one call and
        one stream whose blocks straddle classes — route per-block to
        their own device tier (pipeline._bits_class) and come out
        bit-identical to libbz2."""
        import bz2

        from starch3_tpu.parallel.pipeline import encode_streams

        al21 = np.frombuffer(b"0123456789pek_a+-\t\nXY", np.uint8)
        al45 = np.arange(48, 93, dtype=np.uint8)
        texts = [
            b"".join(
                b"%d\t%d\n" % (a, b)
                for a, b in rng.integers(0, 10**6, (2000, 2)).tolist()
            ),
            al21[rng.integers(0, al21.size, 90_000)].tobytes(),
            al45[rng.integers(0, 45, 90_000)].tobytes(),
            rng.integers(0, 200, 60_000, dtype=np.uint8).tobytes(),
            # multi-block stream spanning the mid class
            al21[rng.integers(0, al21.size, 1_100_000)].tobytes(),
        ]
        for host_assist in (False, None):
            streams = encode_streams(texts, host_assist=host_assist)
            for i, (t, s) in enumerate(zip(texts, streams)):
                assert s.data == bz2.compress(t, 9), (host_assist, i)

    def test_config3_remainder_columns_end_to_end(self, rng):
        """BASELINE config 3 (id/score/strand remainder columns): the
        use_jax archive equals the host archive byte-for-byte and
        round-trips; the transformed text lands in the 17..32-symbol
        class, i.e. the bits==5 tier actually runs."""
        from starch3_tpu.api import (
            _parse_transform,
            compress_bed_bytes,
            decompress_starch_bytes,
        )
        from starch3_tpu.config import EncodeConfig
        from starch3_tpu.parallel.pipeline import _bits_class

        lines = []
        for c in (3, 7):
            pos = 500
            for i in range(4000):
                pos += int(rng.integers(1, 900))
                end = pos + int(rng.integers(20, 400))
                lines.append(
                    b"chr%d\t%d\t%d\tpeak_%d\t%d\t%s"
                    % (c, pos, end, i, int(rng.integers(0, 1000)),
                       b"+" if i % 2 else b"-")
                )
        bed = b"\n".join(lines) + b"\n"
        tf = _parse_transform(bed)
        n_syms = len(set(tf[0].text))
        assert _bits_class(n_syms) == 5
        a = compress_bed_bytes(bed, EncodeConfig(use_jax=True))
        assert a == compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        assert decompress_starch_bytes(a) == bed

    def test_device_huffman_byte_identical(self, rng):
        """use_jax + device_huffman: Huffman group costing (cost/select
        matmuls) and coded-data bit packing run on device; only the
        length heaps, headers, and splicing stay host-side.  Archive
        bytes identical to the host path."""
        from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
        from starch3_tpu.config import EncodeConfig

        parts = []
        for c in (1, 2, 3):
            starts = np.cumsum(rng.integers(1, 500, 1800))
            parts.append(
                b"".join(
                    b"chr%d\t%d\t%d\n" % (c, s, s + int(l))
                    for s, l in zip(
                        starts.tolist(), rng.integers(1, 300, 1800).tolist()
                    )
                )
            )
        bed = b"".join(parts)
        a = compress_bed_bytes(
            bed, EncodeConfig(use_jax=True, device_huffman=True)
        )
        assert a == compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        assert decompress_starch_bytes(a) == bed


class TestDeviceDemotion:
    def test_slow_device_is_benched(self, rng, monkeypatch):
        """A device whose effective rate collapses (sick chip / degraded
        link — an observed failure mode) must be demoted by the
        scheduler instead of straggling the corpus: the host stealers
        finish, bytes identical, and the run ends in a small multiple
        of the stealer-only time."""
        import bz2
        import time as _time

        from starch3_tpu import runtime
        from starch3_tpu.parallel import pipeline

        if runtime.get_lib() is None:
            pytest.skip("needs the native runtime (stealer path)")

        al = np.frombuffer(b"0123456789p-\t\n", np.uint8)
        texts = [
            al[rng.integers(0, al.size, 30_000)].tobytes() for _ in range(80)
        ]
        # pin both sides' rates so the test is schedule-deterministic:
        # stealers throttled to ~0.6 MB/s/core, mock device ~0.11 MB/s
        from starch3_tpu.codec import encoder as enc_mod

        real_fragment = enc_mod.encode_block_fragment

        def throttled_fragment(blk):
            _time.sleep(0.05)
            return real_fragment(blk)

        monkeypatch.setattr(
            enc_mod, "encode_block_fragment", throttled_fragment
        )
        monkeypatch.setattr(pipeline, "_DEMOTE_MIN_SAMPLES", 1)

        def slow_dispatch(block_datas, n_max, mesh, mode="ranks", pad_to=None):
            if isinstance(n_max, tuple):
                n_max, _bits = n_max
            rows = []
            useds = []
            lens = np.ones(max(len(block_datas), pad_to or 0), np.int32)
            for i, data in enumerate(block_datas):
                arr = np.frombuffer(data, np.uint8)
                used = np.bincount(arr, minlength=256) > 0
                u2s = (np.cumsum(used) - 1).astype(np.uint8)
                last, ptr = runtime.bwt_native(arr)
                ranks = runtime.mtf_ranks_native(
                    u2s[last].astype(np.int32), int(used.sum())
                ).astype(np.uint32)
                padded = np.zeros(n_max, np.uint32)
                padded[: ranks.size] = ranks
                r8 = padded.reshape(n_max // 8, 8)
                word = r8[:, 0].copy()
                for k in range(1, 8):
                    word |= r8[:, k] << (4 * k)
                rows.append(
                    np.concatenate(
                        [np.asarray([ptr, 0], np.int32), word.view(np.int32)]
                    )
                )
                useds.append(used)
                lens[i] = arr.size
            out = np.zeros((lens.size, 2 + n_max // 8), np.int32)
            for i, row in enumerate(rows):
                out[i] = row

            class SlowBatch:
                def is_ready(self):
                    return True

                def __array__(self, dtype=None, copy=None):
                    _time.sleep(0.8)  # pathological device turnaround
                    return out

            return SlowBatch(), {
                "b": len(block_datas), "useds": useds, "bits": 4, "lens": lens,
            }

        monkeypatch.setattr(pipeline, "_dispatch_chunk", slow_dispatch)
        before = pipeline.scheduler_stats["demotions"]
        t0 = _time.perf_counter()
        streams = pipeline.encode_streams(texts, host_assist=True)
        dt = _time.perf_counter() - t0
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i
        assert pipeline.scheduler_stats["demotions"] > before
        # 24 blocks at native speed is < 1 s; a non-demoted mock device
        # would spend 0.8 s per claimed batch serialized at the drain
        assert dt < 12, f"demotion did not cap the straggler ({dt:.1f}s)"


    def test_dead_device_batches_are_abandoned(self, rng, monkeypatch):
        """Mid-encode link outage: the device claims batches and never
        delivers them.  The driver must abandon stuck batches after
        _ABANDON_S (blocks re-enqueued for the stealers, or host-encoded
        inline when no stealer is left) so the encode terminates with
        correct bytes instead of hanging on blocks only the device
        holds."""
        import bz2
        import time as _time

        from starch3_tpu import runtime
        from starch3_tpu.parallel import pipeline

        if runtime.get_lib() is None:
            pytest.skip("needs the native runtime (stealer path)")

        al = np.frombuffer(b"0123456789p-\t\n", np.uint8)
        texts = [
            al[rng.integers(0, al.size, 30_000)].tobytes() for _ in range(20)
        ]

        class DeadBatch:
            def is_ready(self):
                return False

            def __array__(self, dtype=None, copy=None):
                raise AssertionError(
                    "drained a batch the dead device never delivered"
                )

        def dead_dispatch(block_datas, n_max, mesh, mode="ranks", pad_to=None):
            if isinstance(n_max, tuple):
                n_max, _bits = n_max
            lens = np.ones(max(len(block_datas), pad_to or 0), np.int32)
            useds = []
            for i, data in enumerate(block_datas):
                arr = np.frombuffer(data, np.uint8)
                useds.append(np.bincount(arr, minlength=256) > 0)
                lens[i] = arr.size
            return DeadBatch(), {
                "b": len(block_datas), "useds": useds, "bits": 4, "lens": lens,
            }

        monkeypatch.setattr(pipeline, "_dispatch_chunk", dead_dispatch)
        monkeypatch.setattr(pipeline, "_ABANDON_S", 0.4)
        monkeypatch.setattr(pipeline, "_DEMOTE_PROBE_S", 0.5)
        before = pipeline.scheduler_stats["abandoned_batches"]
        t0 = _time.perf_counter()
        streams = pipeline.encode_streams(texts, host_assist=True)
        dt = _time.perf_counter() - t0
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i
        assert pipeline.scheduler_stats["abandoned_batches"] > before
        assert dt < 30, f"dead-device encode took {dt:.1f}s"


def _real_rows_dispatch_factory(runtime, ready_delay=0.0):
    """A mock bits==4 fast-mode dispatch producing byte-exact result
    rows (host BWT+MTF, nibble-packed like _jitted_fused_step_ranks4),
    ready ``ready_delay`` seconds after dispatch."""
    import time as _time

    def dispatch(block_datas, n_max, mesh, mode="ranks", pad_to=None):
        if isinstance(n_max, tuple):
            n_max, _bits = n_max
        lens = np.ones(max(len(block_datas), pad_to or 0), np.int32)
        out = np.zeros((lens.size, 2 + n_max // 8), np.int32)
        useds = []
        for i, data in enumerate(block_datas):
            arr = np.frombuffer(data, np.uint8)
            used = np.bincount(arr, minlength=256) > 0
            u2s = (np.cumsum(used) - 1).astype(np.uint8)
            last, ptr = runtime.bwt_native(arr)
            ranks = runtime.mtf_ranks_native(
                u2s[last].astype(np.int32), int(used.sum())
            ).astype(np.uint32)
            padded = np.zeros(n_max, np.uint32)
            padded[: ranks.size] = ranks
            r8 = padded.reshape(n_max // 8, 8)
            word = r8[:, 0].copy()
            for k in range(1, 8):
                word |= r8[:, k] << (4 * k)
            out[i] = np.concatenate(
                [np.asarray([ptr, 0], np.int32), word.view(np.int32)]
            )
            useds.append(used)
            lens[i] = arr.size
        ready_at = _time.perf_counter() + ready_delay

        class Batch:
            def is_ready(self):
                return _time.perf_counter() >= ready_at

            def __array__(self, dtype=None, copy=None):
                wait = ready_at - _time.perf_counter()
                if wait > 0:
                    _time.sleep(wait)
                return out

        return Batch(), {
            "b": len(block_datas), "useds": useds, "bits": 4, "lens": lens,
        }

    return dispatch


class TestDeviceOnlyFailureModes:
    """A dead device or link must not hang a device-only
    (host_assist=False) encode, and the
    pure no-fallback mode must preserve blocking-drain semantics."""

    def _texts(self, rng, n=18):
        al = np.frombuffer(b"0123456789p-\t\n", np.uint8)
        return [
            al[rng.integers(0, al.size, 30_000)].tobytes() for _ in range(n)
        ]

    @pytest.mark.parametrize("probe_s", [60.0, 0.5])
    def test_dead_device_only_encode_terminates(self, rng, monkeypatch, probe_s):
        """host_assist=False + a device that never delivers: stuck
        batches are abandoned to driver-inline host encodes and the
        driver itself works the queue while the device is benched —
        the encode terminates with exact bytes instead of hanging on
        blocks only the device holds (observed outages last hours)."""
        import bz2
        import time as _time

        from starch3_tpu import runtime
        from starch3_tpu.parallel import pipeline

        if runtime.get_lib() is None:
            pytest.skip("needs the native runtime (host encode path)")
        texts = self._texts(rng)

        class DeadBatch:
            def is_ready(self):
                return False

            def __array__(self, dtype=None, copy=None):
                raise AssertionError(
                    "drained a batch the dead device never delivered"
                )

        def dead_dispatch(block_datas, n_max, mesh, mode="ranks", pad_to=None):
            if isinstance(n_max, tuple):
                n_max, _bits = n_max
            lens = np.ones(max(len(block_datas), pad_to or 0), np.int32)
            useds = []
            for i, data in enumerate(block_datas):
                arr = np.frombuffer(data, np.uint8)
                useds.append(np.bincount(arr, minlength=256) > 0)
                lens[i] = arr.size
            return DeadBatch(), {
                "b": len(block_datas), "useds": useds, "bits": 4, "lens": lens,
            }

        monkeypatch.setattr(pipeline, "_dispatch_chunk", dead_dispatch)
        monkeypatch.setattr(pipeline, "_ABANDON_S", 0.4)
        # probe_s=60: probes stay out of the window — progress must come
        # from the driver-as-stealer path.  probe_s=0.5: probes fire
        # repeatedly — the probe wait must keep host-encoding queued
        # blocks instead of stalling the only worker thread
        monkeypatch.setattr(pipeline, "_DEMOTE_PROBE_S", probe_s)
        before = pipeline.scheduler_stats["abandoned_batches"]
        t0 = _time.perf_counter()
        streams = pipeline.encode_streams(texts, host_assist=False)
        dt = _time.perf_counter() - t0
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i
        assert pipeline.scheduler_stats["abandoned_batches"] > before
        assert dt < 30, f"device-only dead-link encode took {dt:.1f}s"

    def test_no_host_fallback_keeps_blocking_semantics(self, rng, monkeypatch):
        """STARCH3_TPU_NO_HOST_FALLBACK=1: a slow-but-alive device is
        never abandoned even past _ABANDON_S — the drain blocks (the
        pure device-lane bench semantics) and bytes come from the
        device rows."""
        import bz2

        from starch3_tpu import runtime
        from starch3_tpu.parallel import pipeline

        if runtime.get_lib() is None:
            pytest.skip("needs the native runtime (row builder)")
        texts = self._texts(rng, n=9)
        monkeypatch.setenv("STARCH3_TPU_NO_HOST_FALLBACK", "1")
        monkeypatch.setattr(pipeline, "_ABANDON_S", 0.15)
        monkeypatch.setattr(
            pipeline,
            "_dispatch_chunk",
            _real_rows_dispatch_factory(runtime, ready_delay=0.5),
        )
        before = pipeline.scheduler_stats["abandoned_batches"]
        streams = pipeline.encode_streams(texts, host_assist=False)
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i
        assert pipeline.scheduler_stats["abandoned_batches"] == before


class TestClassRouting:
    def test_class_gate_decision(self, monkeypatch):
        """Unit spec of _BlockQueue.class_gated: a class gates only
        when (stealers exist, enough samples, tier EMA below the
        stealer-aggregate threshold) AND its probe window is closed;
        an open window re-arms as the probe claim."""
        from starch3_tpu.parallel import pipeline

        q = pipeline._BlockQueue()
        now = 1000.0
        # no stealers -> never gated
        assert not q.class_gated(8, now)
        q.n_stealers = 2
        q.stealer_rate = 127e6
        # no samples yet -> not gated
        assert not q.class_gated(8, now)
        q.class_rate[8] = 29e6
        q.class_samples[8] = pipeline._CLASS_MIN_SAMPLES
        # slow tier, window open: this claim is the probe (re-arms)
        assert not q.class_gated(8, now)
        assert q.class_probe_at[8] == now + pipeline._DEMOTE_PROBE_S
        # window now closed -> gated until it reopens
        assert q.class_gated(8, now + 1.0)
        assert q.class_gated(8, now + pipeline._DEMOTE_PROBE_S - 0.01)
        assert not q.class_gated(8, now + pipeline._DEMOTE_PROBE_S + 0.01)
        # a fast tier is never gated (a rate above the stealer aggregate)
        q.class_rate[4] = 129e6
        q.class_samples[4] = 99
        assert not q.class_gated(4, now)
        # legacy int bucket keys (bits None) pass through
        assert not q.class_gated(None, now)

    def test_claim_priority_orders_by_measured_rate(self):
        """Device claim order: unmeasured classes first (optimistic
        probe), then measured per-class rate descending, then bigger
        geometry — NOT the old widest-bits-first bucket-key sort that
        parked the chip on its slowest tier."""
        from starch3_tpu.parallel import pipeline

        q = pipeline._BlockQueue()
        keys = [(901_120, 4), (901_120, 8), (458_752, 4), (901_120, 5)]
        # nothing measured: bigger geometry first, narrow before wide
        got = sorted(keys, key=q.claim_priority)
        assert got == [(901_120, 4), (901_120, 5), (901_120, 8), (458_752, 4)]
        # measured rates: bits4 fast, bits8 slow, bits5 unmeasured ->
        # unmeasured first, then by rate
        q.class_rate = {4: 130e6, 8: 29e6}
        got = sorted(keys, key=q.claim_priority)
        assert got == [(901_120, 5), (901_120, 4), (458_752, 4), (901_120, 8)]

    def test_slow_class_routed_to_stealers(self, rng, monkeypatch):
        """Per-class routing end to end: a wide-alphabet class whose
        measured tier rate trails the stealer aggregate stops being
        claimed by the device (beyond one probe per period) while the
        narrow class keeps riding it; bytes stay exact either way."""
        import bz2
        import threading as _threading
        import time as _time

        from starch3_tpu import runtime
        from starch3_tpu.parallel import pipeline

        if runtime.get_lib() is None:
            pytest.skip("needs the native runtime (stealer path)")

        al = np.frombuffer(b"0123456789p-\t\n", np.uint8)
        narrow = [
            al[rng.integers(0, al.size, 30_000)].tobytes() for _ in range(6)
        ]
        wide = [
            rng.integers(0, 200, 30_000).astype(np.uint8).tobytes()
            for _ in range(60)
        ]
        texts = narrow[:3] + wide + narrow[3:]

        real_dispatch = _real_rows_dispatch_factory(runtime)
        svc = {"free_at": 0.0}
        svc_lock = _threading.Lock()

        def class_dispatch(block_datas, n_max, mesh, mode="ranks", pad_to=None):
            bits = n_max[1] if isinstance(n_max, tuple) else 4
            if bits == 4:
                return real_dispatch(block_datas, n_max, mesh, mode, pad_to)
            # wide tier: serialized slow service (like a real device's
            # sequential compute), rows flagged ties=1 so the drain
            # re-encodes on the host (byte-exact by construction)
            if isinstance(n_max, tuple):
                n_max, _b = n_max
            b_pad = max(len(block_datas), pad_to or 0)
            out = np.zeros((b_pad, 263 + (n_max + 1) // 2), np.int32)
            out[:, 2] = 1  # ties -> host fallback
            useds = [
                np.bincount(np.frombuffer(d, np.uint8), minlength=256) > 0
                for d in block_datas
            ]
            now = _time.perf_counter()
            with svc_lock:
                start = max(now, svc["free_at"])
                ready_at = start + 0.8
                svc["free_at"] = ready_at

            class SlowWide:
                def is_ready(self):
                    return _time.perf_counter() >= ready_at

                def __array__(self, dtype=None, copy=None):
                    wait = ready_at - _time.perf_counter()
                    if wait > 0:
                        _time.sleep(wait)
                    return out

            return SlowWide(), {"b": len(block_datas), "useds": useds, "bits": 8}

        from starch3_tpu.codec import encoder as enc_mod

        real_fragment = enc_mod.encode_block_fragment

        def throttled_fragment(blk):
            _time.sleep(0.2)
            return real_fragment(blk)

        monkeypatch.setattr(enc_mod, "encode_block_fragment", throttled_fragment)
        monkeypatch.setattr(pipeline, "_dispatch_chunk", class_dispatch)
        monkeypatch.setattr(pipeline, "_DEMOTE_MIN_SAMPLES", 99)  # isolate class gate
        monkeypatch.setattr(pipeline, "_CLASS_MIN_SAMPLES", 1)
        monkeypatch.setattr(pipeline, "_DEMOTE_PROBE_S", 30.0)
        before = pipeline.scheduler_stats["class_skips"]
        streams = pipeline.encode_streams(texts, host_assist=True)
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i
        assert pipeline.scheduler_stats["class_skips"] > before


class TestNarrowTiersShardMap:
    @pytest.mark.parametrize(
        "alphabet", [b"0123456789p-\t\n", b"0123456789pek_a+-\t\nXY"]
    )
    def test_narrow_tiers_under_shard_map_8dev(self, rng, alphabet):
        """The bits==4 (14 symbols) and bits==5 (21 symbols) steps run
        inside jax.shard_map on the virtual 8-device mesh, device-only;
        archives must be byte-identical to libbz2."""
        import bz2

        from starch3_tpu.parallel.pipeline import _bits_class, encode_streams

        al = np.frombuffer(alphabet, np.uint8)
        assert _bits_class(al.size) in (4, 5)
        texts = [al[rng.integers(0, al.size, 9000)].tobytes() for _ in range(9)]
        mesh = make_block_mesh()
        streams = encode_streams(texts, mesh=mesh, host_assist=False)
        for i, (t, s) in enumerate(zip(texts, streams)):
            assert s.data == bz2.compress(t, 9), i


class TestDeviceDecode:
    """parallel/pipeline.decode_streams: the device decode mirror."""

    def test_decode_streams_matches_host(self, rng):
        import bz2 as stdlib_bz2

        from starch3_tpu.codec.encoder import bz2_compress
        from starch3_tpu.parallel.pipeline import decode_streams

        texts = [
            bytes(rng.integers(0, 64, int(rng.integers(1, 5000)), dtype=np.uint8))
            for _ in range(5)
        ]
        streams = [bz2_compress(t, 9) for t in texts]
        got = decode_streams(streams)
        assert got == texts
        # and the streams decode identically through libbz2
        assert [stdlib_bz2.decompress(s) for s in streams] == texts

    def test_decode_streams_mesh_sharded(self, rng):
        from starch3_tpu.codec.encoder import bz2_compress
        from starch3_tpu.parallel.pipeline import decode_streams

        texts = [
            bytes(rng.integers(0, 16, 3000, dtype=np.uint8)) for _ in range(4)
        ]
        streams = [bz2_compress(t, 9) for t in texts]
        mesh = make_block_mesh()
        assert decode_streams(streams, mesh=mesh) == texts
        assert decode_streams(streams) == texts  # topology-independent

    def test_api_use_jax_decode(self, rng):
        bed = make_bed_text(rng, n=3000)
        arc = compress_bed_bytes(bed)
        assert decompress_starch_bytes(arc, use_jax=True) == bed

    def test_corrupt_stream_raises(self, rng):
        import pytest

        from starch3_tpu.codec.encoder import bz2_compress
        from starch3_tpu.errors import FormatError
        from starch3_tpu.parallel.pipeline import decode_streams

        text = bytes(rng.integers(0, 32, 4000, dtype=np.uint8))
        stream = bytearray(bz2_compress(text, 9))
        stream[len(stream) // 2] ^= 0x40
        with pytest.raises(FormatError):
            decode_streams([bytes(stream)])


class TestStreamingFeed:
    """The streaming scheduler (pipeline.encode_streams_feed) and the
    chunked parse feeder (api._iter_parse_transform): encoding overlaps
    parsing, bytes stay identical to the one-shot path."""

    def test_feed_equals_list(self, rng):
        from starch3_tpu.parallel.pipeline import (
            encode_streams,
            encode_streams_feed,
        )

        texts = [
            bytes(rng.integers(0, 16, int(n), dtype=np.uint8))
            for n in rng.integers(2_000, 40_000, 7)
        ]
        want = encode_streams(texts)

        def slow_iter():
            import time

            for t in texts:
                time.sleep(0.002)  # blocks trickle in while workers run
                yield t

        got = encode_streams_feed(slow_iter())
        assert [g.data for g in got] == [w.data for w in want]

    def test_iter_yields_incrementally_with_bounded_window(self, rng):
        """encode_streams_iter yields stream k before the feeder has
        produced the last streams (incremental assembly), releases
        yielded streams' memory, respects the backpressure window, and
        matches encode_streams byte-for-byte."""
        import bz2

        from starch3_tpu.parallel.pipeline import encode_streams_iter

        texts = [
            bytes(rng.integers(0, 16, 30_000, dtype=np.uint8))
            for _ in range(8)
        ]
        fed = []

        def gen():
            for t in texts:
                fed.append(len(fed))
                yield t

        yielded_at = []
        out = []
        # window smaller than the corpus: the feeder must block and
        # resume as streams are yielded
        for enc in encode_streams_iter(iter(gen()), window_bytes=70_000):
            yielded_at.append(len(fed))
            out.append(enc.data)
        assert out == [bz2.compress(t, 9) for t in texts]
        # at least one early stream was yielded before feeding finished
        assert yielded_at[0] < len(texts)

    def test_iter_feeder_error_propagates(self, rng):
        from starch3_tpu.parallel.pipeline import encode_streams_iter

        class Boom(RuntimeError):
            pass

        def gen():
            yield bytes(rng.integers(0, 16, 10_000, dtype=np.uint8))
            raise Boom("feeder died")

        with pytest.raises(Boom):
            list(encode_streams_iter(gen()))

    def test_iter_early_close_releases_workers(self, rng):
        """Abandoning the generator mid-iteration must not leave the
        scheduler wedged (cancel path: feeder unblocked, workers
        drained)."""
        from starch3_tpu.parallel.pipeline import encode_streams_iter

        texts = [
            bytes(rng.integers(0, 16, 20_000, dtype=np.uint8))
            for _ in range(6)
        ]
        it = encode_streams_iter(iter(texts), window_bytes=50_000)
        next(it)
        it.close()  # GeneratorExit -> finally: cancel + join

    def test_feed_partial_batches_device_only(self, rng):
        """5 blocks with batch_size 3: the final partial batch is padded
        to the same compiled geometry; host_assist off forces every
        block through the device path."""
        from starch3_tpu.codec.encoder import bz2_compress
        from starch3_tpu.parallel.pipeline import encode_streams_feed

        texts = [
            bytes(rng.integers(0, 16, 3000, dtype=np.uint8)) for _ in range(5)
        ]
        got = encode_streams_feed(
            iter(texts), batch_size=3, host_assist=False
        )
        assert [g.data for g in got] == [bz2_compress(t, 9) for t in texts]

    def test_feeder_error_propagates(self, rng):
        import pytest

        from starch3_tpu.parallel.pipeline import encode_streams_feed

        class Boom(Exception):
            pass

        def gen():
            yield bytes(rng.integers(0, 16, 2000, dtype=np.uint8))
            raise Boom()

        with pytest.raises(Boom):
            encode_streams_feed(gen())

    def test_iter_parse_transform_matches_oneshot(self, rng):
        """Tiny chunks force chromosome spans across chunk boundaries;
        the merged re-transform must equal the whole-buffer parse."""
        from starch3_tpu.api import _iter_parse_transform, _parse_transform

        bed = make_bed_text(
            rng, n=4000, chroms=("chr1", "chr2", "chr3"), with_remainder=True
        )
        want = _parse_transform(bed)
        got = list(_iter_parse_transform(bed, chunk_bytes=1 << 12))
        assert [(g.chrom, g.text) for g in got] == [
            (w.chrom, w.text) for w in want
        ]
        assert [
            (g.line_count, g.base_count_nonunique, g.base_count_unique)
            for g in got
        ] == [
            (w.line_count, w.base_count_nonunique, w.base_count_unique)
            for w in want
        ]

    def test_iter_parse_transform_single_huge_chrom(self, rng):
        from starch3_tpu.api import _iter_parse_transform, _parse_transform

        bed = make_bed_text(rng, n=3000, chroms=("chr9",))
        want = _parse_transform(bed)
        got = list(_iter_parse_transform(bed, chunk_bytes=1 << 11))
        assert len(got) == 1
        assert got[0].text == want[0].text

    def test_iter_parse_no_final_newline_and_blanks(self, rng):
        from starch3_tpu.api import _iter_parse_transform, _parse_transform

        bed = (
            b"chr1\t10\t20\nchr1\t30\t40\n\n\nchr2\t5\t9\nchr2\t12\t20"
        )
        want = _parse_transform(bed)
        got = list(_iter_parse_transform(bed, chunk_bytes=16))
        assert [(g.chrom, g.text) for g in got] == [
            (w.chrom, w.text) for w in want
        ]

    def test_duplicate_chromosome_same_error(self, rng):
        """Non-contiguous duplicate chromosomes must raise the same
        parse error through the streaming path as the one-shot path."""
        import pytest

        from starch3_tpu.config import EncodeConfig
        from starch3_tpu.errors import BedParseError

        bed = b"chr1\t10\t20\nchr2\t5\t9\nchr1\t30\t40\n"
        with pytest.raises(BedParseError):
            compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        with pytest.raises(BedParseError):
            compress_bed_bytes(bed, EncodeConfig(use_jax=True))

    def test_api_jax_pipelined_equals_host(self, rng):
        from starch3_tpu import api as A
        from starch3_tpu.config import EncodeConfig

        bed = make_bed_text(rng, n=6000, chroms=("chr1", "chr2", "chrM"))
        want = compress_bed_bytes(bed, EncodeConfig(use_jax=False))
        # force many feeder chunks so encode genuinely overlaps parse
        orig = A._iter_parse_transform
        A._iter_parse_transform = lambda d: orig(d, chunk_bytes=1 << 13)
        try:
            got = compress_bed_bytes(bed, EncodeConfig(use_jax=True))
        finally:
            A._iter_parse_transform = orig
        assert got == want


class TestBlockCounters:
    """scheduler_stats blocks_* say who finished each block."""

    def _delta(self, fn):
        from starch3_tpu.parallel import pipeline

        before = dict(pipeline.scheduler_stats)
        out = fn()
        return out, {
            k: pipeline.scheduler_stats[k] - before[k]
            for k in ("blocks_device", "blocks_tie_fallback", "blocks_host")
        }

    @pytest.mark.parametrize("device_huffman", [False, True])
    def test_device_only_counts_device_blocks(self, rng, device_huffman):
        import bz2

        from starch3_tpu.parallel.pipeline import encode_streams

        texts = [make_bed_text(rng, n=600, chroms=(f"chr{i}",)) for i in range(4)]
        got, d = self._delta(
            lambda: encode_streams(
                texts, host_assist=False, device_huffman=device_huffman
            )
        )
        assert [s.data for s in got] == [bz2.compress(t, 9) for t in texts]
        # raw BED repeats "chrN\t" often enough that a block may tie
        assert d["blocks_host"] == 0 and d["blocks_device"] > 0
        assert d["blocks_device"] + d["blocks_tie_fallback"] == 4

    def test_periodic_block_counts_tie_fallback(self):
        import bz2

        from starch3_tpu.parallel.pipeline import encode_streams

        text = b"1723\n481\np100\n" * 400
        got, d = self._delta(lambda: encode_streams([text], host_assist=False))
        assert got[0].data == bz2.compress(text, 9)
        assert d == {"blocks_device": 0, "blocks_tie_fallback": 1, "blocks_host": 0}

    def test_hybrid_counts_every_block_once(self, rng):
        from starch3_tpu.parallel.pipeline import encode_streams

        texts = [make_bed_text(rng, n=600, chroms=(f"chr{i}",)) for i in range(6)]
        _, d = self._delta(lambda: encode_streams(texts, host_assist=True))
        assert sum(d.values()) == 6
