"""Device-kernel equivalence tests (CPU backend, small shapes).

Every device kernel must match its NumPy oracle exactly; the oracles are
themselves bit-exactness-tested against libbz2 (test_bitexact.py), so
equality here extends the bit-exact guarantee to the device path.
"""

import numpy as np
import pytest

from starch3_tpu.codec.bwt import bwt_encode
from starch3_tpu.codec.mtf import mtf_ranks, symbol_map
from starch3_tpu.ops.bwt_jax import bwt_encode_jax
from starch3_tpu.ops.mtf_jax import WIDTHS, mtf_ranks as mtf_ranks_device

from tests.conftest import make_bed_text


class TestBwtJax:
    @pytest.mark.parametrize("n", [1, 2, 33, 512, 3000])
    def test_matches_oracle_random(self, rng, n):
        blk = rng.integers(0, 256, n, dtype=np.uint8)
        l1, p1 = bwt_encode(blk)
        l2, p2 = bwt_encode_jax(blk, n_max=max(512, ((n + 511) // 512) * 512))
        assert l1.tolist() == l2.tolist()
        assert p1 == p2

    def test_matches_oracle_lowentropy(self, rng):
        blk = rng.integers(0, 3, 2048, dtype=np.uint8)
        l1, p1 = bwt_encode(blk)
        l2, p2 = bwt_encode_jax(blk, n_max=2048)
        assert l1.tolist() == l2.tolist() and p1 == p2

    def test_matches_oracle_periodic(self):
        blk = np.frombuffer(b"xyz" * 300, dtype=np.uint8)
        l1, p1 = bwt_encode(blk)
        l2, p2 = bwt_encode_jax(blk, n_max=1024)
        assert l1.tolist() == l2.tolist() and p1 == p2

    def test_padding_is_inert(self, rng):
        blk = rng.integers(0, 256, 700, dtype=np.uint8)
        l1, p1 = bwt_encode_jax(blk, n_max=1024)
        l2, p2 = bwt_encode_jax(blk, n_max=2048)
        assert l1.tolist() == l2.tolist() and p1 == p2


class TestBwtFast:
    """One-sort packed-prefix BWT (ops/bwt_fast.py): must equal the oracle
    whenever it reports ties == 0, and must report ties on inputs where
    the m-symbol prefix is not a total order."""

    @pytest.mark.parametrize("n", [1, 2, 33, 512, 3000])
    def test_matches_oracle_random_bytes(self, rng, n):
        from starch3_tpu.ops.bwt_fast import bwt_fast_host

        blk = rng.integers(0, 256, n, dtype=np.uint8)
        last, ptr, ties = bwt_fast_host(blk)
        if ties == 0:
            l1, p1 = bwt_encode(blk)
            assert last.tolist() == l1.tolist() and ptr == p1

    @pytest.mark.parametrize("sigma", [2, 10, 16])
    def test_matches_oracle_small_alphabet(self, rng, sigma):
        from starch3_tpu.ops.bwt_fast import bwt_fast_host

        blk = rng.integers(48, 48 + sigma, 4096, dtype=np.uint8)
        last, ptr, ties = bwt_fast_host(blk)
        if ties == 0:
            l1, p1 = bwt_encode(blk)
            assert last.tolist() == l1.tolist() and ptr == p1

    def test_real_transform_text_is_tie_free_and_exact(self, rng):
        from starch3_tpu.api import _parse_transform
        from starch3_tpu.ops.bwt_fast import bwt_fast_host

        text = _parse_transform(make_bed_text(rng, n=3000))[0].text
        blk = np.frombuffer(text, dtype=np.uint8)
        last, ptr, ties = bwt_fast_host(blk)
        assert ties == 0  # delta text is near-unique at 24 symbols
        l1, p1 = bwt_encode(blk)
        assert last.tolist() == l1.tolist() and ptr == p1

    def test_periodic_input_reports_ties(self):
        from starch3_tpu.ops.bwt_fast import bwt_fast_host

        blk = np.frombuffer(b"1723\n481\np100\n" * 40, dtype=np.uint8)
        _, _, ties = bwt_fast_host(blk.copy())
        assert ties > 0  # repeats longer than the packed prefix

    def test_all_equal_reports_ties(self):
        from starch3_tpu.ops.bwt_fast import bwt_fast_host

        _, _, ties = bwt_fast_host(np.full(100, 97, dtype=np.uint8))
        assert ties > 0

    def test_padding_is_inert(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast

        seq = rng.integers(0, 13, 700).astype(np.int32)
        outs = []
        for n_max in (1024, 2048):
            padded = np.zeros(n_max, dtype=np.int32)
            padded[:700] = seq
            # poison the pad region: results must not change
            padded[700:] = 15
            last, ptr, ties = bwt_sort_fast(
                jnp.asarray(padded), jnp.int32(700), n_max, 4
            )
            outs.append((np.asarray(last)[:700].tolist(), int(ptr), int(ties)))
        assert outs[0] == outs[1]


def _device_ranks(seqs, width, n_max=None):
    """Rows of ``seqs`` (lists/arrays of equal or ragged length) through
    ops/mtf_jax.mtf_ranks; returns each row's valid prefix."""
    import jax.numpy as jnp

    lens = np.array([len(r) for r in seqs], np.int32)
    n_max = n_max or int(lens.max())
    pad = np.zeros((len(seqs), n_max), np.int32)
    for i, r in enumerate(seqs):
        pad[i, : len(r)] = r
    out = np.asarray(
        mtf_ranks_device(jnp.asarray(pad), jnp.asarray(lens), n_max, width)
    )
    assert not out[np.arange(n_max)[None, :] >= lens[:, None]].any()
    return [out[i, : lens[i]] for i in range(len(seqs))]


class TestMtfJax:
    @pytest.mark.parametrize("n", [1, 100, 4096, 5000])
    def test_matches_oracle(self, rng, n):
        blk = rng.integers(0, 200, n, dtype=np.uint8)
        _, u2s, n_in = symbol_map(blk)
        seq = u2s[blk].astype(np.int32)
        got = _device_ranks([seq], 256)[0]
        assert got.tolist() == mtf_ranks(seq, n_in).tolist()


class TestMtfRanks:
    """ops/mtf_jax.mtf_ranks at every alphabet width the device tiers use
    (16 for bits==4, 32/64 for bits==5/6, 256 for bits==8) vs the NumPy
    oracle, including the cross-tile recency-order carry."""

    @pytest.mark.parametrize("width", WIDTHS)
    @pytest.mark.parametrize(
        "n,nsym", [(1, 16), (100, 2), (4096, 14), (5000, 16), (12288, 5)]
    )
    def test_matches_oracle(self, rng, n, nsym, width):
        seq = rng.integers(0, nsym, n).astype(np.int32)
        got = _device_ranks([seq], width)[0]
        assert got.tolist() == mtf_ranks(seq, width).tolist()

    @pytest.mark.parametrize("width", WIDTHS)
    def test_rare_symbol_across_tiles(self, rng, width):
        """A symbol seen once early then silent across many tiles: its
        carried recency order must stay exact."""
        seq = rng.integers(0, 3, 20000).astype(np.int32)
        seq[5] = width - 1
        seq[100] = width - 2
        seq[19999] = width - 1  # rank depends on order among silent symbols
        got = _device_ranks([seq], width)[0]
        assert got.tolist() == mtf_ranks(seq, width).tolist()

    def test_batch_rows_independent(self, rng):
        """Row 1's ranks must not depend on row 0, and ragged lengths
        zero each row's tail."""
        a = rng.integers(0, 16, 4096).astype(np.int32)
        b = rng.integers(0, 16, 3001).astype(np.int32)
        got = _device_ranks([a, b], 16)
        assert got[0].tolist() == mtf_ranks(a, 16).tolist()
        assert got[1].tolist() == mtf_ranks(b, 16).tolist()
        alone = _device_ranks([b], 16, n_max=4096)[0]
        assert alone.tolist() == got[1].tolist()

    @pytest.mark.parametrize("n_max", [16_384, 131_072, 458_752, 901_120])
    def test_every_geometry_bucket(self, rng, n_max):
        """Each padded geometry the pipeline compiles (_N_MAX_BUCKETS),
        with a row shorter than the bucket."""
        from starch3_tpu.parallel.pipeline import _N_MAX_BUCKETS

        assert n_max in _N_MAX_BUCKETS
        seq = rng.integers(0, 14, n_max - 777).astype(np.int32)
        got = _device_ranks([seq], 16, n_max=n_max)[0]
        assert got.tolist() == mtf_ranks(seq, 16).tolist()

    def test_rejects_unknown_width(self):
        import jax.numpy as jnp

        with pytest.raises(ValueError):
            mtf_ranks_device(
                jnp.zeros((1, 8), jnp.int32), jnp.ones(1, jnp.int32), 8, 128
            )


class TestBwtFast3:
    """ops/bwt_fast.bwt_sort_fast3: the 3-operand payload-in-key sort."""

    @pytest.mark.parametrize("sigma", [2, 10, 16])
    def test_matches_oracle_when_tie_free(self, rng, sigma):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast3

        seq = rng.integers(0, sigma, 3000).astype(np.int32)
        pad = np.zeros(4096, np.int32)
        pad[:3000] = seq
        last, ptr, ties = bwt_sort_fast3(jnp.asarray(pad), jnp.int32(3000), 4096)
        if int(ties) == 0:
            l1, p1 = bwt_encode(seq.astype(np.uint8))
            assert np.asarray(last)[:3000].tolist() == l1.tolist()
            assert int(ptr) == p1

    def test_real_transform_text_tie_free_and_exact(self, rng):
        from starch3_tpu.api import _parse_transform
        from starch3_tpu.codec.mtf import symbol_map
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast3

        text = _parse_transform(make_bed_text(rng, n=3000))[0].text
        blk = np.frombuffer(text, dtype=np.uint8)
        _, u2s, n_in = symbol_map(blk)
        assert n_in <= 16
        seq = u2s[blk].astype(np.int32)
        n = seq.size
        n_max = 1 << (n - 1).bit_length()
        pad = np.zeros(n_max, np.int32)
        pad[:n] = seq
        last, ptr, ties = bwt_sort_fast3(jnp.asarray(pad), jnp.int32(n), n_max)
        assert int(ties) == 0
        l1, p1 = bwt_encode(blk)
        dense_last = u2s[l1]
        assert np.asarray(last)[:n].tolist() == dense_last.tolist()
        assert int(ptr) == p1

    def test_periodic_reports_ties(self):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast3

        pat = np.frombuffer(b"1723\n481\np100\n" * 40, dtype=np.uint8)
        vals = np.unique(pat)
        dense = np.searchsorted(vals, pat).astype(np.int32)
        pad = np.zeros(1024, np.int32)
        pad[: dense.size] = dense
        _, _, ties = bwt_sort_fast3(jnp.asarray(pad), jnp.int32(dense.size), 1024)
        assert int(ties) > 0

    def test_padding_is_inert(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast3

        seq = rng.integers(0, 13, 700).astype(np.int32)
        outs = []
        for n_max in (1024, 2048):
            padded = np.full(n_max, 15, dtype=np.int32)  # poisoned pad
            padded[:700] = seq
            last, ptr, ties = bwt_sort_fast3(
                jnp.asarray(padded), jnp.int32(700), n_max
            )
            outs.append((np.asarray(last)[:700].tolist(), int(ptr), int(ties)))
        assert outs[0] == outs[1]


class TestBwtFastMid:
    """ops/bwt_fast.bwt_sort_fast_mid: the bits==5/6 mid-width tier
    (17..64-symbol alphabets — BASELINE config 3's remainder-column
    class)."""

    @pytest.mark.parametrize(
        "bits,sigma", [(5, 17), (5, 21), (5, 32), (6, 33), (6, 45), (6, 64)]
    )
    def test_matches_oracle_when_tie_free(self, rng, bits, sigma):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid

        n = 3000
        seq = rng.integers(0, sigma, n).astype(np.int32)
        pad = np.zeros(4096, np.int32)
        pad[:n] = seq
        last, ptr, ties = bwt_sort_fast_mid(
            jnp.asarray(pad), jnp.int32(n), 4096, bits
        )
        assert int(ties) == 0  # random text at these sigmas never ties
        l1, p1 = bwt_encode(seq.astype(np.uint8))
        assert np.asarray(last)[:n].tolist() == l1.tolist()
        assert int(ptr) == p1

    @pytest.mark.parametrize("bits", [5, 6])
    def test_periodic_reports_ties(self, rng, bits):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid

        pat = rng.integers(0, (1 << bits), 9).astype(np.int32)
        dense = np.tile(pat, 60)
        pad = np.zeros(1024, np.int32)
        pad[: dense.size] = dense
        _, _, ties = bwt_sort_fast_mid(
            jnp.asarray(pad), jnp.int32(dense.size), 1024, bits
        )
        assert int(ties) > 0

    def test_config3_style_text_tie_free_and_exact(self, rng):
        """Transformed BED with id/score/strand remainders (a ~21-symbol
        alphabet): the 23-symbol context must be tie-free and exact —
        the property the whole mid tier's throughput rides on."""
        import jax.numpy as jnp

        from starch3_tpu.api import _parse_transform
        from starch3_tpu.codec.mtf import symbol_map
        from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid

        lines = []
        pos = 1000
        for i in range(3000):
            pos += int(rng.integers(1, 800))
            end = pos + int(rng.integers(20, 400))
            lines.append(
                b"chr5\t%d\t%d\tpeak_%d\t%d\t%s"
                % (pos, end, i, int(rng.integers(0, 1000)),
                   b"+" if i % 2 else b"-")
            )
        text = _parse_transform(b"\n".join(lines) + b"\n")[0].text
        blk = np.frombuffer(text, dtype=np.uint8)
        _, u2s, n_in = symbol_map(blk)
        assert 16 < n_in <= 32
        seq = u2s[blk].astype(np.int32)
        n = seq.size
        n_max = 1 << (n - 1).bit_length()
        pad = np.zeros(n_max, np.int32)
        pad[:n] = seq
        last, ptr, ties = bwt_sort_fast_mid(
            jnp.asarray(pad), jnp.int32(n), n_max, 5
        )
        assert int(ties) == 0
        l1, p1 = bwt_encode(blk)
        assert np.asarray(last)[:n].tolist() == u2s[l1].tolist()
        assert int(ptr) == p1

    @pytest.mark.parametrize("bits", [5, 6])
    def test_padding_is_inert(self, rng, bits):
        import jax.numpy as jnp

        from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid

        seq = rng.integers(0, (1 << bits), 700).astype(np.int32)
        outs = []
        for n_max in (1024, 2048):
            padded = np.full(n_max, (1 << bits) - 1, dtype=np.int32)
            padded[:700] = seq
            last, ptr, ties = bwt_sort_fast_mid(
                jnp.asarray(padded), jnp.int32(700), n_max, bits
            )
            outs.append((np.asarray(last)[:700].tolist(), int(ptr), int(ties)))
        assert outs[0] == outs[1]


class TestTransformJax:
    def test_core_matches_host(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.ops.transform_jax import transform_core, union_length_device
        from starch3_tpu.transform.delta import _dec_len, _union_length

        n = 500
        starts = np.cumsum(rng.integers(0, 1000, n)).astype(np.int32)
        stops = (starts + rng.integers(1, 500, n)).astype(np.int32)
        p_mask, diff, deltas, p_lens, d_lens, nonuniq = transform_core(
            jnp.asarray(starts), jnp.asarray(stops)
        )
        coord_diff = stops.astype(np.int64) - starts
        prev = np.concatenate(([0], coord_diff[:-1]))
        last_stop = np.concatenate(([0], stops[:-1])).astype(np.int64)
        exp_deltas = np.where(last_stop == 0, starts, starts - last_stop)
        assert np.array_equal(np.asarray(p_mask), coord_diff != prev)
        assert np.array_equal(np.asarray(deltas), exp_deltas)
        assert np.array_equal(np.asarray(d_lens), _dec_len(exp_deltas))
        assert int(nonuniq) == int(coord_diff.sum())
        assert int(union_length_device(jnp.asarray(starts), jnp.asarray(stops))) == _union_length(
            starts.astype(np.int64), stops.astype(np.int64)
        )

    def test_untransform_core(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.ops.transform_jax import untransform_core

        n = 300
        starts = np.cumsum(rng.integers(1, 100, n)).astype(np.int32)
        stops = (starts + rng.integers(1, 50, n)).astype(np.int32)
        diffs = stops - starts
        last_stop = np.concatenate(([0], stops[:-1]))
        deltas = starts - last_stop
        s2, e2 = untransform_core(jnp.asarray(deltas), jnp.asarray(diffs))
        assert np.array_equal(np.asarray(s2), starts)
        assert np.array_equal(np.asarray(e2), stops)


class TestHuffJax:
    def test_group_hist_and_cost(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.ops.huff_jax import ALPHA_MAX, cost_and_select, group_histograms

        n_mtf = 437
        g_max = 9  # ceil(437/50)
        syms = rng.integers(0, 50, g_max * 50).astype(np.int32)
        hist = group_histograms(jnp.asarray(syms), jnp.int32(n_mtf), g_max)
        hist_np = np.zeros((g_max, ALPHA_MAX), dtype=np.int64)
        for i in range(n_mtf):
            hist_np[i // 50, syms[i]] += 1
        assert np.array_equal(np.asarray(hist), hist_np)

        lengths = rng.integers(1, 18, (6, ALPHA_MAX)).astype(np.int32)
        mask = np.array([True, True, True, False, False, False])
        sel, rfreq = cost_and_select(
            jnp.asarray(hist), jnp.asarray(lengths), jnp.asarray(mask)
        )
        cost_np = hist_np @ lengths.T.astype(np.int64)
        cost_np[:, ~mask] = 1 << 30
        assert np.array_equal(np.asarray(sel), np.argmin(cost_np, axis=1))
        rfreq_np = np.zeros((6, ALPHA_MAX), dtype=np.int64)
        for g in range(g_max):
            rfreq_np[np.argmin(cost_np[g])] += hist_np[g]
        assert np.array_equal(np.asarray(rfreq), rfreq_np)


class TestJaxPipeline:
    def test_bit_exact_small(self, rng):
        import bz2

        from starch3_tpu.parallel.pipeline import jax_bz2_compress

        data = make_bed_text(rng, n=2000)
        assert jax_bz2_compress(data) == bz2.compress(data, 9)

    def test_sharded_mesh(self, rng):
        import bz2

        from starch3_tpu.parallel.mesh import make_block_mesh
        from starch3_tpu.parallel.pipeline import jax_bz2_compress

        mesh = make_block_mesh()  # all 8 virtual CPU devices
        assert mesh.devices.size == 8
        data = make_bed_text(rng, n=2000)
        # archive bytes must be independent of topology (BASELINE.json
        # determinism requirement)
        assert jax_bz2_compress(data, mesh=mesh) == bz2.compress(data, 9)


class TestDeviceBitPack:
    """ops/bitpack_jax.py: the device restatement of codec/bitio.pack_bits
    (fields -> MSB-first stream via cumsum offsets + two scatter-adds)."""

    def test_matches_host_packer(self, rng):
        from starch3_tpu.codec.bitio import pack_bits
        from starch3_tpu.ops.bitpack_jax import pack_bits_via_device

        for _ in range(8):
            n = int(rng.integers(1, 2000))
            bits = rng.integers(1, 49, n)
            vals = rng.integers(0, 1 << 48, n, dtype=np.uint64) & (
                (np.uint64(1) << bits.astype(np.uint64)) - np.uint64(1)
            )
            whole, tail, tail_n = pack_bits(vals, bits)
            ref = whole + (
                bytes([(tail << (8 - tail_n)) & 0xFF]) if tail_n else b""
            )
            assert pack_bits_via_device(vals, bits) == ref


class TestDeviceRle2:
    """ops/rle2_jax.py vs the host oracle (codec/mtf.mtf_rle2_from_ranks):
    zero-run bijective-base-2 digits, rank shift, EOB, frequencies."""

    def test_matches_oracle(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.codec.mtf import mtf_rle2_from_ranks
        from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded

        n_max = 2048
        for trial in range(12):
            n = int(rng.integers(1, n_max))
            n_in_use = int(rng.integers(1, 256))
            ranks = np.where(
                rng.random(n) < 0.7, 0, rng.integers(1, n_in_use, n)
            ).astype(np.int32)
            if trial == 0:
                ranks[:] = 0  # all-zero stream: digits + EOB only
            in_use = np.zeros(256, bool)
            in_use[:n_in_use] = True
            ref = mtf_rle2_from_ranks(ranks.astype(np.uint8), in_use)
            pad = np.zeros(n_max, np.int32)
            pad[:n] = ranks
            syms, m, freq = rle2_from_ranks_padded(
                jnp.asarray(pad), np.int32(n), np.int32(n_in_use), n_max
            )
            assert np.array_equal(np.asarray(syms)[: int(m)], ref.symbols)
            assert np.array_equal(np.asarray(freq)[: ref.alpha_size], ref.freq)


class TestBwtInitBytes:
    def test_three_byte_init_matches(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.codec.bwt import bwt_encode
        from starch3_tpu.ops.bwt_jax import bwt_encode_padded

        n_max = 1024
        for trial in range(10):
            n = int(rng.integers(1, n_max))
            if trial % 3 == 0:
                d = np.full(n, 65, np.uint8)
            else:
                d = rng.integers(0, 8, n, dtype=np.uint8)
            pad = np.zeros(n_max, np.uint8)
            pad[:n] = d
            l_ref, p_ref = bwt_encode(d)
            l3, p3 = bwt_encode_padded(jnp.asarray(pad), np.int32(n), n_max, 3)
            assert np.array_equal(np.asarray(l3)[:n], l_ref) and int(p3) == p_ref


def test_device_rle2_power_of_two_runs():
    """Zero-runs whose z+1 is a power of two trip float log2 (float32
    log2(32768) can round to 14.999999); the kernel must use exact
    integer bit lengths."""
    import jax.numpy as jnp

    from starch3_tpu.codec.mtf import mtf_rle2_from_ranks
    from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded

    n_max = 1 << 17
    in_use = np.zeros(256, bool)
    in_use[:10] = True
    for z in (1, 3, 32766, 32767, 32768, 65535):
        ranks = np.zeros(z + 1, np.int32)
        ranks[z] = 5
        ref = mtf_rle2_from_ranks(ranks.astype(np.uint8), in_use)
        pad = np.zeros(n_max, np.int32)
        pad[: z + 1] = ranks
        syms, m, freq = rle2_from_ranks_padded(
            jnp.asarray(pad), np.int32(z + 1), np.int32(10), n_max
        )
        assert np.array_equal(np.asarray(syms)[: int(m)], ref.symbols)
        assert np.array_equal(np.asarray(freq)[: ref.alpha_size], ref.freq)


class TestDeviceInverseBwt:
    """ops/ibwt_jax.py: pointer-jumping inverse BWT, incl the multi-cycle
    LF permutations of exactly periodic blocks."""

    def test_roundtrip_vs_encoder(self, rng):
        import jax.numpy as jnp

        from starch3_tpu.codec.bwt import bwt_encode
        from starch3_tpu.ops.ibwt_jax import ibwt_padded

        n_max = 1024
        for trial in range(12):
            n = int(rng.integers(1, n_max))
            if trial % 3 == 0:
                d = np.full(n, 65, np.uint8)  # all-same: n 1-cycles
            elif trial % 3 == 1:
                pat = rng.integers(0, 256, int(rng.integers(1, 5)), dtype=np.uint8)
                d = np.tile(pat, n // len(pat) + 1)[:n]  # periodic
            else:
                d = rng.integers(0, 256, n, dtype=np.uint8)
            last, ptr = bwt_encode(d)
            pad = np.zeros(n_max, np.uint8)
            pad[:n] = last
            out = ibwt_padded(jnp.asarray(pad), np.int32(ptr), np.int32(n), n_max)
            assert np.array_equal(np.asarray(out)[:n], d)


def test_device_rle2_sharded_mesh(rng):
    """device_rle2 fused step on an 8-device mesh: archive bytes stay
    topology-independent and libbz2-identical."""
    import bz2

    from starch3_tpu.parallel.mesh import make_block_mesh
    from starch3_tpu.parallel.pipeline import encode_streams

    mesh = make_block_mesh()
    data = make_bed_text(rng, n=3000)
    enc = encode_streams([data], mesh=mesh, device_rle2=True)[0]
    assert enc.data == bz2.compress(data, 9)


class TestDeviceInverseMtfRle2:
    """ops/imtf_jax.py + ops/irle2_jax.py: the decode-side device kernels.

    Oracle: codec/mtf.mtf_rle2_decode (itself exercised by the bit-exact
    decoder tests), applied to real encoder output so every RUNA/RUNB
    digit pattern and rank distribution comes from the actual format.
    """

    def test_irle2_matches_oracle(self, rng):
        from starch3_tpu.codec.mtf import mtf_ranks, mtf_rle2, symbol_map
        from starch3_tpu.ops.irle2_jax import irle2_decode_jax

        for n in (1, 17, 500, 4096):
            blk = rng.integers(0, 16, n, dtype=np.uint8)  # zero-run heavy
            res = mtf_rle2(blk)
            syms = res.symbols[:-1]  # strip EOB
            _, u2s, n_in = symbol_map(blk)
            want = mtf_ranks(u2s[blk], n_in)
            got = irle2_decode_jax(np.asarray(syms), n_hint=max(n, 8))
            assert got.tolist() == want.tolist()

    def test_imtf_matches_oracle(self, rng):
        from starch3_tpu.codec.mtf import mtf_ranks, symbol_map
        from starch3_tpu.ops.imtf_jax import imtf_decode_jax

        for n in (1, 100, 3000):
            blk = rng.integers(0, 200, n, dtype=np.uint8)
            in_use, u2s, n_in = symbol_map(blk)
            ranks = mtf_ranks(u2s[blk], n_in)
            got = imtf_decode_jax(ranks.astype(np.int32), in_use)
            assert got.tolist() == blk.tolist()

    def test_full_device_decode_chain(self, rng):
        """symbols -> irle2 -> imtf -> ibwt on device == original block."""
        import jax.numpy as jnp

        from starch3_tpu.codec.bwt import bwt_encode
        from starch3_tpu.codec.mtf import mtf_rle2
        from starch3_tpu.ops.ibwt_jax import ibwt_padded
        from starch3_tpu.ops.imtf_jax import imtf_decode_jax
        from starch3_tpu.ops.irle2_jax import irle2_decode_jax

        n = 2500
        blk = rng.integers(0, 8, n, dtype=np.uint8)
        last, ptr = bwt_encode(blk)
        res = mtf_rle2(last)
        ranks = irle2_decode_jax(np.asarray(res.symbols[:-1]), n_hint=4096)
        assert ranks.size == n
        last2 = imtf_decode_jax(ranks.astype(np.int32), res.in_use)
        assert last2.tolist() == last.tolist()
        pad = np.zeros(4096, np.uint8)
        pad[:n] = last2
        out = ibwt_padded(jnp.asarray(pad), np.int32(ptr), np.int32(n), 4096)
        assert np.array_equal(np.asarray(out)[:n], blk)

    def test_irle2_extreme_runs(self):
        """All-zero rank streams: pure RUNA/RUNB digit sequences at and
        around power-of-two run lengths (the bijective-base-2 edge)."""
        from starch3_tpu.codec.mtf import encode_zero_run
        from starch3_tpu.ops.irle2_jax import irle2_decode_jax

        for z in (1, 2, 3, 4, 7, 8, 255, 256, 257, 4095, 4096):
            syms = np.asarray(encode_zero_run(z), dtype=np.int32)
            ranks = irle2_decode_jax(syms, n_hint=8192)
            assert ranks.size == z and not ranks.any()

    def test_imtf_single_symbol_alphabet(self):
        from starch3_tpu.ops.imtf_jax import imtf_decode_jax

        in_use = np.zeros(256, bool)
        in_use[65] = True
        ranks = np.zeros(1000, np.int32)  # rank 0 repeated
        got = imtf_decode_jax(ranks, in_use)
        assert (got == 65).all()

    def test_imtf_worst_case_ranks(self, rng):
        """Ranks that constantly reorder the deep end of the list."""
        from starch3_tpu.codec.mtf import mtf_ranks, symbol_map
        from starch3_tpu.ops.imtf_jax import imtf_decode_jax

        # round-robin over the full byte alphabet maximizes rank depth
        blk = np.tile(np.arange(256, dtype=np.uint8), 8)
        in_use, u2s, n_in = symbol_map(blk)
        ranks = mtf_ranks(u2s[blk], n_in)
        got = imtf_decode_jax(ranks.astype(np.int32), in_use)
        assert got.tolist() == blk.tolist()
