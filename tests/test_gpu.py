"""GPU test lane (@pytest.mark.gpu).

Run on a host with an NVIDIA GPU (one process per card):

    STARCH3_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu -q

The default suite pins the CPU backend (tests/conftest.py), so the
fixture below skips these there; on the card they compile and execute
the device tiers and the full pipeline against the host oracles.
``chip_smoke.py`` runs this lane in its own process as its last phase.
"""

import os

import numpy as np
import pytest

from tests.conftest import make_bed_text

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    """Decided per test, never at import: every xdist worker must
    collect the same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with STARCH3_TEST_GPU=1 on one)")


@pytest.mark.parametrize("width", [16, 32, 64, 256])
def test_mtf_ranks_on_chip(rng, width):
    """The compiled MTF formulation at every tier width vs the oracle,
    at a full block's geometry."""
    import jax.numpy as jnp

    from starch3_tpu.codec.mtf import mtf_ranks
    from starch3_tpu.ops.mtf_jax import mtf_ranks as mtf_ranks_device

    n_max = 901_120
    seqs = rng.integers(0, min(width, 40), (2, n_max)).astype(np.int32)
    seqs[0, 7] = width - 1  # rare symbol: recency carry across tiles
    lens = np.array([n_max, n_max - 1000], np.int32)
    out = np.asarray(
        mtf_ranks_device(jnp.asarray(seqs), jnp.asarray(lens), n_max, width)
    )
    for i in range(2):
        assert np.array_equal(out[i, : lens[i]], mtf_ranks(seqs[i, : lens[i]], width))
    assert not out[1, lens[1]:].any()


def test_bwt_sort_fast3_on_chip(rng):
    import jax.numpy as jnp

    from starch3_tpu.codec.bwt import bwt_encode
    from starch3_tpu.ops.bwt_fast import bwt_sort_fast3

    seq = rng.integers(0, 14, 5000).astype(np.int32)
    pad = np.zeros(8192, np.int32)
    pad[:5000] = seq
    last, ptr, ties = bwt_sort_fast3(jnp.asarray(pad), jnp.int32(5000), 8192)
    assert int(ties) == 0
    l1, p1 = bwt_encode(seq.astype(np.uint8))
    assert np.asarray(last)[:5000].tolist() == l1.tolist()
    assert int(ptr) == p1


def test_device_pipeline_byte_identity(rng):
    """encode_streams on the chip == host encoder == libbz2, both the
    default fast path and with host_assist off (pure device)."""
    import bz2

    from starch3_tpu.parallel.pipeline import encode_streams

    texts = [
        bytes(make_bed_text(rng, n=4000, chroms=("chr1",))),
        bytes(make_bed_text(rng, n=1500, chroms=("chr2",))),
    ]
    from starch3_tpu.api import _parse_transform

    texts = [tf.text for t in texts for tf in _parse_transform(t)]
    want = [bz2.compress(t, 9) for t in texts]
    got = [s.data for s in encode_streams(texts, host_assist=False)]
    assert got == want
    got2 = [s.data for s in encode_streams(texts)]
    assert got2 == want


def test_device_decode_chain_on_chip(rng):
    """decode_streams (device irle2 -> imtf -> ibwt) round-trips real
    encoder output on the chip."""
    import bz2

    from starch3_tpu.parallel.pipeline import decode_streams

    text = make_bed_text(rng, n=5000)
    stream = bz2.compress(text, 9)
    assert decode_streams([stream]) == [text]


def test_full_archive_jax_equals_host_on_chip(rng):
    from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
    from starch3_tpu.config import EncodeConfig

    bed = make_bed_text(rng, n=6000, with_remainder=True)
    a_jax = compress_bed_bytes(bed, EncodeConfig(use_jax=True))
    a_host = compress_bed_bytes(bed, EncodeConfig(use_jax=False))
    assert a_jax == a_host
    assert decompress_starch_bytes(a_jax) == bed


def test_step_under_shard_map_on_chip(rng):
    """The production steps under a mesh of every visible GPU (shard_map,
    parallel/pipeline._shard_step): the output stays sharded on the
    batch axis and archives are byte-identical to libbz2."""
    import bz2

    import jax
    import jax.numpy as jnp

    from starch3_tpu.parallel.mesh import block_sharding, make_block_mesh
    from starch3_tpu.parallel.pipeline import _jitted_fused_step_ranks4, encode_streams

    mesh = make_block_mesh()
    n_dev = mesh.devices.size
    n_max = 16_384
    step = _jitted_fused_step_ranks4(n_max, mesh)
    packed = jax.device_put(
        jnp.zeros((n_dev, n_max // 2), dtype=jnp.uint8), block_sharding(mesh)
    )
    lens = jax.device_put(jnp.full((n_dev,), n_max - 8, jnp.int32), block_sharding(mesh))
    rows = step(packed, lens)
    assert len(rows.sharding.device_set) == n_dev

    from starch3_tpu.api import _parse_transform

    text = _parse_transform(make_bed_text(rng, n=4000))[0].text
    got = encode_streams([text], mesh=mesh, host_assist=False)[0]
    assert got.data == bz2.compress(text, 9)


def test_device_huffman_tier_on_chip(rng):
    """EncodeConfig(device_huffman=True): device group costing (integer
    matmuls) + device bit-pack must still produce byte-identical
    streams."""
    import bz2

    from starch3_tpu.parallel.pipeline import encode_streams

    from starch3_tpu.api import _parse_transform

    text = _parse_transform(make_bed_text(rng, n=4000))[0].text
    got = encode_streams([text], device_huffman=True, host_assist=False)[0]
    assert got.data == bz2.compress(text, 9)


def _alphabet_text(rng, n_syms: int, n: int = 60_000) -> bytes:
    """A text whose block alphabet has exactly ``n_syms`` distinct
    bytes (printable range, no RLE1 quirks dominating)."""
    al = np.array(
        sorted({48 + (7 * k) % 180 for k in range(n_syms)})[:n_syms],
        np.uint8,
    )
    assert al.size == n_syms
    out = al[rng.integers(0, n_syms, n)]
    # guarantee every symbol appears
    out[:n_syms] = al
    return out.tobytes()


@pytest.mark.parametrize("n_syms,bits", [(21, 5), (43, 6), (100, 8)])
def test_wide_alphabet_tiers_byte_identity_on_chip(rng, n_syms, bits):
    """Per-class routing must land each alphabet on its tier (asserted
    via _bits_class) and the card's output must be byte-identical to
    libbz2 through the production pipeline."""
    import bz2

    from starch3_tpu.parallel.pipeline import _bits_class, encode_streams

    assert _bits_class(n_syms) == bits
    texts = [_alphabet_text(rng, n_syms) for _ in range(3)]
    want = [bz2.compress(t, 9) for t in texts]
    got = [s.data for s in encode_streams(texts, host_assist=False)]
    assert got == want
    # and through the hybrid (host-assist) scheduler
    got2 = [s.data for s in encode_streams(texts)]
    assert got2 == want


def test_bits6_bench_corpus_end_to_end_on_chip(rng):
    """The gene-id/float corpus (bench.make_genome_bed_bits6) rides the
    bits==6 tier end-to-end on the card, archive identical to host."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import make_genome_bed_bits6

    from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes
    from starch3_tpu.config import EncodeConfig

    bed = make_genome_bed_bits6(n_per=4000)
    # keep it small: 3 chromosomes' worth
    bed = b"\n".join(bed.split(b"\n")[: 3 * 4000]) + b"\n"
    a_jax = compress_bed_bytes(bed, EncodeConfig(use_jax=True))
    a_host = compress_bed_bytes(bed, EncodeConfig(use_jax=False))
    assert a_jax == a_host
    assert decompress_starch_bytes(a_jax) == bed
