"""chip_smoke.py's phases on the CPU at tiny sizes, its refusal to run
without a GPU, and the compile-cache placement every entry point uses.

The phases themselves run on the card (``python3 chip_smoke.py``); here
they run on the 8-virtual-device CPU backend so that their control flow
and checks are exercised by the ordinary suite.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke
from tests.conftest import make_bed_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MAX = 16_384


def _tiny_corpora(rng) -> dict:
    """One block per alphabet class, each small enough for N_MAX."""
    texts = {
        4: chip_smoke.transformed_texts(make_bed_text(rng, n=900)),
        5: chip_smoke.transformed_texts(make_bed_text(rng, n=900, with_remainder=True)),
        6: chip_smoke.transformed_texts(bench.make_genome_bed_bits6(n_per=40)),
        8: chip_smoke.transformed_texts(chip_smoke.make_wide_alphabet_bed(250)),
    }
    return {bits: [b"".join(t)[:12_000]] for bits, t in texts.items()}


def test_phase_device_reports_backend():
    info = chip_smoke.phase_device(require_gpu=False)
    assert info == {"platform": "cpu", "kind": info["kind"], "count": 8}


def test_phase_device_requires_gpu():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.phase_device()


def test_phase_kernels_every_tier(rng):
    chip_smoke.phase_kernels(_tiny_corpora(rng), n_max=N_MAX, batch=1)


def test_full_blocks_checks_class(rng):
    texts = _tiny_corpora(rng)[4]
    assert len(chip_smoke.full_blocks(texts, 4, 1)) == 1
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.full_blocks(texts, 5, 1)


def test_wide_alphabet_bed_is_bits8():
    from starch3_tpu.parallel.pipeline import _bits_class

    text = b"".join(chip_smoke.transformed_texts(chip_smoke.make_wide_alphabet_bed(500)))
    assert _bits_class(len(set(text))) == 8


@pytest.mark.parametrize("with_remainder", [False, True])
def test_encode_and_compare(rng, tmp_path, with_remainder):
    bed = make_bed_text(rng, n=1500, with_remainder=with_remainder)
    archive = chip_smoke.encode_and_compare("encode", "tiny", bed, str(tmp_path))
    assert archive[:4] == bytes.fromhex("ca5cad1a")


def test_phase_device_only(rng):
    texts = chip_smoke.transformed_texts(make_bed_text(rng, n=1200))
    chip_smoke.phase_device_only(texts)
    assert "STARCH3_TPU_NO_HOST_FALLBACK" not in os.environ


def test_phase_decode(rng, tmp_path):
    from starch3_tpu.api import compress_bed_bytes

    bed = make_bed_text(rng, n=900, chroms=("chr1", "chr21", "chrX"))
    chip_smoke.phase_decode(bed, compress_bed_bytes(bed), str(tmp_path))


def test_phase_mesh_four_devices(rng):
    texts = chip_smoke.transformed_texts(
        make_bed_text(rng, n=1200, chroms=("chr1", "chr2", "chr3", "chr4", "chr5"))
    )
    chip_smoke.phase_mesh(texts, 4)


def test_main_rejects_unknown_arguments(capsys):
    assert chip_smoke.main(["--bogus"]) == 2
    assert '"ok"' not in capsys.readouterr().out


def _run_script(cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_fails_without_gpu():
    r = _run_script(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_script_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


class TestCompileCache:
    def test_external_dir_wins(self, monkeypatch, tmp_path):
        import jax

        from starch3_tpu.compile_cache import use_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert use_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        import jax

        from starch3_tpu.compile_cache import DEFAULT_DIR, use_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            assert use_compile_cache() == DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
