"""starch3-tpu: a Starch genomic-interval codec on JAX accelerators.

A brand-new JAX/XLA implementation of the capabilities of the
reference ``starch3`` C++ scaffold (SURVEY.md): it compresses
sorted BED interval data into a Starch archive (magic bytes, independent
per-chromosome bzip2 streams, JSON metadata index, footer) and decompresses
it back, bit-exactly.

Reference behavior being reimplemented (not ported):
  - CLI surface:          reference src/starch3.cpp:72-274
  - archive magic bytes:  reference include/starch3api.hpp:907-910
  - delta transform:      reference include/starch3api.hpp:409-557
  - bzip2 backend:        reference third-party/bzip2-1.0.6 (patched), used at
                          blockSize100k=9, workFactor=30
                          (include/starch3api.hpp:835-837)
  - JSON metadata:        reference links jansson-2.9 (include/starch3api.hpp:17)
                          but never calls it; the intended per-chromosome
                          index is implemented here for real.

Architecture (device-first, not a translation):
  - ``bed``:       host-side vectorized BED tokenizer/writer (NumPy), replacing
                   the reference's char-at-a-time state machine
                   (starch3api.hpp:220-297).
  - ``transform``: columnar delta/offset transform and inverse as JAX ops
                   (diff + associative scan), replacing the sequential
                   ``update_transformation_state`` loop.
  - ``codec``:     from-scratch bzip2-compatible encoder/decoder. NumPy oracle
                   implementation validated bit-exactly against libbz2, plus
                   JAX kernels for the hot stages (BWT sort, MTF scan,
                   group-cost matmuls).
  - ``parallel``:  jax.sharding.Mesh / pjit batch-of-blocks pipeline and
                   deterministic chromosome-order archive assembly.
  - ``format``:    .starch archive reader/writer + metadata schema.
  - ``runtime``:   C++ host runtime for bit-packing / stream assembly.
"""

from starch3_tpu._version import __version__

__all__ = ["__version__"]


def __getattr__(name):
    """Lazy re-exports so ``import starch3_tpu`` stays light (no JAX import
    until the compute path is actually used)."""
    from importlib import import_module

    lazy = {
        "ARCHIVE_MAGIC": ("starch3_tpu.format.archive", "ARCHIVE_MAGIC"),
        "StarchReader": ("starch3_tpu.format.archive", "StarchReader"),
        "StarchWriter": ("starch3_tpu.format.archive", "StarchWriter"),
        "read_archive": ("starch3_tpu.format.archive", "read_archive"),
        "write_archive": ("starch3_tpu.format.archive", "write_archive"),
        "compress_bed_bytes": ("starch3_tpu.api", "compress_bed_bytes"),
        "decompress_starch_bytes": ("starch3_tpu.api", "decompress_starch_bytes"),
    }
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(import_module(mod), attr)
    raise AttributeError(f"module 'starch3_tpu' has no attribute {name!r}")
