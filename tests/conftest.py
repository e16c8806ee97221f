"""Test configuration.

Multi-device tests follow the standard JAX trick (SURVEY.md §4): force the
CPU backend with 8 virtual devices so mesh/pjit sharding runs as it does
across several real devices.  Must be set before JAX initializes.
"""

import os

# STARCH3_TEST_GPU=1 leaves the GPU visible so the @pytest.mark.gpu lane
# (tests/test_gpu.py) exercises the card; the default pins the CPU so
# the suite is hermetic and the virtual 8-device mesh works (the gpu
# lane's fixture then skips its tests).
_GPU_LANE = os.environ.get("STARCH3_TEST_GPU") == "1"

if not _GPU_LANE:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if not _GPU_LANE and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# the config knob as well as the env var: it is honoured even when a
# platform was already chosen by the environment (must run before the
# backend initializes)
import jax

if not _GPU_LANE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_bed_text(
    rng: np.random.Generator,
    n: int = 1000,
    chroms=("chr1", "chr2", "chrX"),
    with_remainder: bool = False,
    max_gap: int = 1000,
    max_len: int = 500,
) -> bytes:
    """Generate sorted BED text (the reference's input grammar:
    chr \t start \t stop [\t remainder] \n; starch3api.hpp:239-307)."""
    lines = []
    for ci, chrom in enumerate(chroms):
        pos = 0
        count = n // len(chroms)
        starts = np.cumsum(rng.integers(1, max_gap, count))
        lens = rng.integers(1, max_len, count)
        for i in range(count):
            s = int(starts[i])
            e = s + int(lens[i])
            if with_remainder:
                lines.append(
                    b"%s\t%d\t%d\tid-%d\t%d\t%s"
                    % (
                        chrom.encode(),
                        s,
                        e,
                        i,
                        int(rng.integers(0, 1000)),
                        b"+" if rng.integers(0, 2) else b"-",
                    )
                )
            else:
                lines.append(b"%s\t%d\t%d" % (chrom.encode(), s, e))
    return b"\n".join(lines) + b"\n"


def skip_if_asan() -> None:
    """Skip a test that triggers XLA compilation when ASan is preloaded:
    the preloaded allocator aborts inside XLA's own allocation paths,
    independent of this repo's native code.  The CI sanitizer lane exists
    to cover the native tier (runtime.cpp), which these tests exercise
    through non-JAX paths elsewhere."""
    import os

    import pytest

    if "libasan" in os.environ.get("LD_PRELOAD", ""):
        pytest.skip("jax compile is incompatible with ASan preload")
