"""Device mesh construction and sharded batch-encode dispatch.

The reference's only parallelism is 4 pthreads serialized on one mutex
(reference src/starch3.cpp:36-54, starch3api.hpp:67 — effective
concurrency ~1).  The replacement is data parallelism over independent
900 kB blocks: a 1-D ``jax.sharding.Mesh`` over all devices, block
batches sharded on the leading axis, XLA compiling one program that every
device runs on its shard (SPMD).  No collectives are needed for encode
itself — blocks are independent; ordered offset/metadata assembly is a
host-side gather (parallel/assemble.py).  On GPUs of one host the mesh
is 1-D because the cards are joined all to all.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_block_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (BLOCK_AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-blocks arrays: leading axis sharded across chips."""
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(n: int, n_devices: int) -> int:
    """Blocks per dispatch must divide evenly across devices."""
    return ((n + n_devices - 1) // n_devices) * n_devices
