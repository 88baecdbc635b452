"""Mesh construction and sharding helpers.

The reference has no distributed runtime (SURVEY.md section 2.3): its only
parallelism is TBB fan-out over sample points inside the C++ WoSt solver
(walk_on_stars.h:91-104). The equivalent here is a 1D device mesh over
the *pressure-point* axis: every per-point walk is independent, so
sharding the point cloud shards the entire (n_walks, N) walker-lane array
with zero communication inside the solve. Scalar reductions (mean pressure,
loss values) become psums XLA inserts automatically.

Parameters are tiny (<= ~200k floats) and stay replicated; phase-training
batches are generated per-shard. The mesh is 1D because the cards of one
host reach each other all to all (NVLink); multi-host runs use the same
program on a larger mesh.
"""
import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def points_mesh(n_devices=None, axis_name="points", devices=None):
    """1D mesh over the first n_devices (default all) devices.

    Pass `devices` explicitly (e.g. jax.devices("cpu")) to avoid
    initializing the default backend — jax.devices() with no argument
    would bring up the accelerator even for a CPU-only dry run."""
    devs = jax.devices() if devices is None else list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def shard_points(mesh, arr, axis_name="points"):
    """Shard the leading (point) axis; trailing axes replicated."""
    spec = P(axis_name, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh, tree):
    """Replicate a pytree (network params) across the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))
