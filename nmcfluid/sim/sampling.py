"""Training-point samplers with static shapes.

Replaces src/{2d,3d}/utils/model_utils.py. Two deviations, both deliberate:
  * grids use indexing='ij' in both dimensions (the reference mixes 'xy' in
    2D and 'ij' in 3D, model_utils.py 2d:15 / 3d:24) — all consumers in this
    framework agree on the 'ij' layout;
  * the 3D reference builds the z axis with res_y points (a slip at
    3d/model_utils.py:17); here each axis gets its own count.

Where the reference drops samples inside obstacles (dynamic shapes,
base.py:239-249), `fluid_points` re-draws rejected slots a fixed number of
rounds and returns a validity mask — shapes stay static for XLA.
"""

import jax
import jax.numpy as jnp


def grid_resolutions(scene_size, resolution):
    """Aspect-scaled per-axis counts: the LONGEST box edge gets
    `resolution` cells and the others scale down (model_utils.py 2d:4-7,
    3d:4-13 — e.g. the karman channel at 1000 gives 1000 x 399, not
    2505 x 1000)."""
    dim = len(scene_size) // 2
    ext = [scene_size[2 * i + 1] - scene_size[2 * i] for i in range(dim)]
    m = max(ext)
    return tuple(max(1, int(round(resolution * e / m))) for e in ext)


def uniform_grid(scene_size, resolution, with_boundary=False):
    """Cell-centered uniform grid over the scene box; with_boundary appends
    the box faces (model_utils.py 2d:9-20). Returns (res_x[, res_y, res_z],
    dim)."""
    dim = len(scene_size) // 2
    res = grid_resolutions(scene_size, resolution)
    axes = []
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        a = (jnp.arange(res[i], dtype=jnp.float32) + 0.5) / res[i]
        if with_boundary:
            a = jnp.concatenate([jnp.zeros(1), a, jnp.ones(1)])
        axes.append(lo + a * (hi - lo))
    return jnp.stack(jnp.meshgrid(*axes, indexing="ij"), axis=-1)


def random_points(key, n, scene_size):
    """Uniform random points in the scene box (model_utils.py 2d:22-31)."""
    dim = len(scene_size) // 2
    u = jax.random.uniform(key, (n, dim))
    lo = jnp.asarray([scene_size[2 * i] for i in range(dim)], jnp.float32)
    hi = jnp.asarray([scene_size[2 * i + 1] for i in range(dim)], jnp.float32)
    return lo + u * (hi - lo)


def training_points(key, n, scene, pattern="random", resolution=None):
    """sample_in_training's three patterns (base.py:226-251): 'random',
    'uniform' (cell-centered grid + boundary), 'random+uniform' (half
    each). Non-random patterns are truncated/padded to n for static
    shapes. Returns (pts, valid)."""
    if pattern == "random":
        return fluid_points(key, n, scene)
    grid = uniform_grid(scene.scene_size, resolution or
                        int(round(n ** (1.0 / scene.dim))),
                        with_boundary=True).reshape(-1, scene.dim)
    if pattern == "uniform":
        reps = -(-n // grid.shape[0])
        pts = jnp.tile(grid, (reps, 1))[:n]
        return pts, scene.fluid_mask(pts)
    if pattern == "random+uniform":
        half = n // 2
        r, rv = fluid_points(key, n - half, scene)
        reps = -(-half // grid.shape[0])
        g = jnp.tile(grid, (reps, 1))[:half]
        pts = jnp.concatenate([r, g])
        return pts, jnp.concatenate([rv, scene.fluid_mask(g)])
    raise NotImplementedError(pattern)


def fluid_points(key, n, scene, rounds: int = 8):
    """Random points restricted to the fluid region by fixed-round rejection.

    Returns (pts (n, dim), valid (n,) bool). After `rounds` re-draws the
    leftover invalid slots (measure ~ (obstacle fraction)^rounds) are flagged
    so callers can zero their loss weight — the reference instead shrinks
    the batch (base.py:239-249)."""
    if not (scene.has_obstacle or scene.name == "jpipe"):
        return random_points(key, n, scene.scene_size), \
            jnp.ones((n,), bool)

    def body(i, carry):
        pts, valid = carry
        cand = random_points(jax.random.fold_in(key, i), n, scene.scene_size)
        cand_ok = scene.fluid_mask(cand)
        take = ~valid & cand_ok
        pts = jnp.where(take[:, None], cand, pts)
        return pts, valid | cand_ok

    pts0 = random_points(jax.random.fold_in(key, 0), n, scene.scene_size)
    valid0 = scene.fluid_mask(pts0)
    pts, valid = jax.lax.fori_loop(1, rounds, body, (pts0, valid0))
    return pts, valid


def bilinear_lookup(grid, scene_size, y):
    """Multilinear gather into a cell-centered grid over the scene box
    (same layout as nearest_lookup; clamped at the walls). Used where the
    deterministic projection needs sub-cell accuracy — the reference has
    no equivalent (its grid lookups are all nearest-texel)."""
    dim = y.shape[-1]
    res = grid.shape
    i0s, ws = [], []
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * res[i] - 0.5
        i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, res[i] - 2)
        i0s.append(i0)
        ws.append(jnp.clip(u - i0.astype(u.dtype), 0.0, 1.0))
    flat_grid = grid.reshape(-1)
    out = jnp.zeros(y.shape[:-1], grid.dtype)
    for corner in range(1 << dim):
        flat = jnp.zeros(y.shape[:-1], jnp.int32)
        w = jnp.ones(y.shape[:-1], grid.dtype)
        for i in range(dim):
            hi_bit = (corner >> i) & 1
            flat = flat * res[i] + i0s[i] + hi_bit
            w = w * (ws[i] if hi_bit else 1.0 - ws[i])
        out = out + w * jnp.take(flat_grid, flat)
    return out


def nearest_lookup(grid, scene_size, y):
    """Nearest-cell gather into a cell-centered grid over the scene box.

    Equivalent of the C++ nearest-texel source lookup
    (demo/image.h:53-58 in 2D, demo/scene_3d.h:102-128 in 3D). grid:
    (res_x[, res_y, res_z]); y: (..., dim). Out-of-box queries clamp."""
    dim = y.shape[-1]
    res = grid.shape
    idxs = []
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * res[i]
        idxs.append(jnp.clip(u.astype(jnp.int32), 0, res[i] - 1))
    flat = idxs[0]
    for i in range(1, dim):
        flat = flat * res[i] + idxs[i]
    return jnp.take(grid.reshape(-1), flat)
