"""Analytic 2D boundary: axis-aligned wall slabs + circle obstacles.

Every shipped 2D WoSt boundary is a box (Taylor-Green square) or an open
channel plus one circle (karman). Replacing the padded segment soup with
closed forms makes each walk step O(1) instead of O(#segments):
  * wall distance/ray: per-axis arithmetic;
  * circle distance: | |x-c| - r |; ray-circle: quadratic;
  * star radius: the closest silhouette of a circle seen from outside is
    its tangent point, at distance sqrt(|x-c|^2 - r^2) — the exact value
    the reference's closest-silhouette query approaches as the polygon
    resolution grows (fcpw_scene_loader.h:621-641 on the shipped 40-gon);
  * open-chain endpoints (e.g. the karman walls' corners) contribute
    always-silhouette points, matching soup2d's s_always handling.

Walls are encoded per side: lo_x, hi_x, lo_y, hi_y; +-inf marks an open
side (karman's inlet/outlet). Normals point out of the fluid.
"""
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

FAR = 1.0e6


class Analytic2D(NamedTuple):
    lo: jax.Array        # (2,) wall positions, -FAR if open
    hi: jax.Array        # (2,) wall positions, +FAR if open
    circles: jax.Array   # (C, 3): cx, cy, r — fluid outside
    sil_pts: jax.Array   # (E, 2) always-silhouette points (chain endpoints)
    bmin: jax.Array      # (2,) scene bbox (escape test)
    bmax: jax.Array


def make_analytic2d(lo, hi, circles=(), sil_pts=(), bbox=None):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    if bbox is None:
        bmin = np.where(np.isfinite(lo) & (np.abs(lo) < FAR), lo, -FAR)
        bmax = np.where(np.isfinite(hi) & (np.abs(hi) < FAR), hi, FAR)
    else:
        bmin, bmax = np.asarray(bbox[0]), np.asarray(bbox[1])
    c = np.asarray(circles, np.float64).reshape(-1, 3)
    sp = np.asarray(sil_pts, np.float64).reshape(-1, 2)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return Analytic2D(lo=f32(lo), hi=f32(hi), circles=f32(c),
                      sil_pts=f32(sp), bmin=f32(bmin), bmax=f32(bmax))


def _wall_dists(g: Analytic2D, x):
    """(..., 4): distances to lo_x, hi_x, lo_y, hi_y walls (FAR if open)."""
    d_lo = x - g.lo          # positive inside
    d_hi = g.hi - x
    return jnp.concatenate([d_lo, d_hi], axis=-1)


def closest_point(g: Analytic2D, x):
    wd = jnp.abs(_wall_dists(g, x))                      # (..., 4)
    best_w = jnp.min(wd, axis=-1)
    if g.circles.shape[0]:
        dc = jnp.linalg.norm(x[..., None, :] - g.circles[:, :2], axis=-1)
        dcs = jnp.abs(dc - g.circles[:, 2])
        best_c = jnp.min(dcs, axis=-1)
        dist = jnp.minimum(best_w, best_c)
    else:
        dist = best_w
    # signed: negative on the fluid side. Inside the bbox and outside all
    # circles -> fluid.
    in_box = jnp.all((x >= g.bmin) & (x <= g.bmax), axis=-1)
    if g.circles.shape[0]:
        in_circle = jnp.any(
            jnp.linalg.norm(x[..., None, :] - g.circles[:, :2], axis=-1)
            < g.circles[:, 2], axis=-1)
    else:
        in_circle = jnp.zeros_like(in_box)
    sign = jnp.where(in_box & ~in_circle, -1.0, 1.0)
    return dist, sign * dist, None, None


def distance(g: Analytic2D, x):
    return closest_point(g, x)[0]


def signed_distance(g: Analytic2D, x):
    return closest_point(g, x)[1]


def inside(g: Analytic2D, x):
    return signed_distance(g, x) < 0.0


def ray_intersect(g: Analytic2D, o, d, t_max):
    """First hit against walls/circles within t_max -> (hit, t, pt, n)."""
    eps = 1e-12
    t_best = jnp.broadcast_to(jnp.inf, t_max.shape)
    n_best = jnp.zeros(o.shape, o.dtype)

    for axis in range(2):
        other = 1 - axis
        for side, w, nrm_sign in ((0, g.lo[axis], -1.0),
                                  (1, g.hi[axis], 1.0)):
            denom = d[..., axis]
            t = (w - o[..., axis]) / jnp.where(jnp.abs(denom) < eps, eps,
                                               denom)
            # walls span only the scene bbox along the tangential axis —
            # rays through an open side must escape, not hit the plane's
            # continuation outside the domain
            tang = o[..., other] + t * d[..., other]
            in_span = (tang >= g.bmin[other] - 1e-6) \
                & (tang <= g.bmax[other] + 1e-6)
            ok = (jnp.abs(denom) >= eps) & (t > 0.0) & (jnp.abs(w) < FAR) \
                & in_span
            t = jnp.where(ok, t, jnp.inf)
            better = t < t_best
            t_best = jnp.where(better, t, t_best)
            n = jnp.zeros(o.shape, o.dtype).at[..., axis].set(nrm_sign)
            n_best = jnp.where(better[..., None], n, n_best)

    if g.circles.shape[0]:
        oc = o[..., None, :] - g.circles[:, :2]            # (..., C, 2)
        b = jnp.sum(oc * d[..., None, :], axis=-1)
        c = jnp.sum(oc * oc, axis=-1) - g.circles[:, 2] ** 2
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        t = jnp.where(t1 > 0.0, t1, jnp.where(t2 > 0.0, t2, jnp.inf))
        t = jnp.where(disc >= 0.0, t, jnp.inf)
        # winning circle via min + one-hot weighted sum, NOT argmin +
        # take_along_axis/row-gather: a gather-free select (chosen on
        # another accelerator; not yet timed against a gather on the GPU)
        tc = jnp.min(t, axis=-1)
        better = tc < t_best
        onehot = (jax.lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)
                  == jnp.argmin(t, axis=-1)[..., None]).astype(t.dtype)
        center = jnp.sum(onehot[..., None] * g.circles[:, :2], axis=-2)
        radius = jnp.sum(onehot * g.circles[:, 2], axis=-1)
        pt_c = o + tc[..., None] * d
        # normal toward the center (out of the fluid, into the obstacle)
        n_c = (center - pt_c) / jnp.maximum(radius[..., None], 1e-20)
        t_best = jnp.where(better, tc, t_best)
        n_best = jnp.where(better[..., None], n_c, n_best)

    hit = jnp.isfinite(t_best) & (t_best <= t_max)
    t_hit = jnp.where(hit, t_best, t_max)
    return hit, t_hit, o + t_hit[..., None] * d, n_best


def has_line_of_sight(g: Analytic2D, x, y):
    d = y - x
    ln = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(ln, 1e-20)[..., None]
    hit, _, _, _ = ray_intersect(g, x, dn, ln * (1.0 - 1e-5))
    return ~hit


def star_radius(g: Analytic2D, x, min_radius, max_radius):
    """Closest silhouette: circle tangent distance + endpoint distances.
    Walls/box are convex from inside -> no silhouettes of their own."""
    best = jnp.broadcast_to(jnp.asarray(FAR, x.dtype), x.shape[:-1])
    if g.circles.shape[0]:
        d2 = jnp.sum((x[..., None, :] - g.circles[:, :2]) ** 2, axis=-1)
        tang = jnp.sqrt(jnp.maximum(d2 - g.circles[:, 2] ** 2, 0.0))
        best = jnp.minimum(best, jnp.min(tang, axis=-1))
    if g.sil_pts.shape[0]:
        dd = jnp.linalg.norm(x[..., None, :] - g.sil_pts, axis=-1)
        best = jnp.minimum(best, jnp.min(dd, axis=-1))
    r = jnp.where(best < max_radius, best, max_radius)
    return jnp.maximum(r, min_radius)


def dist_to_far_bbox_corner(g: Analytic2D, x):
    far = jnp.maximum(jnp.abs(x - g.bmin), jnp.abs(x - g.bmax))
    return jnp.linalg.norm(far, axis=-1)


def outside_bbox(g: Analytic2D, x):
    return jnp.any((x < g.bmin) | (x > g.bmax), axis=-1)
