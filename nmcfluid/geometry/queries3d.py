"""Brute-force vectorized geometric queries over 3D triangle soups.

3D counterpart of queries2d (replaces GeometricQueries<3> as populated by
zombie3d's fcpw_scene_loader.h). Closest-point uses the standard
region-classified point-triangle projection; rays use Moller-Trumbore.
"""
import jax
import jax.numpy as jnp

from . import analytic3d
from .analytic3d import Box3D
from .soup3d import Tri3D, FAR


def _onehot_argmin(v):
    """(..., P) -> f32 one-hot of the per-lane argmin (see queries2d)."""
    return (jax.lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
            == jnp.argmin(v, axis=-1)[..., None]).astype(jnp.float32)


def _dispatch(name):
    """Route Box3D boundaries to closed forms (see queries2d)."""
    def deco(fn):
        afn = getattr(analytic3d, name)

        def wrapper(soup, *a, **kw):
            if isinstance(soup, Box3D):
                return afn(soup, *a, **kw)
            return fn(soup, *a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper
    return deco


OFFSET_EPS = 3e-5


def _closest_on_tri(p, a, b, c):
    """Closest point on triangle abc to p (broadcast-compatible)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, -1)
    d2 = jnp.sum(ac * ap, -1)
    bp = p - b
    d3 = jnp.sum(ab * bp, -1)
    d4 = jnp.sum(ac * bp, -1)
    cp = p - c
    d5 = jnp.sum(ab * cp, -1)
    d6 = jnp.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = jnp.maximum(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    pt_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = jnp.clip(d1 / jnp.maximum(d1 - d3, 1e-30), 0.0, 1.0)
    pt_ab = a + t_ab[..., None] * ab
    t_ac = jnp.clip(d2 / jnp.maximum(d2 - d6, 1e-30), 0.0, 1.0)
    pt_ac = a + t_ac[..., None] * ac
    t_bc = jnp.clip((d4 - d3) / jnp.maximum((d4 - d3) + (d5 - d6), 1e-30),
                    0.0, 1.0)
    pt_bc = b + t_bc[..., None] * (c - b)

    pt = pt_face
    pt = jnp.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], pt_ab, pt)
    pt = jnp.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], pt_ac, pt)
    pt = jnp.where(((va <= 0) & ((d4 - d3) >= 0)
                    & ((d5 - d6) >= 0))[..., None], pt_bc, pt)
    pt = jnp.where(((d1 <= 0) & (d2 <= 0))[..., None], a, pt)
    pt = jnp.where(((d3 >= 0) & (d4 <= d3))[..., None], b, pt)
    pt = jnp.where(((d6 >= 0) & (d5 <= d6))[..., None], c, pt)
    return pt


@_dispatch("closest_point")
def closest_point(soup: Tri3D, x):
    """Returns (dist, signed_dist, point, normal); negative sign = inside."""
    p = _closest_on_tri(x[..., None, :], soup.va, soup.vb, soup.vc)
    d2 = jnp.sum((x[..., None, :] - p) ** 2, -1)
    # min + one-hot masked reduces, not argmin + take_along_axis/row-
    # gathers (see queries2d)
    oh = _onehot_argmin(d2)
    dist = jnp.sqrt(jnp.min(d2, axis=-1))
    pt = jnp.sum(oh[..., None] * p, axis=-2)
    nrm = jnp.sum(oh[..., None] * soup.n, axis=-2)
    sign = jnp.where(jnp.sum((x - pt) * nrm, -1) < 0.0, -1.0, 1.0)
    return dist, sign * dist, pt, nrm


@_dispatch("distance")
def distance(soup: Tri3D, x):
    return closest_point(soup, x)[0]


@_dispatch("signed_distance")
def signed_distance(soup: Tri3D, x):
    return closest_point(soup, x)[1]


@_dispatch("inside")
def inside(soup: Tri3D, x):
    return signed_distance(soup, x) < 0.0


@_dispatch("ray_intersect")
def ray_intersect(soup: Tri3D, o, d, t_max):
    """Moller-Trumbore against all triangles; first hit within t_max."""
    e1 = soup.vb - soup.va
    e2 = soup.vc - soup.va
    pvec = jnp.cross(d[..., None, :], e2)
    det = jnp.sum(e1 * pvec, -1)
    safe = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o[..., None, :] - soup.va
    u = jnp.sum(tvec * pvec, -1) / safe
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d[..., None, :] * qvec, -1) / safe
    t = jnp.sum(e2 * qvec, -1) / safe
    ok = ((jnp.abs(det) >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0) & (t <= t_max[..., None]))
    t = jnp.where(ok, t, jnp.inf)
    t_hit = jnp.min(t, axis=-1)        # gather-free select (see above)
    nrm = jnp.sum(_onehot_argmin(t)[..., None] * soup.n, axis=-2)
    hit = jnp.isfinite(t_hit)
    t_hit = jnp.where(hit, t_hit, t_max)
    pt = o + t_hit[..., None] * d
    return hit, t_hit, pt, nrm


@_dispatch("has_line_of_sight")
def has_line_of_sight(soup: Tri3D, x, y):
    d = y - x
    ln = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(ln, 1e-20)[..., None]
    hit, t, _, _ = ray_intersect(soup, x, dn, ln * (1.0 - 1e-5))
    return ~hit


@_dispatch("star_radius")
def star_radius(soup: Tri3D, x, min_radius, max_radius):
    """Closest silhouette-edge point within max_radius, else max_radius."""
    if soup.ea.shape[0] == 0:
        return jnp.maximum(max_radius, min_radius)
    ea, eb = soup.ea, soup.eb
    e = eb - ea
    denom = jnp.maximum(jnp.sum(e * e, -1), 1e-20)
    xa = x[..., None, :] - ea
    t = jnp.clip(jnp.sum(xa * e, -1) / denom, 0.0, 1.0)
    p = ea + t[..., None] * e
    xp = x[..., None, :] - p
    d1 = jnp.sum(xp * soup.en1, -1)
    d2 = jnp.sum(xp * soup.en2, -1)
    is_sil = (d1 * d2 <= 0.0) | soup.e_always
    dist = jnp.sqrt(jnp.sum(xp * xp, -1))
    dist = jnp.where(is_sil, dist, FAR)
    closest = jnp.min(dist, axis=-1)
    r = jnp.where(closest < max_radius, closest, max_radius)
    return jnp.maximum(r, min_radius)


@_dispatch("dist_to_far_bbox_corner")
def dist_to_far_bbox_corner(soup: Tri3D, x):
    far = jnp.maximum(jnp.abs(x - soup.bmin), jnp.abs(x - soup.bmax))
    return jnp.linalg.norm(far, axis=-1)


@_dispatch("outside_bbox")
def outside_bbox(soup: Tri3D, x):
    return jnp.any((x < soup.bmin) | (x > soup.bmax), axis=-1)
