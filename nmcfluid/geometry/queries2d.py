"""Brute-force vectorized geometric queries over 2D segment soups.

Replaces the FCPW-backed closure bundle GeometricQueries<2>
(reference: bindings/zombie/include/zombie/core/geometric_queries.h:42-71,
populated at bindings/zombie/include/zombie/utils/fcpw_scene_loader.h:293-652).
Each query broadcasts a batch of points x (..., 2) against the padded
primitive arrays (P, 2) and reduces — pure VPU work, no data-dependent
control flow.
"""
import jax
import jax.numpy as jnp

from . import analytic2d
from .analytic2d import Analytic2D
from .soup2d import Seg2D, FAR


def _dispatch(name):
    """Route Analytic2D boundaries to their closed-form queries; padded
    segment soups keep the brute-force path."""
    def deco(fn):
        afn = getattr(analytic2d, name)

        def wrapper(soup, *a, **kw):
            if isinstance(soup, Analytic2D):
                return afn(soup, *a, **kw)
            return fn(soup, *a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper
    return deco

OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


def _onehot_argmin(v):
    """(..., P) -> f32 one-hot of the per-lane argmin. Lets winner data
    be selected with a masked reduce instead of a serialized gather."""
    return (jax.lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
            == jnp.argmin(v, axis=-1)[..., None]).astype(jnp.float32)


@_dispatch("closest_point")
def closest_point(soup: Seg2D, x):
    """Closest boundary point. Returns (dist, signed_dist, point, normal).

    signed_dist carries the side: negative inside the fluid (normals point
    out of the domain), mirroring fcpw's Interaction::signedDistance.
    """
    a, b = soup.a, soup.b                       # (P, 2)
    ab = b - a
    denom = jnp.maximum(jnp.sum(ab * ab, -1), 1e-20)
    xa = x[..., None, :] - a                    # (..., P, 2)
    t = jnp.clip(jnp.sum(xa * ab, -1) / denom, 0.0, 1.0)
    p = a + t[..., None] * ab                   # (..., P, 2)
    d2 = jnp.sum((x[..., None, :] - p) ** 2, -1)
    # min + one-hot selects, not argmin + take_along_axis/row-gathers:
    # a (..., P) masked reduce with no gather (chosen on another
    # accelerator; not yet timed against a gather on the GPU)
    oh = _onehot_argmin(d2)
    dist = jnp.sqrt(jnp.min(d2, axis=-1))
    pt = jnp.sum(oh[..., None] * p, axis=-2)
    nrm = jnp.sum(oh[..., None] * soup.n, axis=-2)
    sign = jnp.where(jnp.sum((x - pt) * nrm, -1) < 0.0, -1.0, 1.0)
    return dist, sign * dist, pt, nrm


@_dispatch("distance")
def distance(soup: Seg2D, x):
    return closest_point(soup, x)[0]


@_dispatch("signed_distance")
def signed_distance(soup: Seg2D, x):
    return closest_point(soup, x)[1]


@_dispatch("inside")
def inside(soup: Seg2D, x):
    """insideDomain: sign of the signed distance (fcpw_scene_loader.h:642-648)."""
    return signed_distance(soup, x) < 0.0


@_dispatch("ray_intersect")
def ray_intersect(soup: Seg2D, o, d, t_max):
    """First ray hit against the soup within t_max.

    o, d: (..., 2); t_max: (...). Returns (hit, t, point, normal) with the
    segment's stored normal (matching fcpw's Interaction for line segments).
    """
    a, b = soup.a, soup.b
    ab = b - a                                   # (P, 2)
    ao = a - o[..., None, :]                     # (..., P, 2)
    dxab = d[..., None, 0] * ab[..., 1] - d[..., None, 1] * ab[..., 0]
    safe = jnp.where(jnp.abs(dxab) < 1e-12, 1.0, dxab)
    t = (ao[..., 0] * ab[..., 1] - ao[..., 1] * ab[..., 0]) / safe
    s = (ao[..., 0] * d[..., None, 1] - ao[..., 1] * d[..., None, 0]) / safe
    ok = ((jnp.abs(dxab) >= 1e-12) & (s >= 0.0) & (s <= 1.0)
          & (t > 0.0) & (t <= t_max[..., None]))
    t = jnp.where(ok, t, jnp.inf)
    t_hit = jnp.min(t, axis=-1)        # gather-free select (see above)
    nrm = jnp.sum(_onehot_argmin(t)[..., None] * soup.n, axis=-2)
    hit = jnp.isfinite(t_hit)
    t_hit = jnp.where(hit, t_hit, t_max)
    pt = o + t_hit[..., None] * d
    return hit, t_hit, pt, nrm


@_dispatch("has_line_of_sight")
def has_line_of_sight(soup: Seg2D, x, y):
    """True if the open segment x->y does not cross the soup
    (fcpw Aggregate::hasLineOfSight, used by intersectsWithNeumann)."""
    d = y - x
    ln = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(ln, 1e-20)[..., None]
    hit, t, _, _ = ray_intersect(soup, x, dn, ln * (1.0 - 1e-5))
    return ~hit


@_dispatch("star_radius")
def star_radius(soup: Seg2D, x, min_radius, max_radius):
    """Distance to the closest silhouette vertex, else max_radius.

    computeStarRadius (fcpw_scene_loader.h:621-641): a vertex is a
    silhouette w.r.t. x when its two adjacent segments face opposite sides
    (one front-facing, one back-facing), or always for open-chain
    endpoints; statically-convex vertices were dropped at build time.
    """
    if soup.sv.shape[0] == 0:
        return jnp.maximum(max_radius, min_radius)
    xv = x[..., None, :] - soup.sv               # (..., V, 2)
    d1 = jnp.sum(xv * soup.sn1, -1)
    d2 = jnp.sum(xv * soup.sn2, -1)
    is_sil = (d1 * d2 <= 0.0) | soup.s_always
    dist = jnp.sqrt(jnp.sum(xv * xv, -1))
    dist = jnp.where(is_sil, dist, FAR)
    closest = jnp.min(dist, axis=-1)
    r = jnp.where(closest < max_radius, closest, max_radius)
    return jnp.maximum(r, min_radius)


@_dispatch("dist_to_far_bbox_corner")
def dist_to_far_bbox_corner(soup: Seg2D, x):
    """zombie's computeDistToDirichlet fallback when there is no Dirichlet
    boundary: sqrt of the max squared distance to the bounding box
    (fcpw_scene_loader.h:299-315) — effectively 'very far', so walks only
    end by Russian roulette or the step cap."""
    far = jnp.maximum(jnp.abs(x - soup.bmin), jnp.abs(x - soup.bmax))
    return jnp.linalg.norm(far, axis=-1)


@_dispatch("outside_bbox")
def outside_bbox(soup: Seg2D, x):
    return jnp.any((x < soup.bmin) | (x > soup.bmax), axis=-1)
