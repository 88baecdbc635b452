"""Image-driven PDE scenes: boundary OBJ + PFM/PNG data images.

Rebuild of the zombie demo's primary scene constructor
(reference: bindings/zombie/demo/scene.h:22-52 loads a boundary OBJ plus
sourceValue / isNeumann / dirichletBoundaryValue / neumannBoundaryValue
images; demo/scenes/engine/ ships a worked example). The fluid repo's
copy comments the boundary-value images out, but the shipped engine
config (`scenes/engine/wost.json`) and its committed solution
(`scenes/engine/solutions/wost.pfm`) exercise the full mixed-BC path —
this module reproduces it on the JAX estimator.

Conventions, matched to the reference and verified empirically against
the engine assets (the is_neumann mask is perfectly bimodal at segment
midpoints only under this mapping — ambiguity 0.000 vs 0.003 flipped):
  * uv = (x - bbox.min) / max(bbox.extent)   (scene.h:80, onNeumannBoundary);
  * nearest-cell lookup row = int(uv.y * h), col = int(uv.x * w), both
    clamped (demo/image.h:53-58), on the image in its top-down (PIL /
    utils.pfm.read_pfm) orientation — the engine PFMs equal their PNGs
    under exactly this convention;
  * a boundary segment is Neumann iff is_neumann(midpoint uv) > 0.5
    (upstream zombie's separateBoundaries; the demo's Image<1> maps
    grayscale > 0 but the mask is binary);
  * 3-channel images collapse to luma (image.h:72-82 setFromRGB).
"""
import numpy as np
import jax.numpy as jnp

from ..geometry.obj_io import read_obj_2d
from ..geometry.soup2d import build_segments
from ..utils.pfm import read_pfm
from ..wost.solver import WostScene

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def load_gray(path):
    """Grayscale image as a top-down (H, W) float32 array.

    PFM: utils.pfm.read_pfm (already top-down); PNG via PIL, scaled
    to [0, 1] like the reference's stb loader (image.h:166)."""
    p = str(path)
    if p.endswith(".pfm"):
        arr, _ = read_pfm(p)
    else:
        from PIL import Image
        arr = np.asarray(Image.open(p), np.float32)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        if arr.ndim == 3:
            arr = arr[..., :3] / 255.0
        else:
            arr = arr / 255.0
    if arr.ndim == 3:
        arr = arr @ _LUMA
    return np.ascontiguousarray(arr, np.float32)


def image_lookup_fn(arr, bmin, scale):
    """x (..., 2) -> nearest-cell image value under the demo's uv map."""
    img = jnp.asarray(arr)
    h, w = arr.shape
    bmin = jnp.asarray(bmin, jnp.float32)

    def fn(x, *_):
        uv = (x - bmin) / scale
        j = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
        i = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
        return img[i, j]
    return fn


def scene_from_images(boundary_obj, *, source=None, dirichlet_value=None,
                      neumann_value=None, is_neumann=None, absorption=0.0,
                      flip_orientation=True, normalize=False):
    """Build a mixed-BC WostScene from a 2D boundary OBJ + data images.

    Image arguments accept a path (pfm/png) or a (H, W) array; None means
    the corresponding data is identically zero (is_neumann None = all
    Neumann, the fluid default). flip_orientation reverses every segment
    (scene.h:119-126, default true in the demo ctor); normalize recenters
    to the unit disk (scene.h:132-143).

    Returns (scene, meta) with meta = dict(bmin, bmax, scale, verts,
    segs, is_neumann_seg) for grid construction and introspection."""
    verts, segs = read_obj_2d(boundary_obj)
    verts = np.asarray(verts, np.float64)
    segs = np.asarray(segs, np.int64)
    if flip_orientation:
        segs = segs[:, ::-1]
    if normalize:
        verts = verts - verts.mean(0)
        verts = verts / np.linalg.norm(verts, axis=1).max()
    bmin, bmax = verts.min(0), verts.max(0)
    scale = float((bmax - bmin).max())

    def _load(im):
        if im is None:
            return None
        return im if isinstance(im, np.ndarray) else load_gray(im)

    def _host_lookup(arr, pts):
        uv = (pts - bmin) / scale
        h, w = arr.shape
        j = np.clip((uv[:, 0] * w).astype(int), 0, w - 1)
        i = np.clip((uv[:, 1] * h).astype(int), 0, h - 1)
        return arr[i, j]

    isn = _load(is_neumann)
    if isn is None:
        neu_mask = np.ones(len(segs), bool)
    else:
        mid = 0.5 * (verts[segs[:, 0]] + verts[segs[:, 1]])
        neu_mask = _host_lookup(isn, mid) > 0.5

    neu_segs = segs[neu_mask]
    dir_segs = segs[~neu_mask]
    if len(neu_segs) == 0:
        raise ValueError("scene_from_images needs at least one Neumann "
                         "segment (the estimator's star geometry is the "
                         "Neumann soup)")
    neumann = build_segments([(verts, neu_segs)])
    dirichlet = (build_segments([(verts, dir_segs)])
                 if len(dir_segs) else None)

    src = _load(source)
    dbv = _load(dirichlet_value)
    nbv = _load(neumann_value)
    zero = lambda x, *a: jnp.zeros(x.shape[:-1], jnp.float32)
    scene = WostScene(
        dim=2, neumann=neumann,
        source_fn=(image_lookup_fn(src, bmin, scale) if src is not None
                   else zero),
        absorption=float(absorption),
        dirichlet=dirichlet,
        dirichlet_fn=(image_lookup_fn(dbv, bmin, scale)
                      if dbv is not None and dirichlet is not None
                      else None),
        neumann_fn=(image_lookup_fn(nbv, bmin, scale)
                    if nbv is not None else None))
    meta = dict(bmin=bmin, bmax=bmax, scale=scale, verts=verts, segs=segs,
                is_neumann_seg=neu_mask)
    return scene, meta
