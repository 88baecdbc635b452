"""Deterministic boundary-element projection: FFT volume potential +
Nystrom-solved boundary integral equation + kernel splats.

This is a generalization of zombie's boundary value caching
(bindings/zombie/include/zombie/boundary_value_caching/{boundary_sampler,
splatter}.h, rebuilt in nmcfluid.wost.bvc): the reference caches WoSt
*estimates* of the solution at boundary samples and splats them through
the free-space kernels; here the boundary values are *solved for*
directly, so the projection becomes fully deterministic for any 2D scene
— including jpipe's polygonal duct, which neither the DCT box solve nor
the circle-mode correction (ops/circle_modes.py) can handle.

Per projection, for the screened Poisson problem (Lap - sigma) u = -f
with zero-Neumann boundary (the fluid's pressure solve, wost/solver.py):

  1. Volume potential V_f(x) = int_Omega G_sigma(x, y) f(y) dy evaluated
     by FFT convolution of the (domain-masked) divergence grid with a
     precomputed free-space Yukawa kernel grid — G_sigma decays like
     e^{-sqrt(sigma) r} (sqrt(350) ~ 18.7/unit), so the kernel support is
     truncated at negligible error and the padded FFT stays small. Value
     and both gradient components come from three kernel grids sharing
     one forward FFT. Outputs live on the (R+1)^2 *vertex* lattice so
     bilinear interpolation reaches the boundary without extrapolating.
  2. Boundary density: the interior-limit collocation of
     u = V_f - int_Gamma P(x,y) u(y) dS_y at an equispaced midpoint
     cache y_j gives the dense Nystrom system A u_Gamma = V_f|_Gamma.
     A depends only on (scene, sigma, resolution), so its inverse is
     precomputed once on the host in float64 and the per-projection cost
     is a single (B,B)@(B,) matvec. The singular diagonal is fixed by a
     row-sum rule that makes constant solutions exact (u == 1 pairs with
     f == sigma), absorbing both the 1/2 jump term and the neighbor
     quadrature error without curvature formulas.
  3. Splat: u(x) = V_f(x) - sum_j w_j P(x, y_j) (u_j - c(x))
                 + c(x) (1 - V_sigma(x)),  c(x) = u at the nearest cache
     point, and the same with grad_x P / grad V for the gradient. The
     constant-shift c(x) cancels the splat's near-boundary quadrature
     blow-up exactly where it is worst (x approaching Gamma), using the
     precomputed potential V_sigma of f == sigma for the identity
     1 = V_sigma + splat(1). Kernels are the bvc splatter forms
     (splatter.h:46-305 semantics via wost/bvc.py).

Everything per-projection is FFTs, bilinear gathers and one dense
matvec + one (E, B) kernel contraction — zero Monte Carlo variance, no
while_loops, static shapes throughout.

Like the spectral path, the open channel ends (karman inlet/outlet,
jpipe inlet/outlet) are closed with zero-Neumann caps — the same
modeling choice the DCT solve makes on the box, cross-validated against
the WoSt estimator in tests/test_bem.py.
"""
import math
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..wost.bvc import _free_dGdr, _free_dP

_CACHE_VERSION = 1


# ------------------------------------------------------------ host kernels

def _np_G(sigma, r):
    from scipy.special import k0
    return k0(np.sqrt(sigma) * r) / (2.0 * np.pi)


def _np_dGdr(sigma, r):
    from scipy.special import k1
    return -np.sqrt(sigma) * k1(np.sqrt(sigma) * r) / (2.0 * np.pi)


def _np_P(sigma, x, y, n):
    """Poisson kernel P(x, y) = dG/dn_y, pairwise: x (E,2), y/n (B,2)."""
    d = x[:, None, :] - y[None, :, :]
    r = np.sqrt(np.sum(d * d, axis=-1))
    r = np.maximum(r, 1e-300)
    cos = np.sum(d * n[None], axis=-1) / r
    return -_np_dGdr(sigma, r) * cos


# ------------------------------------------------------- boundary sampling

def _densify_loop(verts, max_seg):
    """Subdivide a closed polyline so no segment exceeds max_seg."""
    verts = np.asarray(verts, np.float64)
    out = []
    m = len(verts)
    for i in range(m):
        a, b = verts[i], verts[(i + 1) % m]
        k = max(1, int(np.ceil(np.linalg.norm(b - a) / max_seg)))
        for t in range(k):
            out.append(a + (b - a) * (t / k))
    return np.asarray(out)


def closed_loops(scene):
    """Closed splat boundary for the scene, as a list of vertex loops
    traversed with the fluid on the LEFT (normals (d.y, -d.x) point out
    of the fluid). Open channel ends are capped (see module docstring)."""
    ss = scene.scene_size
    if scene.name == "jpipe":
        # walls from specs._jpipe_boundary plus inlet/outlet caps, one
        # CCW loop around the duct (fluid left throughout)
        th = np.linspace(0.0, 0.5 * np.pi, 41)
        outer = ([(0.0, 0.0)]
                 + [(1.0 + np.sin(t), 1.0 - np.cos(t)) for t in th]
                 + [(2.0, 2.0)])
        inner = ([(0.0, 0.5)]
                 + [(1.0 + 0.5 * np.sin(t), 1.0 - 0.5 * np.cos(t))
                    for t in th]
                 + [(1.5, 2.0)])
        loop = np.asarray(outer + inner[::-1], np.float64)
        return [loop]
    # generic 2D scene: the bbox, CCW (fluid inside)
    xmin, xmax, ymin, ymax = ss[0], ss[1], ss[2], ss[3]
    loops = [np.asarray([(xmin, ymin), (xmax, ymin), (xmax, ymax),
                         (xmin, ymax)], np.float64)]
    circ = []
    if scene.obstacle_center is not None and scene.obstacle_radius:
        circ.append((*scene.obstacle_center, scene.obstacle_radius))
    if getattr(scene, "obstacles", None):
        # multi-obstacle scenes (karman2cyl/karman3cyl): one clockwise
        # loop per circle — the Nystrom system is loop-agnostic
        circ.extend(scene.obstacles)
    for cx, cy, r in circ:
        # circle obstacle, clockwise (fluid outside). A dense polygon
        # stands in for the smooth circle (geometry error ~ r theta^2/2).
        t = -2.0 * np.pi * (np.arange(2048) + 0.5) / 2048
        loops.append(np.stack([cx + r * np.cos(t),
                               cy + r * np.sin(t)], axis=1))
    return loops


def equispaced_boundary(loops, n_total):
    """Midpoint-rule cache: n_total samples equispaced by arclength across
    the loops (allocated proportionally). Returns (pts (B,2),
    outward normals (B,2), weights (B,) = local arclength per sample).

    Deterministic equispaced sampling replaces zombie's uniform-random
    boundary sampler (boundary_sampler.h): on closed smooth loops the
    midpoint rule converges geometrically where MC gives 1/sqrt(B)."""
    lens = []
    segs = []
    for loop in loops:
        v = np.asarray(loop, np.float64)
        a = v
        b = np.roll(v, -1, axis=0)
        ln = np.linalg.norm(b - a, axis=1)
        segs.append((a, b, ln))
        lens.append(ln.sum())
    total = float(np.sum(lens))
    pts, nrms, ws = [], [], []
    for (a, b, ln), L in zip(segs, lens):
        n = max(8, int(round(n_total * L / total)))
        s = (np.arange(n) + 0.5) * (L / n)
        cum = np.concatenate([[0.0], np.cumsum(ln)])
        idx = np.clip(np.searchsorted(cum, s, side="right") - 1,
                      0, len(ln) - 1)
        t = (s - cum[idx]) / np.maximum(ln[idx], 1e-300)
        p = a[idx] + t[:, None] * (b[idx] - a[idx])
        d = b[idx] - a[idx]
        nrm = np.stack([d[:, 1], -d[:, 0]], axis=1)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                          1e-300)
        pts.append(p)
        nrms.append(nrm)
        ws.append(np.full(n, L / n))
    return (np.concatenate(pts), np.concatenate(nrms),
            np.concatenate(ws))


# ------------------------------------------------------- kernel grid (FFT)

def _next_fast(n):
    try:
        from scipy.fft import next_fast_len
        return next_fast_len(int(n))
    except Exception:
        m = 1
        while m < n:
            m *= 2
        return m


def _kernel_ffts(res, spacing, sigma, r_max):
    """Spectral free-space kernel for the vertex-output convolution
    V[v] = int G_sigma(x_v - y) f~(y) dy with f~ the bilinear-hat
    reconstruction of the cell-centered samples f[c].

    The kernel is defined directly in Fourier space — symbol
    Ghat(xi) = 1 / (|xi|^2 + sigma) times the hat mollifier
    sinc^2(xi h / 2) per axis, with a half-cell phase shift moving the
    output lattice onto the vertices. Defining the symbol (instead of
    point-sampling the spatial kernel) avoids aliasing Ghat's slow
    xi^-2 tails, which costs a resolution-independent relative bias of
    ~sigma h^2 scale otherwise (measured 1.3e-3 at R=256); the hat
    keeps the implied reconstruction local, so the abrupt zero pad at
    the box edge stays Gibbs-free. Padding makes the nearest periodic
    image >= r_max away (e^{-sqrt(sigma) r_max} negligible).

    Returns complex128 rfft2 arrays (KG, KX, KY) and the pad shape."""
    (Rx, Ry), (hx, hy) = res, spacing
    Nx = _next_fast(Rx + int(np.ceil(r_max / hx)) + 1)
    Ny = _next_fast(Ry + int(np.ceil(r_max / hy)) + 1)
    xi = 2.0 * np.pi * np.fft.fftfreq(Nx, d=hx)[:, None]
    eta = 2.0 * np.pi * np.fft.rfftfreq(Ny, d=hy)[None, :]
    Ghat = 1.0 / (xi ** 2 + eta ** 2 + sigma)
    hat = (np.sinc(xi * hx / (2.0 * np.pi)) ** 2
           * np.sinc(eta * hy / (2.0 * np.pi)) ** 2)
    phase = np.exp(-0.5j * (xi * hx + eta * hy))
    KG = Ghat * hat * phase
    KX = 1j * xi * KG
    KY = 1j * eta * KG
    return KG, KX, KY, (Nx, Ny)


def _vertex_bilerp(grid, scene_size, y):
    """Bilinear gather into an (Rx+1, Ry+1) vertex grid (node i at
    lo + i*h); in-box queries never extrapolate."""
    res = grid.shape
    i0s, ws = [], []
    for i in range(2):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * (res[i] - 1)
        i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, res[i] - 2)
        i0s.append(i0)
        ws.append(jnp.clip(u - i0.astype(u.dtype), 0.0, 1.0))
    flat_grid = grid.reshape(-1)
    out = jnp.zeros(y.shape[:-1], grid.dtype)
    for corner in range(4):
        flat = jnp.zeros(y.shape[:-1], jnp.int32)
        w = jnp.ones(y.shape[:-1], grid.dtype)
        for i in range(2):
            hi_bit = (corner >> i) & 1
            flat = flat * res[i] + i0s[i] + hi_bit
            w = w * (ws[i] if hi_bit else 1.0 - ws[i])
        out = out + w * jnp.take(flat_grid, flat)
    return out


# --------------------------------------------------------------- projector

class BemProjector:
    """Precomputed deterministic projector for one (scene, resolution).

    Hashes by identity (stable jit key). All host precomputation happens
    in float64; the A inverse is disk-cached under .bem_cache/ because
    the B^3 factorization is the one expensive one-time step."""

    def __init__(self, scene, div_resolution, n_boundary=None,
                 eval_chunk=8192, r_max=None, cache_dir=None,
                 nystrom=True):
        if scene.dim != 2:
            raise ValueError("--projection bem is 2D-only (3D scenes are "
                             "box-exact under --projection spectral)")
        if scene.absorption <= 0.0:
            raise ValueError("bem projection needs absorption > 0 "
                             "(truncated Yukawa kernels)")
        from . import sampling
        self.scene = scene
        self.sigma = float(scene.absorption)
        ss = scene.scene_size
        self.res = sampling.grid_resolutions(ss, div_resolution)
        Rx, Ry = self.res
        hx = (ss[1] - ss[0]) / Rx
        hy = (ss[3] - ss[2]) / Ry
        self.spacing = (hx, hy)
        self.eval_chunk = eval_chunk
        # kernel truncation: e^{-sqrt(sigma) r_max} ~ 4e-8 at 17/sqrt(sigma)
        r_max = r_max or min(17.0 / math.sqrt(self.sigma),
                             math.hypot(ss[1] - ss[0], ss[3] - ss[2]))
        KGf, KXf, KYf, (Nx, Ny) = _kernel_ffts(
            self.res, self.spacing, self.sigma, r_max)
        self.fft_shape = (Nx, Ny)
        # domain indicator at cell centers (masks the divergence source to
        # the fluid domain; cf. fluid_points rejection)
        centers = np.stack(np.meshgrid(
            ss[0] + (np.arange(Rx) + 0.5) * hx,
            ss[2] + (np.arange(Ry) + 0.5) * hy, indexing="ij"), axis=-1)
        chi = np.asarray(scene.fluid_mask(
            jnp.asarray(centers.reshape(-1, 2), jnp.float32))
        ).reshape(Rx, Ry).astype(np.float64)
        # boundary cache: default sample spacing ~ one grid cell (the
        # splat's accurate-from distance tracks the cache spacing, so it
        # should shrink with the grid it complements); the B^3 host
        # factorization below caps it
        loops = closed_loops(scene)
        if n_boundary is None:
            perim = sum(
                np.linalg.norm(np.roll(v, -1, 0) - np.asarray(v), axis=1)
                .sum() for v in loops)
            n_boundary = int(min(8192, max(
                256, 2 ** math.ceil(math.log2(perim / min(hx, hy))))))
        pts, nrm, w = equispaced_boundary(loops, n_boundary)
        self.n_boundary = B = len(pts)
        # keep the (eval_chunk, B, 2) pairwise intermediates bounded
        # (~0.5 GB at the 8192x8192 extreme): cap the C*B product so the
        # chunk tensor stays <= ~64 MB regardless of boundary density
        self.eval_chunk = max(256, min(self.eval_chunk,
                                       (1 << 23) // max(B, 1)))
        # host convolutions (float64) of the constant problem f == sigma:
        # V_sigma and grad V_sigma feed the row-sum diagonal and the
        # constant-shift splat correction
        def host_conv(Kf, f):
            return np.fft.irfft2(np.fft.rfft2(f, s=(Nx, Ny)) * Kf,
                                 s=(Nx, Ny))[:Rx + 1, :Ry + 1]

        fc = self.sigma * chi
        Vc = host_conv(KGf, fc)
        gVcx = host_conv(KXf, fc)
        gVcy = host_conv(KYf, fc)

        def host_bilerp(grid, y):
            ux = np.clip((y[:, 0] - ss[0]) / (ss[1] - ss[0]) * Rx, 0, Rx)
            uy = np.clip((y[:, 1] - ss[2]) / (ss[3] - ss[2]) * Ry, 0, Ry)
            i0 = np.clip(np.floor(ux).astype(int), 0, Rx - 1)
            j0 = np.clip(np.floor(uy).astype(int), 0, Ry - 1)
            tx, ty = ux - i0, uy - j0
            return ((1 - tx) * (1 - ty) * grid[i0, j0]
                    + tx * (1 - ty) * grid[i0 + 1, j0]
                    + (1 - tx) * ty * grid[i0, j0 + 1]
                    + tx * ty * grid[i0 + 1, j0 + 1])

        Vc_cache = host_bilerp(Vc, pts)
        # the BVC subclass estimates the cache values by Monte Carlo and
        # never needs the (B, B) Nystrom inverse
        A_inv = self._load_or_build_A(scene, pts, nrm, w, Vc_cache,
                                      div_resolution, cache_dir) \
            if nystrom else None
        # device-side constants, downcast from float64 on the host
        self.KGf = jnp.asarray(KGf.astype(np.complex64))
        self.KXf = jnp.asarray(KXf.astype(np.complex64))
        self.KYf = jnp.asarray(KYf.astype(np.complex64))
        self.chi = jnp.asarray(chi.astype(np.float32))
        self.Vc = jnp.asarray(Vc.astype(np.float32))
        self.gVc = jnp.asarray(
            np.stack([gVcx, gVcy], axis=-1).astype(np.float32))
        self.cache_pts = jnp.asarray(pts.astype(np.float32))
        self.cache_n = jnp.asarray(nrm.astype(np.float32))
        self.cache_w = jnp.asarray(w.astype(np.float32))
        self.A_inv = (jnp.asarray(np.asarray(A_inv, np.float32))
                      if A_inv is not None else None)

    def _load_or_build_A(self, scene, pts, nrm, w, Vc_cache,
                         div_resolution, cache_dir):
        cache_dir = cache_dir or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".bem_cache")
        tag = (f"{scene.name}_r{div_resolution}_b{len(pts)}"
               f"_s{self.sigma:g}_v{_CACHE_VERSION}")
        path = os.path.join(cache_dir, tag + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                if (np.allclose(z["pts"], pts)
                        and np.allclose(z["Vc"], Vc_cache)):
                    return z["A_inv"]
        # Nystrom matrix: u_i + sum_j w_j P_ij u_j = V_f(x_i), with the
        # effective diagonal set by the row-sum rule (exactness for
        # u == 1 <-> f == sigma):  sum_j w_j P_ij == V_sigma(x_i) - 1.
        B = len(pts)
        Pij = _np_P(self.sigma, pts, pts, nrm) * w[None, :]
        np.fill_diagonal(Pij, 0.0)
        diag = (Vc_cache - 1.0) - Pij.sum(axis=1)
        A = np.eye(B) + Pij
        A[np.arange(B), np.arange(B)] += diag
        A_inv = np.linalg.inv(A)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, A_inv=A_inv.astype(np.float32),
                            pts=pts, Vc=Vc_cache)
        return A_inv

    # ------------------------------------------------------------- solve

    def solve(self, div_grid, pts):
        """p, grad_p at pts (E, 2) for the masked divergence source."""
        return _bem_solve(self, div_grid, pts)


@partial(jax.jit, static_argnums=(0,))
def _volume_potentials(bp: BemProjector, div_grid):
    """FFT volume potential V_f and its gradient on the vertex lattice."""
    Rx, Ry = bp.res
    Nx, Ny = bp.fft_shape
    f = (div_grid * bp.chi).astype(jnp.float32)
    F = jnp.fft.rfft2(f, s=(Nx, Ny))
    V = jnp.fft.irfft2(F * bp.KGf, s=(Nx, Ny))[:Rx + 1, :Ry + 1]
    Gx = jnp.fft.irfft2(F * bp.KXf, s=(Nx, Ny))[:Rx + 1, :Ry + 1]
    Gy = jnp.fft.irfft2(F * bp.KYf, s=(Nx, Ny))[:Rx + 1, :Ry + 1]
    return V, Gx, Gy


@partial(jax.jit, static_argnums=(0,))
def _bem_solve(bp: BemProjector, div_grid, pts):
    ss = bp.scene.scene_size
    V, Gx, Gy = _volume_potentials(bp, div_grid)
    rhs = _vertex_bilerp(V, ss, bp.cache_pts)
    u_gamma = jnp.dot(bp.A_inv, rhs,
                      precision=jax.lax.Precision.HIGHEST)    # (B,)
    return _splat(bp, u_gamma, V, Gx, Gy, pts)


@partial(jax.jit, static_argnums=(0,))
def _splat(bp: BemProjector, u_gamma, V, Gx, Gy, pts):
    """Evaluate u = V_f + P-kernel splat of the cache boundary values
    (with the constant-shift near-boundary correction) at pts."""
    ss = bp.scene.scene_size
    E = pts.shape[0]
    C = min(bp.eval_chunk, E)
    n_chunk = -(-E // C)
    pad = n_chunk * C - E
    pts_p = jnp.concatenate([pts, pts[:1].repeat(pad, 0)]) if pad else pts
    sigma = bp.sigma

    def chunk(xc):
        d = xc[:, None, :] - bp.cache_pts[None]               # (C, B, 2)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        rs = jnp.maximum(r, 1e-9)
        dgdr = _free_dGdr(2, sigma, rs)
        P = -dgdr * jnp.sum(d * bp.cache_n[None], axis=-1) / rs
        dP = _free_dP(2, sigma, d, rs, bp.cache_n[None])      # (C, B, 2)
        # nearest cache value as the constant shift (min + one-hot masked
        # reduce instead of a random-index gather)
        rmin = jnp.min(r, axis=1, keepdims=True)
        sel = (r <= rmin).astype(jnp.float32)
        c = jnp.sum(sel * u_gamma[None], axis=1) \
            / jnp.maximum(jnp.sum(sel, axis=1), 1.0)          # (C,)
        v = (u_gamma[None] - c[:, None]) * bp.cache_w[None]
        u_b = -jnp.sum(P * v, axis=1)
        g_b = -jnp.sum(dP * v[..., None], axis=1)
        u = _vertex_bilerp(V, ss, xc) + u_b \
            + c * (1.0 - _vertex_bilerp(bp.Vc, ss, xc))
        gx = _vertex_bilerp(Gx, ss, xc)
        gy = _vertex_bilerp(Gy, ss, xc)
        gc = jnp.stack([_vertex_bilerp(bp.gVc[..., 0], ss, xc),
                        _vertex_bilerp(bp.gVc[..., 1], ss, xc)], axis=-1)
        g = jnp.stack([gx, gy], axis=-1) + g_b - c[:, None] * gc
        return u, g

    u, g = jax.lax.map(chunk, pts_p.reshape(n_chunk, C, 2))
    return u.reshape(-1)[:E], g.reshape(-1, 2)[:E]


# ---------------------------------------------------------- MC-cached (BVC)

class BvcProjector(BemProjector):
    """Monte Carlo boundary value caching as a production projection mode.

    This is zombie's N11 estimator run the way it was designed to be used
    (boundary_sampler.h + splatter.h, exposed as `bvc` in demo.cpp:265-363
    but never wired into the reference's fluid loop): WoSt-estimate the
    solution once at a small boundary cache, then evaluate the whole
    pressure cloud by splatting the cache through the free-space kernels.
    The du/dn cache term is identically zero for the fluid's pure-Neumann
    projection (boundary_sampler.h:190-196), so only the solution cache is
    walked.

    Differences from the reference's bvc, both shared with BemProjector:
    the volume term is the exact FFT free-space potential of the
    divergence grid instead of a Monte Carlo domain-sample splat
    (deterministic, alias-free), and the cache is equispaced-by-arclength
    quadrature instead of uniform-random samples. The splat itself (P
    kernels + constant-shift near-boundary correction) is byte-identical
    to the BEM path (`_splat`).

    Cost: one pool-executor walk batch at B cache points (B ~ 4-8k vs the
    wost mode's 262k pressure points — a ~32x smaller walk) + the FFTs +
    one (E, B) kernel contraction. Variance: the P kernel decays like
    e^{-sqrt(sigma) r}, so MC noise is confined to a ~1/sqrt(sigma) skin
    at the boundary; in the bulk the estimate equals the deterministic
    volume potential.

    The cache solution is estimated at points offset 2 epsilon inward
    (the lockstep analog of the reference's boundary-limit alpha = 2
    convention, wost/bvc.py build_cache); the O(offset) bias term is
    proportional to du/dn = 0, leaving O(offset^2)."""

    def __init__(self, scene, div_resolution, wost_scene, walk_settings,
                 n_walks=None, n_boundary=None, offset=None, **kw):
        super().__init__(scene, div_resolution, n_boundary=n_boundary,
                         nystrom=False, **kw)
        self.wost_scene = wost_scene
        self.walk_settings = walk_settings
        self.n_walks = n_walks
        off = offset if offset is not None \
            else 2.0 * walk_settings.epsilon_shell
        self.inner_pts = self.cache_pts - off * self.cache_n

    def solve(self, div_grid, pts, key):
        """p, grad_p at pts (E, 2). NOT jittable as a whole: the walk
        estimator host-loops over launches (wost/solver.py)."""
        from ..wost.solver import estimate_solution_and_gradient
        V, Gx, Gy = _volume_potentials(self, div_grid)
        u_gamma, _, _ = estimate_solution_and_gradient(
            self.wost_scene, self.walk_settings, self.inner_pts, key,
            n_walks=self.n_walks, source_args=(div_grid,))
        return _splat(self, u_gamma, V, Gx, Gy, pts)
