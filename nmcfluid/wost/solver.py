"""Batched walk-on-stars estimator for screened Poisson problems.

Rebuild of zombie's WalkOnStars<float, DIM>
(reference: bindings/zombie/include/zombie/point_estimation/walk_on_stars.h).
Where the reference runs one recursive walk per CPU thread over a BVH, this
solver advances *all* walkers of a point batch in lockstep as SoA arrays
inside a single `lax.while_loop`, with brute-force vectorized geometry
queries (see nmcfluid.geometry) and scaled-Bessel Green's functions (see
nmcfluid.ops.greens2d/3d). Randomness is counter-based (threefry fold-ins),
so runs are reproducible — unlike the reference's wall-clock-seeded pcg32
(walk_on_stars.h:638-641).

The estimator set matches the reference math one-for-one:
  * star radii from silhouette queries, shrunk 1% (walk_on_stars.h:162-178,
    RADIUS_SHRINK_PERCENTAGE);
  * uniform directions with hemisphere flip on Neumann (:185-191);
  * ray clipping against the Neumann boundary, arc step otherwise (:196-210);
  * single-sample Neumann boundary term via |G|-weighted boundary sampling
    (:212-260), skipped automatically when the boundary value is None <=> 0
    (every shipped fluid config: demo/scene.h:176-181);
  * in-ball Green's-function source sampling along the walk direction,
    accepted when it lands inside the star region (:262-276);
  * Yukawa screening from step `steps_before_tikhonov` (:319-321) — the
    fluid uses sigma=350 from step 0;
  * Russian roulette on the direction-sampled Poisson kernel throughput
    (:297-306);
  * antithetic pairs + solution/source control variates + stratified first
    directions for the gradient estimator (:466-617);
  * walks that escape the domain or exceed the cap are dropped from the
    statistics, matching which completion codes update estimates (:447-459).
"""
import dataclasses
import math
from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geometry import queries2d, queries3d
from ..geometry.soup2d import Seg2D
from ..ops import fastrand, greens2d, greens3d
from ..ops.sampling import unit_sphere_from_u, pdf_unit_sphere

RADIUS_SHRINK = 0.99  # walk_on_stars.h:9

# walk completion codes
ACTIVE, DONE_RR, DONE_DIRICHLET, DROP_ESCAPED, DROP_MAXLEN = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class WalkSettings:
    """Mirror of zombie::WalkSettings (walk_on_stars.h:679-742) plus the
    lockstep-loop cap. `walk_step_cap` bounds the while_loop; with the
    shipped Russian-roulette threshold (0.99) and sigma=350 the surviving
    fraction at 64 steps is ~0 (tested), so the cap introduces no
    measurable bias while keeping the loop compilable."""
    epsilon_shell: float = 1e-3
    min_star_radius: float = 1e-3
    silhouette_precision: float = 1e-3
    russian_roulette_threshold: float = 0.99
    max_walk_length: int = 10_000
    steps_before_tikhonov: int = 0
    steps_before_maximal_spheres: int = 10_000
    n_walks: int = 500
    walk_step_cap: int = 64
    rejection_rounds: int = 16
    ignore_dirichlet: bool = True
    ignore_neumann: bool = False
    ignore_source: bool = False
    # double-sided boundary conditions (walk_on_stars.h:734 solveDoubleSided,
    # pde.h:20-24 dirichletDoubleSided/neumannDoubleSided): the PDE is
    # solved on BOTH sides of the boundary. Walk mechanics: a walker that
    # reached the Neumann boundary through its front face has its stored
    # normal flipped to keep hemisphere sampling + ray offsets on the
    # side it arrived from (walk_on_stars.h:152-159); silhouette
    # candidates are never statically dropped (scene.h:84-90 returns
    # false — pass double_sided=True to build_segments); boundary values
    # become side-dependent: dirichlet_ds_fn(x, front) selects by the
    # sign of the signed distance at termination (:336-341), and
    # neumann_ds_fn(x, aligned) gets zombie's estimateBoundaryNormalAligned
    # flag (:221-253).
    solve_double_sided: bool = False
    use_gradient_control_variates: bool = True
    use_gradient_antithetic_variates: bool = True
    # antithetic pairs advanced together as extra walker lanes per
    # while_loop iteration. Lockstep batches multiply wasted work on
    # already-terminated lanes, so the default stays sequential; the knob
    # remains for small point counts.
    pair_batch: int = 1
    # pairs per device launch: the gradient estimator host-loops over
    # launches of this many pairs, carrying the running sums. The value
    # is a guard against very long single programs, sized on another
    # accelerator; untuned on the GPU.
    pairs_per_launch: int = 50
    # counter-based PCG hash for the per-step walk draws (ops.fastrand):
    # ~10 ALU ops per uniform instead of threefry's ~100+, the dominant
    # per-step cost of the lockstep loop. Statistically validated
    # (tests/test_fastrand, analytic estimator tests run both ways).
    fast_rng: bool = True
    # ---- executor for the gradient estimator. "gen" (default, round
    # 5): point-aligned generations with one-shot survivor compaction
    # (wost/gen.py) — zero gathers/scatters in the steady path, identical
    # estimates to the pool. "pool": compacted walker queue (wost/pool.py) — cost tracks the
    # SUM of walk lengths, the reference's per-point independent cost
    # (walk_on_stars.h:91-104) with static shapes; the round-2..4
    # parity executor. "lockstep" keeps the round-1 pair-launch loop.
    algo: str = "gen"
    pool_slots: int = 0            # 0 -> auto: min(8 * n_points, 2**20)
    # walk steps between scatter/refill. The refill is an S-wide
    # _start_states + scatter, comparable in cost to an advance step;
    # K>1 amortizes that overhead for at most K-1 idle steps per
    # finished walk. K=3 was tuned on another accelerator; untuned on
    # the GPU.
    pool_refill_every: int = 3
    # per-walk step cap in pool mode. Walks that exceed it are DROPPED
    # from the statistics (DROP_MAXLEN, matching which completion codes
    # update estimates, walk_on_stars.h:447-459) — at 1024 the surviving
    # fraction is ~0 even next to the karman obstacle, where the
    # lockstep default (64) dropped a measurable share of walkers.
    pool_step_cap: int = 1024
    pool_trips_per_launch: int = 2048  # long-program guard, GPU-untuned
    # pairs estimated with zero control variates before the CVs are
    # frozen for the remaining pairs (the reference warms its running
    # mean from zero the same way, walk_on_stars.h:501-506)
    cv_warmup_pairs: int = 16
    # ---- adaptive walk allocation (pool mode only; round 4). The
    # reference spends a fixed nWalks on every point
    # (walk_on_stars.h:354-461). With kappa = adaptive_walks > 0 the
    # pool runs geometric rounds of pairs and, between rounds, stops
    # points that have reached the OPTIMAL-ALLOCATION budget
    # n_i* = kappa * n_pairs * sigma_i * mean(sigma)/mean(sigma^2)
    # (n_i ~ sigma_i is the minimal total-walk allocation matching the
    # fixed scheme's RMS standard error; solution AND gradient sigmas
    # both guarded). Stopped points' remaining queue lanes are never
    # issued (active-index remap, statically gated — zero recompiles,
    # zero overhead when off). 0.0 = off (the reference's allocation).
    # NOTE: measured NEGATIVE on the shipped karman config — see
    # PARITY.md "Adaptive walk allocation" — kept for PDE workloads
    # with variance-heterogeneous, cheap-to-walk clouds.
    adaptive_walks: float = 0.0
    adaptive_rounds: int = 4
    # ---- generation executor (wost/gen.py; algo="gen", round 5).
    # Point-aligned lockstep generations of gen_group_pairs pairs: the
    # lane->point map is a reshape (zero gathers/scatters). Lanes
    # still active at gen_step_cap are DROPPED from the statistics
    # (reference maxWalkLength semantics); at sigma=350 the surviving
    # fraction at 64 steps is ~0. Generations chain in-graph,
    # gen_groups_per_launch per device program (a per-launch-overhead
    # guard sized on another accelerator; untuned on the GPU).
    gen_group_pairs: int = 4
    gen_step_cap: int = 1024     # == pool_step_cap drop semantics
    gen_groups_per_launch: int = 16
    # survivor compaction inside a generation: once <= S/gen_tail_div
    # lanes are ACTIVE (after step 1: ~2% at sigma=350), steps run on a
    # compacted static buffer — the full-width advance is dominated by
    # the source eval over dead lanes. Streams are per-lane, so the
    # compacted execution is bit-identical to full width.
    gen_tail_div: int = 32


@dataclasses.dataclass(frozen=True, eq=False)  # id-hash: stable jit cache key
class WostScene:
    """Static PDE + geometry description (zombie::PDE, core/pde.h:14-27).

    `source_fn(x, *source_args)` is the volumetric source; the optional
    `source_args` pytree is threaded through the estimate functions as a
    *dynamic* argument, so a per-timestep source field (the fluid's
    divergence grid) does not bake into the trace as a constant — one
    compile serves every projection. `neumann_fn`/`dirichlet_fn`
    of None mean identically-zero boundary data and let the solver skip
    those terms entirely (the fluid projection always has h == g == 0,
    demo/scene.h:168-200)."""
    dim: int
    neumann: object                 # Seg2D | Tri3D
    source_fn: Callable
    absorption: float = 0.0
    dirichlet: Optional[object] = None
    neumann_fn: Optional[Callable] = None
    dirichlet_fn: Optional[Callable] = None
    # double-sided variants (pde.h:20-24), used when
    # settings.solve_double_sided: fn(x, side) with `side` a bool array —
    # dirichlet_ds_fn: sign of the signed distance to the Dirichlet
    # boundary at termination; neumann_ds_fn: zombie's
    # estimateBoundaryNormalAligned flag for the sampled boundary point
    dirichlet_ds_fn: Optional[Callable] = None
    neumann_ds_fn: Optional[Callable] = None

    def qmod(self):
        return queries2d if self.dim == 2 else queries3d

    def greens(self):
        return _get_greens(self.dim, float(self.absorption))


@lru_cache(maxsize=None)
def _get_greens(dim: int, absorption: float):
    """Cached Green's-function namespace per (dim, sigma): radius tables
    are built once on the host, not per trace."""
    if absorption > 0.0:
        return (greens2d.Yukawa2D(absorption) if dim == 2
                else greens3d.Yukawa3D(absorption))
    return greens2d.Harmonic2D if dim == 2 else greens3d.Harmonic3D


class WalkState(NamedTuple):
    x: jax.Array            # (..., D) current position
    n: jax.Array            # (..., D) current normal (stale unless on bdry)
    on_neumann: jax.Array   # (...,) bool
    thr: jax.Array          # (...,) throughput
    acc: jax.Array          # (...,) accumulated source+neumann contribution
    steps: jax.Array        # (...,) int32
    status: jax.Array       # (...,) int32 completion code
    first_radius: jax.Array  # (...,) >0 -> use as first star radius
    # double-sided only: stored normal opposes the geometric one (the
    # walker reached the boundary through its front face and the normal
    # was flipped to its side, walk_on_stars.h:152-159). Constant False
    # in single-sided walks.
    flipped: jax.Array = None  # (...,) bool


def _fresh_state(x, **over):
    """WalkState at interior positions x with all-default per-lane fields."""
    lanes = x.shape[:-1]
    base = dict(
        x=x, n=jnp.zeros_like(x),
        on_neumann=jnp.zeros(lanes, bool),
        thr=jnp.ones(lanes, jnp.float32),
        acc=jnp.zeros(lanes, jnp.float32),
        steps=jnp.zeros(lanes, jnp.int32),
        status=jnp.full(lanes, ACTIVE, jnp.int32),
        first_radius=jnp.zeros(lanes, jnp.float32),
        flipped=jnp.zeros(lanes, bool))
    base.update(over)
    return WalkState(**base)


def _dirichlet_dist(scene, x):
    q = scene.qmod()
    if scene.dirichlet is None:
        return q.dist_to_far_bbox_corner(scene.neumann, x)
    return q.distance(scene.dirichlet, x)


def _categorical_u(w, u):
    """Inverse-CDF categorical pick over the last axis of nonnegative
    weights `w` from ONE uniform per lane — the counter-based-RNG
    replacement for jax.random.categorical, usable by both executors
    (the pool has no per-step threefry key; its draws come from
    (lane, step)-keyed PCG streams, see wost/pool.py)."""
    cdf = jnp.cumsum(w, axis=-1)
    tot = cdf[..., -1:]
    idx = jnp.sum((cdf < u[..., None] * tot).astype(jnp.int32), axis=-1)
    return jnp.clip(idx, 0, w.shape[-1] - 1)


def _sample_neumann_boundary(scene, x, u_sel, u_pt):
    """Single-sample Neumann boundary pick, |G|-length-weighted.

    Brute-force equivalent of FCPW's stochastic BVH traversal
    (fcpw_scene_loader.h:599-620) with the traversal weight of
    demo/scene.h:157-160: per-segment weight = |G3D(max(d, 1e-2))| * length,
    pdf reported w.r.t. the boundary measure. `u_sel` (lanes,) picks the
    element, `u_pt` (lanes, 2) places the point on it (first column only
    in 2D) — plain uniforms, so the per-step `draw` streams of either
    executor feed it."""
    soup: Seg2D = scene.neumann
    if scene.dim == 2:
        a, b = soup.a, soup.b
        seg = b - a
        ln = jnp.linalg.norm(seg, axis=-1)
        ab = seg / jnp.maximum(ln, 1e-20)[..., None]
        xa = x[..., None, :] - a
        t = jnp.clip(jnp.sum(xa * ab, -1), 0.0, ln)
        p = a + t[..., None] * ab
        d = jnp.linalg.norm(x[..., None, :] - p, axis=-1)
        w = ln / (4.0 * jnp.pi * jnp.maximum(d, 1e-2))
        w = jnp.where(ln > 1e-12, w, 0.0)
        tot = jnp.sum(w, -1)
        idx = _categorical_u(w, u_sel)
        u = u_pt[..., 0]
        pa, pb = soup.a[idx], soup.b[idx]
        pt = pa + u[..., None] * (pb - pa)
        li = ln[idx]
        pdf = jnp.take_along_axis(w, idx[..., None], -1)[..., 0]
        pdf = pdf / jnp.maximum(tot, 1e-30) / jnp.maximum(li, 1e-20)
        return pt, soup.n[idx], pdf
    # ---- 3D: per-triangle weight = area * |G3D(max(d, 1e-2))| (the same
    # harmonic traversal weight the reference registers for both
    # dimensions, demo/scene.h:157-160 / fcpw_scene_loader.h:599-620);
    # pdf reported w.r.t. the boundary AREA measure. Padded slots are
    # degenerate (area 0) and drop out of the categorical.
    from ..geometry.queries3d import _closest_on_tri
    tri = scene.neumann
    area = 0.5 * jnp.linalg.norm(
        jnp.cross(tri.vb - tri.va, tri.vc - tri.va), axis=-1)    # (P,)
    cp = _closest_on_tri(x[..., None, :], tri.va, tri.vb, tri.vc)
    d = jnp.linalg.norm(x[..., None, :] - cp, axis=-1)           # (..., P)
    w = area / (4.0 * jnp.pi * jnp.maximum(d, 1e-2))
    tot = jnp.sum(w, -1)
    idx = _categorical_u(w, u_sel)
    uv = u_pt
    # uniform point in the triangle: sqrt-mapping barycentrics
    su = jnp.sqrt(uv[..., 0:1])
    b0 = 1.0 - su
    b1 = su * (1.0 - uv[..., 1:2])
    b2 = su * uv[..., 1:2]
    pt = b0 * tri.va[idx] + b1 * tri.vb[idx] + b2 * tri.vc[idx]
    ai = area[idx]
    pdf = jnp.take_along_axis(w, idx[..., None], -1)[..., 0]
    pdf = pdf / jnp.maximum(tot, 1e-30) / jnp.maximum(ai, 1e-20)
    return pt, tri.n[idx], pdf


def _advance(scene, greens, settings: WalkSettings, st: WalkState, draw,
             source_args=(), step_cap=None):
    """One walk step for every ACTIVE lane — the loop body of walk()
    (walk_on_stars.h:135-329). Shared by the lockstep while_loop (_walk)
    and the compacted pool executor (wost/pool.py).

    `draw(salt, shape)` supplies the step's uniforms; the caller keys it
    (lockstep: loop counter + lane iota; pool: per-lane step counter +
    pair-lane id, so antithetic halves share streams regardless of when
    each half is scheduled). `step_cap` overrides max_walk_length as the
    DROP_MAXLEN threshold (the pool's per-walk cap)."""
    q = scene.qmod()
    D = scene.dim
    rr = settings.russian_roulette_threshold
    soup = scene.neumann
    use_yukawa = scene.absorption > 0.0
    # mid-walk Tikhonov (walk_on_stars.h:319-321): harmonic Green's fn for
    # the first K steps, Yukawa afterwards — per lane, selected by step
    # count. K = 0 (every shipped config) keeps the single-greens path.
    K_tik = settings.steps_before_tikhonov
    mixed = use_yukawa and K_tik > 0
    g_harm = greens2d.Harmonic2D if D == 2 else greens3d.Harmonic3D
    M_max = settings.steps_before_maximal_spheres
    cap = settings.max_walk_length if step_cap is None else step_cap

    active = st.status == ACTIVE

    dd = _dirichlet_dist(scene, st.x)
    star = q.star_radius(soup, st.x, settings.min_star_radius, dd)
    star = jnp.where(settings.min_star_radius <= dd,
                     jnp.maximum(RADIUS_SHRINK * star,
                                 settings.min_star_radius), star)
    if M_max < settings.max_walk_length:
        # maximal-sphere mode after M steps (walk_on_stars.h:162-164):
        # radius = dist to Dirichlet, no silhouette constraint/shrink
        star = jnp.where(st.steps >= M_max, dd, star)
    R = jnp.where(st.first_radius > 0.0, st.first_radius, star)
    ball = greens.make_ball(R)
    if mixed:
        ball_h = g_harm.make_ball(R)
        on_yukawa = st.steps >= K_tik

    u_dir = jnp.stack([draw(s_, R.shape) for s_ in range(D - 1)], axis=-1)
    d = unit_sphere_from_u(u_dir, D)
    d = jnp.broadcast_to(d, st.x.shape)
    flip = st.on_neumann & (jnp.sum(st.n * d, -1) > 0.0)
    d = jnp.where(flip[..., None], -d, d)

    off = q.OFFSET_EPS * jnp.maximum(
        1.0, jnp.linalg.norm(st.x, axis=-1))[..., None]
    o_eff = jnp.where(st.on_neumann[..., None], st.x - st.n * off, st.x)
    hit, t_hit, hit_pt, hit_n = q.ray_intersect(soup, o_eff, d, R)
    arc_pt = o_eff + R[..., None] * d
    new_pt = jnp.where(hit[..., None], hit_pt, arc_pt)
    new_flipped = st.flipped
    if settings.solve_double_sided:
        # double-sided: a walker hitting the FRONT face keeps the walk on
        # the side it arrived from by flipping the stored normal
        # (walk_on_stars.h:152-159, applied at the hit instead of at the
        # next step's start — nothing reads the normal in between)
        front = jnp.sum(d * hit_n, axis=-1) < 0.0
        hit_n = jnp.where((hit & front)[..., None], -hit_n, hit_n)
        # per-step reset (walk_on_stars.h:152-159 reinitialises
        # flipNormalOrientation to false at every step top): the flag is
        # True only when THIS step hit the boundary through its front
        # face — an arc step clears it. Keeping the stale value (pre-r5
        # bug, ADVICE r4) fed a wrong aligned=True to neumann_ds_fn on
        # interior steps after a front-face hit.
        new_flipped = hit & front
    new_n = jnp.where(hit[..., None], hit_n, st.n)

    acc = st.acc
    # ---- Neumann boundary term (zero boundary data short-circuits)
    use_ds_neumann = (settings.solve_double_sided
                      and scene.neumann_ds_fn is not None)
    if (scene.neumann_fn is not None or use_ds_neumann) \
            and not settings.ignore_neumann:
        u_sel = draw(6, R.shape)
        u_pt = jnp.stack([draw(7, R.shape), draw(8, R.shape)], axis=-1)
        bpt, bn, bpdf = _sample_neumann_boundary(scene, st.x, u_sel, u_pt)
        bdist = jnp.linalg.norm(bpt - st.x, axis=-1)
        alpha = jnp.where(st.on_neumann, 2.0, 1.0)
        vis = q.has_line_of_sight(soup, o_eff, bpt)
        ok = (bpdf > 0.0) & (bdist < R) & vis
        G = greens.eval(ball, jnp.maximum(bdist, greens2d.R_CLAMP))
        if mixed:
            G = jnp.where(on_yukawa, G, g_harm.eval(
                ball_h, jnp.maximum(bdist, greens2d.R_CLAMP)))
        if use_ds_neumann:
            # estimateBoundaryNormalAligned (walk_on_stars.h:221-253):
            # aligned when the walker's own normal was flipped this step,
            # or the sample's normal faces away from the sample direction
            # (with the concave-hemisphere caveat when on the boundary)
            prec = settings.silhouette_precision
            dirn = (bpt - st.x) / jnp.maximum(bdist, 1e-20)[..., None]
            faces_away = jnp.sum(dirn * bn, axis=-1) < -prec
            concave_ok = jnp.where(st.on_neumann,
                                   jnp.sum(dirn * st.n, axis=-1) < -prec,
                                   True)
            aligned = st.flipped | (faces_away & concave_ok)
            h = scene.neumann_ds_fn(bpt, aligned)
        else:
            h = scene.neumann_fn(bpt)
        acc = acc + jnp.where(active & ok,
                              st.thr * alpha * G * h / bpdf, 0.0)

    # ---- source term: radius along the walk direction, star-clipped
    if not settings.ignore_source:
        u2 = jnp.stack([draw(4, ball.R.shape),
                        draw(5, ball.R.shape)], axis=-1)
        r_src, _ = greens.sample_radius_u(ball, u2)
        g_norm = greens.norm(ball)
        if mixed:
            r_h, _ = g_harm.sample_radius_u(ball_h, u2)
            r_src = jnp.where(on_yukawa, r_src, r_h)
            g_norm = jnp.where(on_yukawa, g_norm, g_harm.norm(ball_h))
        y = st.x + r_src[..., None] * d
        take = r_src <= t_hit
        contrib = g_norm * scene.source_fn(y, *source_args)
        acc = acc + jnp.where(active & take, st.thr * contrib, 0.0)

    escaped = (~hit) & q.outside_bbox(soup, new_pt)

    r_new = jnp.linalg.norm(new_pt - st.x, axis=-1)
    dspk = greens.dspk(ball, r_new)
    if mixed:
        dspk = jnp.where(on_yukawa, dspk, g_harm.dspk(ball_h, r_new))
    thr = st.thr * dspk
    u_rr = draw(3, thr.shape)
    below = thr < rr
    die = below & (thr / rr < u_rr)
    thr = jnp.where(below & ~die, rr, thr)
    steps = st.steps + 1

    status = st.status
    status = jnp.where(active & escaped, DROP_ESCAPED, status)
    status = jnp.where(active & ~escaped & die, DONE_RR, status)
    status = jnp.where(
        active & ~escaped & ~die & (steps > cap),
        DROP_MAXLEN, status)
    if scene.dirichlet is not None:
        dd_new = _dirichlet_dist(scene, new_pt)
        status = jnp.where((status == ACTIVE)
                           & (dd_new <= settings.epsilon_shell),
                           DONE_DIRICHLET, status)

    return WalkState(
        x=jnp.where(active[..., None], new_pt, st.x),
        n=jnp.where(active[..., None], new_n, st.n),
        on_neumann=jnp.where(active, hit, st.on_neumann),
        thr=jnp.where(active, jnp.where(die, 0.0, thr), st.thr),
        acc=acc,
        steps=jnp.where(active, steps, st.steps),
        status=status,
        first_radius=jnp.zeros_like(st.first_radius),
        flipped=jnp.where(active, new_flipped, st.flipped),
    )


def _walk(scene, greens, settings: WalkSettings, state: WalkState,
          key, rand_shape, source_args=()):
    """Advance all lanes until every walk has terminated or the cap hits.

    Lanes with leading dims broadcasting from `rand_shape` share random
    draws (used for antithetic continuation pairs, mirroring the shared
    re-seed at walk_on_stars.h:579)."""
    if settings.fast_rng:
        seed = fastrand.seed_from_key(key)
        lanes = fastrand.lane_iota(rand_shape)

    def cond(carry):
        it, st = carry
        return (it < settings.walk_step_cap) & jnp.any(st.status == ACTIVE)

    def body(carry):
        it, st = carry

        if settings.fast_rng:
            def draw(salt, shape):
                return jnp.broadcast_to(
                    fastrand.uniform(seed, it, salt, lanes), shape)
        else:
            kstep = jax.random.fold_in(key, it)

            def draw(salt, shape):
                return jnp.broadcast_to(
                    jax.random.uniform(jax.random.fold_in(kstep, salt + 16),
                                       rand_shape), shape)

        st2 = _advance(scene, greens, settings, st, draw, source_args)
        return it + 1, st2

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    # lanes still active at the cap are treated as over-length (dropped)
    status = jnp.where(final.status == ACTIVE, DROP_MAXLEN, final.status)
    final = final._replace(status=status)

    terminal = jnp.zeros_like(final.acc)
    if (settings.solve_double_sided and scene.dirichlet_ds_fn is not None
            and not settings.ignore_dirichlet):
        # dirichletDoubleSided(x, side): side = sign of the signed
        # distance at termination (walk_on_stars.h:332-341)
        sd = scene.qmod().signed_distance(scene.dirichlet, final.x)
        terminal = jnp.where(final.status == DONE_DIRICHLET,
                             scene.dirichlet_ds_fn(final.x, sd > 0.0), 0.0)
    elif scene.dirichlet_fn is not None and not settings.ignore_dirichlet:
        terminal = jnp.where(final.status == DONE_DIRICHLET,
                             scene.dirichlet_fn(final.x), 0.0)
    total = final.acc + final.thr * terminal
    valid = (final.status == DONE_RR) | (final.status == DONE_DIRICHLET)
    return total, valid, final.steps


def _first_sphere_radius_solution(scene, settings, pts):
    """First star radius for solution-only estimation
    (walk_on_stars.h:403-424)."""
    q = scene.qmod()
    dd = _dirichlet_dist(scene, pts)
    star = q.star_radius(scene.neumann, pts, settings.min_star_radius, dd)
    star = jnp.where(settings.min_star_radius <= dd,
                     jnp.maximum(RADIUS_SHRINK * star,
                                 settings.min_star_radius), star)
    return star


@partial(jax.jit, static_argnums=(0, 1, 4))
def estimate_solution(scene: WostScene, settings: WalkSettings, pts, key,
                      n_walks: Optional[int] = None, source_args=()):
    """Estimate the PDE solution at pts (N, D) with n_walks walks each.

    Returns (p, n_valid, mean_steps). Walks of one point use independent
    randoms; all (point, walk) lanes advance together."""
    greens = scene.greens()
    n_walks = n_walks or settings.n_walks
    N = pts.shape[0]
    first_r = _first_sphere_radius_solution(scene, settings, pts)

    lanes = (n_walks, N)
    st = _fresh_state(jnp.broadcast_to(pts, lanes + (scene.dim,)),
                      first_radius=jnp.broadcast_to(first_r, lanes))
    total, valid, steps = _walk(scene, greens, settings, st, key, lanes,
                                source_args)
    n_valid = jnp.sum(valid, axis=0)
    p = jnp.sum(jnp.where(valid, total, 0.0), axis=0) / jnp.maximum(n_valid, 1)
    mean_steps = jnp.sum(jnp.where(valid, steps, 0), axis=0) \
        / jnp.maximum(n_valid, 1)
    return p, n_valid, mean_steps


def _stratified_pair_u(key, w, n_pairs, rot, dim):
    """Per-pair stratified uniforms in [0,1)^{dim-1} with per-point
    Cranley-Patterson rotation `rot` ((N, dim-1)), standing in for the
    per-point stratified sequences of walk_on_stars.h:489-491."""
    if dim == 2:
        jit = jax.random.uniform(key, rot.shape[:-1])
        u = jnp.mod((w + jit) / n_pairs + rot[..., 0], 1.0)
        return u[..., None]
    # 3D: decompose the pair index onto a near-square grid for 2D strata
    a = int(math.ceil(math.sqrt(n_pairs)))
    wi, wj = w % a, w // a
    jit = jax.random.uniform(key, rot.shape[:-1] + (2,))
    u0 = jnp.mod((wi + jit[..., 0]) / a + rot[..., 0], 1.0)
    u1 = jnp.mod((wj + jit[..., 1]) / ((n_pairs + a - 1) // a) + rot[..., 1],
                 1.0)
    return jnp.stack([u0, u1], axis=-1)


def estimate_solution_and_gradient(scene: WostScene, settings: WalkSettings,
                                   pts, key, n_walks: Optional[int] = None,
                                   mask_invalid: bool = True,
                                   source_args=()):
    """Estimate solution and spatial gradient at interior pts (N, D).

    Rebuild of estimateSolutionAndGradient (walk_on_stars.h:466-617):
    antithetic source/boundary pairs, running-mean control variates,
    stratified first directions, first sphere = 0.99*dist-to-boundary.
    Returns (p, grad (N, D), n_valid).

    The pair loop is split across device launches of
    `settings.pairs_per_launch` pairs with the running sums carried
    between launches (see the pairs_per_launch doc for why); each launch
    is one jitted program, so this function must be called OUTSIDE jit.

    With settings.algo == "pool" (the default) the walks are instead
    executed by the compacted walker pool (wost/pool.py) — same
    estimator math, wall-clock proportional to total walk length rather
    than pairs x max length. Falls back to lockstep ONLY for the
    threefry RNG (fast_rng=False): the pool's draws are counter-based
    by construction. Nonzero Neumann data runs in the pool since the
    boundary pick consumes plain per-step uniforms (round 5).
    """
    # adaptive walk allocation is a pool-scheduler feature: route there
    # (the generation executor issues fixed pair counts by construction)
    if (settings.algo in ("pool", "gen") and settings.fast_rng
            and settings.adaptive_walks > 0.0):
        from . import pool
        return pool.estimate_solution_and_gradient_pool(
            scene, settings, pts, key, n_walks=n_walks,
            mask_invalid=mask_invalid, source_args=source_args)
    if settings.algo == "pool" and settings.fast_rng:
        from . import pool
        return pool.estimate_solution_and_gradient_pool(
            scene, settings, pts, key, n_walks=n_walks,
            mask_invalid=mask_invalid, source_args=source_args)
    if settings.algo == "gen" and settings.fast_rng:
        from . import gen
        return gen.estimate_solution_and_gradient_gen(
            scene, settings, pts, key, n_walks=n_walks,
            mask_invalid=mask_invalid, source_args=source_args)
    n_walks_total = n_walks or settings.n_walks
    n_pairs = max(1, n_walks_total // 2) \
        if settings.use_gradient_antithetic_variates else n_walks_total
    N = pts.shape[0]
    D = scene.dim
    L = max(1, settings.pairs_per_launch)
    carry = (jnp.zeros((N,), jnp.float32), jnp.zeros((N,), jnp.int32),
             jnp.zeros((N,), jnp.float32), jnp.zeros((N, D), jnp.float32),
             jnp.zeros((N,), jnp.int32))
    for lo in range(0, n_pairs, L):
        carry = _grad_launch(scene, settings, pts, key, n_walks_total,
                             min(L, n_pairs - lo), jnp.int32(lo), carry,
                             source_args)
    sum_sol, n_sol, _, sum_grad, n_grad = carry
    p = sum_sol / jnp.maximum(n_sol, 1)
    grad = sum_grad / jnp.maximum(n_grad, 1)[..., None]
    if mask_invalid:
        q = scene.qmod()
        nd = q.distance(scene.neumann, pts)
        dd = _dirichlet_dist(scene, pts)
        degenerate = RADIUS_SHRINK * jnp.minimum(nd, dd) <= 1e-6
        p = jnp.where(degenerate, 0.0, p)
        grad = jnp.where(degenerate[..., None], 0.0, grad)
    return p, grad, n_sol


@partial(jax.jit, static_argnums=(0, 1, 4, 5))
def _grad_launch(scene: WostScene, settings: WalkSettings, pts, key,
                 n_walks: int, launch_pairs: int, pair_lo, carry,
                 source_args=()):
    """One launch of `launch_pairs` antithetic pairs starting at absolute
    pair index `pair_lo` (dynamic, so every launch shares one compile),
    folding contributions into the carried running sums."""
    greens = scene.greens()
    q = scene.qmod()
    D = scene.dim
    # Tikhonov starting only after K steps means the FIRST ball (sampled
    # here, before any step) uses the harmonic Green's function
    g1 = greens
    if scene.absorption > 0.0 and settings.steps_before_tikhonov > 0:
        g1 = greens2d.Harmonic2D if D == 2 else greens3d.Harmonic3D
    n_walks = n_walks or settings.n_walks
    n_pairs = max(1, n_walks // 2) \
        if settings.use_gradient_antithetic_variates else n_walks
    n_anti = 2 if settings.use_gradient_antithetic_variates else 1
    N = pts.shape[0]

    nd = q.distance(scene.neumann, pts)
    dd = _dirichlet_dist(scene, pts)
    R1 = RADIUS_SHRINK * jnp.minimum(nd, dd)            # walk_on_stars.h:486
    degenerate = R1 <= 1e-6                              # on/next to boundary
    R1 = jnp.maximum(R1, 1e-6)
    ball1 = g1.make_ball(R1)
    norm1 = g1.norm(ball1)
    thr1 = g1.pk_over_uniform(ball1)
    # e^{-Z}-free ratio: pk_grad_coeff/thr1 computed jointly — the naive
    # quotient explodes when both factors underflow f32 at large Z (this
    # produced 1e19 pressure gradients and blew up the projection fit)
    pk_ratio = g1.pk_grad_over_thr(ball1)
    b_pdf = pdf_unit_sphere(D)

    rot = jax.random.uniform(jax.random.fold_in(key, 0xC0FFEE), (N, D - 1))
    signs = jnp.asarray([1.0, -1.0], jnp.float32)[:n_anti, None, None]

    def one_pair(w, cv_b, cv_s):
        """One antithetic pair's contributions at every point: returns
        (total (A,N), first_src (A,N), grad (A,N,D), valid (A,N)).
        vmapped over a batch of pair indices so G pairs advance as extra
        walker lanes of one while_loop instead of G sequential loops —
        the solve is bound by sequential step-iteration overhead, not
        per-lane math."""
        kw = jax.random.fold_in(key, w)
        # first source sample in the first ball, antithetic through center
        u_s = _stratified_pair_u(jax.random.fold_in(kw, 0), w, n_pairs,
                                 rot, D)
        dir_s = unit_sphere_from_u(u_s, D)               # (N, D)
        r_s, eval_s = g1.sample_radius(ball1, jax.random.fold_in(kw, 1))
        y_vol = pts[None] + signs * (r_s[:, None] * dir_s)[None]   # (A,N,D)
        if settings.ignore_source:
            first_src = jnp.zeros((n_anti, N), jnp.float32)
            sgd = jnp.zeros((n_anti, N, D), jnp.float32)
        else:
            first_src = norm1[None] * scene.source_fn(y_vol, *source_args)
            # sourceGradientDirection = grad/(pdf*norm) = d * grad_norm/eval
            # — as an e^{-z}-free joint ratio (same underflow rationale)
            sgd = (signs * dir_s[None]) * (
                r_s * g1.grad_norm_over_eval(ball1, r_s))[None, :, None]

        # first boundary step to the ball surface, antithetic mirrored
        u_b = _stratified_pair_u(jax.random.fold_in(kw, 2), w, n_pairs,
                                 jnp.mod(rot + 0.5, 1.0), D)
        dir_b = unit_sphere_from_u(u_b, D)
        y_surf = pts[None] + signs * (R1[:, None] * dir_b)[None]   # (A,N,D)
        # boundaryGradientDirection = pkGradient/(b_pdf * throughput)
        bgd = (signs * dir_b[None]) * (pk_ratio * R1 / b_pdf)[None, :, None]

        st = _fresh_state(y_surf, thr=jnp.broadcast_to(thr1, (n_anti, N)),
                          acc=first_src)
        total, valid, _ = _walk(scene, greens, settings, st,
                                jax.random.fold_in(kw, 3), (N,), source_args)
        valid = valid & ~degenerate[None]
        boundary_contrib = total - first_src
        grad = ((boundary_contrib - cv_b[None])[..., None] * bgd
                + (first_src - cv_s[None])[..., None] * sgd)   # (A,N,D)
        return total, first_src, grad, valid

    G = max(1, min(settings.pair_batch, launch_pairs))
    n_outer = -(-launch_pairs // G)

    def outer_body(o, carry):
        (sum_sol, n_sol, sum_first, sum_grad, n_grad) = carry
        # control variates from running statistics (walk_on_stars.h:501-506;
        # here refreshed once per G-pair batch instead of per pair — the
        # estimator stays unbiased, E[direction] = 0)
        if settings.use_gradient_control_variates:
            cv_b = sum_sol / jnp.maximum(n_sol, 1)
            cv_s = sum_first / jnp.maximum(n_sol, 1)
        else:
            cv_b = jnp.zeros_like(sum_sol)
            cv_s = jnp.zeros_like(sum_first)
        w = pair_lo + o * G + jnp.arange(G)
        total, first_src, grad, valid = jax.vmap(
            one_pair, in_axes=(0, None, None))(w, cv_b, cv_s)   # (G,A,N,..)
        # padded pairs (pair_batch remainder) dropped
        valid = valid & (w < pair_lo + launch_pairs)[:, None, None]
        vf = valid.astype(jnp.float32)
        sum_sol = sum_sol + jnp.sum(vf * total, axis=(0, 1))
        sum_first = sum_first + jnp.sum(vf * first_src, axis=(0, 1))
        n_sol = n_sol + jnp.sum(valid, axis=(0, 1))
        sum_grad = sum_grad + jnp.sum(vf[..., None] * grad, axis=(0, 1))
        n_grad = n_grad + jnp.sum(valid, axis=(0, 1))
        return (sum_sol, n_sol, sum_first, sum_grad, n_grad)

    return jax.lax.fori_loop(0, n_outer, outer_body, carry)
