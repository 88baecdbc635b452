"""Compacted walker-pool execution of the WoSt gradient estimator.

The lockstep estimator (solver._grad_launch) advances every (pair, point)
lane until the LAST lane of a launch terminates. Box scenes exit in a few
steps, but on obstacle scenes a minority of near-silhouette walkers run
10-100x longer (tiny star radii keep the Yukawa throughput decay — and so
Russian roulette — from firing), and the lockstep loop pays that max
length across all ~131k lanes of all 250 pair launches.

Here walks are instead drawn from a global work queue into a fixed pool
of S slots. Every `pool_refill_every` steps, terminated lanes scatter
their contribution into per-point running sums and their slots are
refilled from the queue (prefix-sum slot assignment), so wall-clock
tracks the SUM of walk lengths — the per-point independent cost of the
reference's TBB fan-out (walk_on_stars.h:91-104) — while every array
keeps a static shape and the whole schedule runs in-graph with zero host
round-trips inside a launch. A host loop chains fixed-trip launches
(`pool_trips_per_launch`, a long-program guard sized on another
accelerator).

Estimator math is identical to the lockstep path (the per-step body is
solver._advance, shared): antithetic first samples mirrored through the
point, stratified first directions with per-point Cranley-Patterson
rotations, control variates (two-stage here: `cv_warmup_pairs` pairs run
with zero CV, then the CVs freeze — the frozen CV is independent of the
remaining pairs, so the estimator stays unbiased, matching the
reference's running mean warmed from zero, walk_on_stars.h:501-506), and
the e^{-Z}-cancelled gradient ratios. Start states are regenerated from
counter-based streams keyed on (pair, point), and continuation draws are
keyed on (pair-lane, per-lane step), so antithetic halves share streams
regardless of when the pool schedules each half (the shared re-seed of
walk_on_stars.h:579).
"""
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import fastrand, greens2d, greens3d
from ..ops.sampling import pdf_unit_sphere, unit_sphere_from_u
from .solver import (ACTIVE, DONE_DIRICHLET, DONE_RR, RADIUS_SHRINK,
                     WalkSettings, WalkState, WostScene, _advance,
                     _dirichlet_dist, _fresh_state)

EMPTY = -1  # slot status: no walk assigned (distinct from ACTIVE/terminal)

# fastrand salts for the first-sample streams (the walk steps use salts
# 0-5 on their own seed; these run on an independent seed)
_SALT_JIT_S = 8    # source-direction stratum jitter (+1 = 2nd axis in 3D)
_SALT_U2A, _SALT_U2B = 10, 11   # in-ball radius uniforms
_SALT_JIT_B = 12   # boundary-direction stratum jitter (+1 in 3D)


class PointData(NamedTuple):
    """Per-evaluation-point precomputes (the _grad_launch preamble).

    `packed` concatenates every per-point field the refill stage needs
    into one (N, K) row matrix so issuing a walk costs ONE gather.
    Column layout:
    [pts (D) | rot (D-1) | R1 | norm1 | thr1 | bgd_coeff | degenerate |
     ball leaves (len(ball1))]."""
    pts: jax.Array         # (N, D)
    R1: jax.Array          # (N,) first ball radius (walk_on_stars.h:486)
    ball1: object          # Ball pytree of (N,) fields
    degenerate: jax.Array  # (N,) bool: on/next to the boundary
    packed: jax.Array      # (N, K)


class PoolCarry(NamedTuple):
    next_lane: jax.Array   # i32 scalar: next queue index not yet issued
    st: WalkState          # (S,) walker lanes
    g: jax.Array           # (S,) i32 lane id (stale when EMPTY)
    ok: jax.Array          # (S,) 1.0 unless the lane's point is degenerate
    first_src: jax.Array   # (S,) first ball source sample
    bgd_vec: jax.Array     # (S, D) signed boundaryGradientDirection
    sgd_vec: jax.Array     # (S, D) signed sourceGradientDirection
    acc: jax.Array         # (N, 3 + D) packed running sums:
    # [sum_sol | sum_first | n_valid | sum_grad (D)] — one scatter-add
    # per refill instead of four


def _first_greens(scene, settings):
    """Green's fn of the FIRST ball: harmonic while Tikhonov is delayed."""
    if scene.absorption > 0.0 and settings.steps_before_tikhonov > 0:
        return greens2d.Harmonic2D if scene.dim == 2 else greens3d.Harmonic3D
    return scene.greens()


@partial(jax.jit, static_argnums=(0, 1))
def _precompute(scene: WostScene, settings: WalkSettings, pts, key):
    q = scene.qmod()
    D = scene.dim
    g1 = _first_greens(scene, settings)
    nd = q.distance(scene.neumann, pts)
    dd = _dirichlet_dist(scene, pts)
    R1 = RADIUS_SHRINK * jnp.minimum(nd, dd)
    degenerate = R1 <= 1e-6
    R1 = jnp.maximum(R1, 1e-6)
    ball1 = g1.make_ball(R1)
    rot = jax.random.uniform(jax.random.fold_in(key, 0xC0FFEE),
                             (pts.shape[0], D - 1))
    cols = [pts, rot, R1[:, None], g1.norm(ball1)[:, None],
            g1.pk_over_uniform(ball1)[:, None],
            (g1.pk_grad_over_thr(ball1) * R1 / pdf_unit_sphere(D))[:, None],
            degenerate.astype(jnp.float32)[:, None]]
    cols += [leaf[:, None] for leaf in jax.tree.leaves(ball1)]
    return PointData(pts=pts, R1=R1, ball1=ball1, degenerate=degenerate,
                     packed=jnp.concatenate(cols, axis=1))


def _unpack_row(row, D, ball_struct):
    """Split a packed (S, K) gather back into the per-lane fields."""
    pts = row[:, 0:D]
    rot = row[:, D:2 * D - 1]
    R1, norm1, thr1, bgd_coeff, degen = (row[:, 2 * D - 1 + j]
                                         for j in range(5))
    ball = jax.tree.unflatten(
        ball_struct, [row[:, 2 * D + 4 + j]
                      for j in range(ball_struct.num_leaves)])
    return pts, rot, R1, norm1, thr1, bgd_coeff, degen, ball


def _strat_dir(seed2, w, i, salt, rot_i, shift, n_pairs, D):
    """First-step direction for pair w at point i: stratified over the
    pair index with counter-based jitter + per-point rotation (the role
    of walk_on_stars.h:489-491; see solver._stratified_pair_u)."""
    wu = w.astype(jnp.uint32)
    iu = i.astype(jnp.uint32)
    if D == 2:
        jit = fastrand.uniform(seed2, wu, salt, iu)
        u = jnp.mod((w.astype(jnp.float32) + jit) / n_pairs
                    + rot_i[..., 0] + shift, 1.0)
        return unit_sphere_from_u(u[..., None], 2)
    a = int(math.ceil(math.sqrt(n_pairs)))
    b = (n_pairs + a - 1) // a
    j0 = fastrand.uniform(seed2, wu, salt, iu)
    j1 = fastrand.uniform(seed2, wu, salt + 1, iu)
    u0 = jnp.mod(((w % a).astype(jnp.float32) + j0) / a
                 + rot_i[..., 0] + shift, 1.0)
    u1 = jnp.mod(((w // a).astype(jnp.float32) + j1) / b
                 + rot_i[..., 1] + shift, 1.0)
    return unit_sphere_from_u(jnp.stack([u0, u1], axis=-1), 3)


def _decode(g, n_anti, n_active, active_idx):
    """virtual lane id -> (pair w, antithetic half a, point i, sign).

    The queue enumerates (pair, half, active-slot); active_idx maps slot
    j -> real point id i, or None for the identity (non-adaptive runs:
    keeps the decode pure integer arithmetic — an unconditional adaptive
    gather measurably slowed the fixed path). With the identity map
    the RNG stream ids derived from (w, i) are unchanged, so adaptive
    runs draw the SAME walks for the pairs they do issue."""
    j = g % n_active
    wa = g // n_active
    a = wa % n_anti
    w = wa // n_anti
    i = j if active_idx is None else active_idx[j]
    sign = 1.0 - 2.0 * a.astype(jnp.float32)
    return w, a, i, sign


def _start_states(scene, settings, pd: PointData, seed2, g, source_args,
                  n_pairs, n_anti, n_active, active_idx):
    """Start state for lane ids g (S,): the first-ball antithetic source
    sample + first surface step of _grad_launch.one_pair, regenerated
    on demand from counter streams keyed on (pair, point). All per-point
    data arrives through ONE packed gather (pd.packed[i])."""
    D = scene.dim
    g1 = _first_greens(scene, settings)
    w, a, i, sign = _decode(g, n_anti, n_active, active_idx)
    wu = w.astype(jnp.uint32)
    iu = i.astype(jnp.uint32)
    row = pd.packed[i]                                 # (S, K), one gather
    pts_i, rot_i, R1_i, norm1_i, thr1_i, bgd_i, degen_i, ball_i = \
        _unpack_row(row, D, jax.tree.structure(pd.ball1))

    if settings.ignore_source:
        first_src = jnp.zeros(g.shape, jnp.float32)
        sgd_vec = jnp.zeros(g.shape + (D,), jnp.float32)
    else:
        dir_s = _strat_dir(seed2, w, i, _SALT_JIT_S, rot_i, 0.0, n_pairs, D)
        u2 = jnp.stack([fastrand.uniform(seed2, wu, _SALT_U2A, iu),
                        fastrand.uniform(seed2, wu, _SALT_U2B, iu)], axis=-1)
        r_s, _ = g1.sample_radius_u(ball_i, u2)
        y_vol = pts_i + (sign * r_s)[..., None] * dir_s
        first_src = norm1_i * scene.source_fn(y_vol, *source_args)
        # sourceGradientDirection, e^{-z}-free joint ratio
        sgd_vec = (sign * r_s * g1.grad_norm_over_eval(ball_i, r_s)
                   )[..., None] * dir_s

    dir_b = _strat_dir(seed2, w, i, _SALT_JIT_B, rot_i, 0.5, n_pairs, D)
    bgd_vec = (sign * bgd_i)[..., None] * dir_b
    x0 = pts_i + (sign * R1_i)[..., None] * dir_b
    st = _fresh_state(x0, thr=thr1_i, acc=first_src)
    return st, 1.0 - degen_i, first_src, bgd_vec, sgd_vec


def _scatter_refill(scene, settings, pd: PointData, seed2, g_hi, cv,
                    carry: PoolCarry, source_args, n_pairs, n_anti,
                    n_active, active_idx):
    """Terminated lanes: fold contributions into the packed per-point
    accumulator (ONE scatter-add); then assign freed slots the next
    queued lane ids (prefix-sum ranks). `cv` is (N, 2): [cv_b | cv_s],
    gathered as one row."""
    st = carry.st
    term = (st.status != ACTIVE) & (st.status != EMPTY)
    _, _, i, _ = _decode(carry.g, n_anti, n_active, active_idx)

    total = st.acc
    if (settings.solve_double_sided and scene.dirichlet_ds_fn is not None
            and not settings.ignore_dirichlet):
        sd = scene.qmod().signed_distance(scene.dirichlet, st.x)
        total = total + jnp.where(
            st.status == DONE_DIRICHLET,
            st.thr * scene.dirichlet_ds_fn(st.x, sd > 0.0), 0.0)
    elif scene.dirichlet_fn is not None and not settings.ignore_dirichlet:
        total = total + jnp.where(st.status == DONE_DIRICHLET,
                                  st.thr * scene.dirichlet_fn(st.x), 0.0)
    valid = (term & ((st.status == DONE_RR) | (st.status == DONE_DIRICHLET))
             & (carry.ok > 0.5))

    cv_i = cv[i]                                       # (S, 2), one gather
    bc = total - carry.first_src       # boundary (continuation) part
    gvec = ((bc - cv_i[:, 0])[..., None] * carry.bgd_vec
            + (carry.first_src - cv_i[:, 1])[..., None] * carry.sgd_vec)

    vf = valid.astype(jnp.float32)
    contrib = jnp.concatenate(
        [(vf * total)[:, None], (vf * carry.first_src)[:, None],
         vf[:, None], vf[:, None] * gvec,
         vf[:, None] * gvec * gvec,
         (vf * total * total)[:, None]], axis=1)       # (S, 4 + 2D)
    acc = carry.acc.at[i].add(contrib)                 # one scatter-add

    # ---- refill freed slots from the queue
    free = term | (st.status == EMPTY)
    rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    new_g = carry.next_lane + rank
    take = free & (new_g < g_hi)
    st_new, ok_new, fs_new, bv_new, sv_new = _start_states(
        scene, settings, pd, seed2, jnp.where(take, new_g, 0), source_args,
        n_pairs, n_anti, n_active, active_idx)

    keep_status = jnp.where(term, EMPTY, st.status)
    sel = lambda n, o: jnp.where(take, n, o)
    sel_v = lambda n, o: jnp.where(take[..., None], n, o)
    st2 = WalkState(
        x=sel_v(st_new.x, st.x), n=sel_v(st_new.n, st.n),
        on_neumann=sel(st_new.on_neumann, st.on_neumann),
        thr=sel(st_new.thr, st.thr), acc=sel(st_new.acc, st.acc),
        steps=sel(st_new.steps, st.steps),
        status=jnp.where(take, ACTIVE, keep_status),
        first_radius=sel(st_new.first_radius, st.first_radius),
        flipped=sel(st_new.flipped, st.flipped))
    n_issued = jnp.minimum(jnp.sum(free.astype(jnp.int32)),
                           g_hi - carry.next_lane)
    return PoolCarry(
        next_lane=carry.next_lane + jnp.maximum(n_issued, 0),
        st=st2, g=sel(new_g, carry.g), ok=sel(ok_new, carry.ok),
        first_src=sel(fs_new, carry.first_src),
        bgd_vec=sel_v(bv_new, carry.bgd_vec),
        sgd_vec=sel_v(sv_new, carry.sgd_vec),
        acc=acc)


def _make_draw(seed_w, st, pl):
    """Continuation draws keyed on (per-lane step count, pair-lane id):
    identical streams for both antithetic halves (solver._walk shares
    them by broadcasting; the pool by construction)."""
    steps = st.steps.astype(jnp.uint32)

    def draw(salt, shape):
        return jnp.broadcast_to(fastrand.uniform(seed_w, steps, salt, pl),
                                shape)
    return draw


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _pool_launch(scene: WostScene, settings: WalkSettings, n_pairs: int,
                 n_anti: int, N: int, adaptive: bool, pd, key, g_hi, cv,
                 carry: PoolCarry, n_active, active_idx, source_args=()):
    """Up to ~pool_trips_per_launch sequential steps of the pool schedule:
    while work remains, [scatter + refill] then `pool_refill_every`
    unrolled walk steps. Returns (carry, done)."""
    greens = scene.greens()
    if not adaptive:        # identity map, static modulus (see _decode)
        n_active, active_idx = N, None
    seed_w = fastrand.seed_from_key(jax.random.fold_in(key, 1))
    seed2 = fastrand.seed_from_key(jax.random.fold_in(key, 2))
    K = max(1, settings.pool_refill_every)
    T_outer = max(1, settings.pool_trips_per_launch // K)

    def done(c):
        return (c.next_lane >= g_hi) & jnp.all(c.st.status == EMPTY)

    def cond(oc):
        o, c = oc
        return (o < T_outer) & ~done(c)

    def body(oc):
        o, c = oc
        c = _scatter_refill(scene, settings, pd, seed2, g_hi, cv,
                            c, source_args, n_pairs, n_anti,
                            n_active, active_idx)
        # RNG stream id from the REAL (pair, point) — identical streams
        # whether or not the point set is adaptively compacted
        w_, _, i_, _ = _decode(c.g, n_anti, n_active, active_idx)
        pl = (w_ * N + i_).astype(jnp.uint32)
        st = c.st
        for _ in range(K):  # unrolled: trip count = outer trips only
            st = _advance(scene, greens, settings, st,
                          _make_draw(seed_w, st, pl), source_args,
                          step_cap=settings.pool_step_cap)
        return o + 1, c._replace(st=st)

    _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
    return carry, done(carry)


def estimate_solution_and_gradient_pool(scene: WostScene,
                                        settings: WalkSettings, pts, key,
                                        n_walks=None, mask_invalid=True,
                                        source_args=()):
    """Pool-mode drop-in for solver.estimate_solution_and_gradient.

    Must be called outside jit (hosts the launch loop). Returns
    (p, grad (N, D), n_valid)."""
    if not settings.fast_rng:
        raise ValueError("pool mode needs the counter-based fast RNG")
    n_walks_total = n_walks or settings.n_walks
    n_anti = 2 if settings.use_gradient_antithetic_variates else 1
    n_pairs = (max(1, n_walks_total // 2) if n_anti == 2
               else n_walks_total)
    N, D = pts.shape
    W = n_pairs * n_anti * N
    S = settings.pool_slots or min(8 * N, 1 << 20)
    S = max(n_anti, min(S, W))

    pd = _precompute(scene, settings, pts, key)
    carry = PoolCarry(
        next_lane=jnp.int32(0),
        st=_fresh_state(jnp.zeros((S, D), jnp.float32),
                        thr=jnp.zeros((S,), jnp.float32),
                        status=jnp.full((S,), EMPTY, jnp.int32)),
        g=jnp.zeros((S,), jnp.int32),
        ok=jnp.zeros((S,), jnp.float32),
        first_src=jnp.zeros((S,), jnp.float32),
        bgd_vec=jnp.zeros((S, D), jnp.float32),
        sgd_vec=jnp.zeros((S, D), jnp.float32),
        acc=jnp.zeros((N, 4 + 2 * D), jnp.float32))
    act_full = jnp.arange(N, dtype=jnp.int32)

    def run(lo_pair, hi_pair, cv, carry, active_idx, n_active):
        carry = carry._replace(
            next_lane=jnp.int32(lo_pair * n_anti * n_active))
        g_hi = jnp.int32(hi_pair * n_anti * n_active)
        # generous guard: every queued step plus slack, at least a few
        w_round = (hi_pair - lo_pair) * n_anti * n_active
        max_launches = 8 + (w_round * settings.pool_step_cap) \
            // (S * max(1, settings.pool_trips_per_launch))
        for _ in range(max_launches):
            carry, dn = _pool_launch(scene, settings, n_pairs, n_anti, N,
                                     kappa > 0.0, pd, key, g_hi, cv,
                                     carry, jnp.int32(n_active),
                                     active_idx, source_args)
            if bool(dn):
                return carry
        raise RuntimeError("walker pool failed to drain (scheduler bug?)")

    def point_sems(acc_np):
        """Per-point standard error of the gradient magnitude AND the
        solution estimate (both must converge before a point stops —
        early-stopped points would otherwise keep warmup-level solution
        noise)."""
        import numpy as np
        n = np.maximum(np.asarray(acc_np[:, 2]), 2.0)
        mean_g = acc_np[:, 3:3 + D] / n[:, None]
        var_g = np.maximum(
            acc_np[:, 3 + D:3 + 2 * D] / n[:, None] - mean_g ** 2, 0.0)
        mean_s = acc_np[:, 0] / n
        var_s = np.maximum(acc_np[:, 3 + 2 * D] / n - mean_s ** 2, 0.0)
        return np.sqrt(var_s / n), np.sqrt(var_g.sum(1) / n)

    zcv = jnp.zeros((N, 2), jnp.float32)
    C = min(n_pairs, max(1, settings.cv_warmup_pairs))
    kappa = settings.adaptive_walks
    if n_pairs > C and (settings.use_gradient_control_variates
                        or kappa > 0.0):
        carry = run(0, C, zcv, carry, act_full, N)
        if settings.use_gradient_control_variates:
            nv = jnp.maximum(carry.acc[:, 2], 1.0)
            cv = carry.acc[:, 0:2] / nv[:, None]   # [cv_b | cv_s]
        else:
            cv = zcv
        if kappa > 0.0:
            # geometric pair-count rounds C -> n_pairs; between rounds,
            # stop points whose gradient SEM is already <= kappa x the
            # median point's PROJECTED final SEM at the full budget
            # (SEM-equalizing allocation; see WalkSettings.adaptive_walks)
            import numpy as np
            R = max(2, settings.adaptive_rounds)
            ratio = (n_pairs / C) ** (1.0 / (R - 1))
            bounds = sorted({min(n_pairs, int(round(C * ratio ** k)))
                             for k in range(1, R)} | {n_pairs})
            import os as _os
            import time as _time
            dbg = _os.environ.get("NMCFLUID_ADAPTIVE_DEBUG") == "1"
            lo = C
            first = True
            for hi in bounds:
                if hi <= lo:
                    continue
                t_round = _time.time()
                if first:
                    # every point takes the first post-warmup round: the
                    # warmup pairs carry zero control variates, so stop
                    # decisions (and final estimates) must include CV'd
                    # walks before any point is frozen
                    alive = np.arange(N)
                    first = False
                else:
                    # optimal-allocation rule: for a total-walk budget,
                    # sum_i sigma_i^2/n_i is minimized by n_i ~ sigma_i
                    # (Cauchy-Schwarz); the allocation that EQUALS the
                    # fixed scheme's RMS standard error with minimal
                    # walks is n_i* = n_pairs * sigma_i * mean(sigma) /
                    # mean(sigma^2) = n_pairs/(1+cv^2) total. kappa
                    # scales the budget (1.0 = fixed-scheme RMS error);
                    # on a variance-homogeneous scene n_i* ~ n_pairs and
                    # nothing stops early — the savings come exactly
                    # from variance heterogeneity (karman: the gradient
                    # variance concentrates at the obstacle).
                    acc_np = np.asarray(carry.acc)
                    nw = np.maximum(acc_np[:, 2], 2.0)
                    sem_s, sem_g = point_sems(acc_np)

                    def target(sigma):
                        s2 = np.mean(sigma ** 2)
                        if s2 <= 0.0:
                            return np.full(N, n_pairs)
                        return n_pairs * sigma * np.mean(sigma) / s2

                    tgt = kappa * np.maximum(
                        target(sem_s * np.sqrt(nw)),
                        target(sem_g * np.sqrt(nw)))
                    alive = np.nonzero(lo < tgt)[0]
                if len(alive) == 0:
                    break
                idx = np.zeros(N, np.int32)
                idx[:len(alive)] = alive
                carry = run(lo, hi, cv, carry, jnp.asarray(idx),
                            int(len(alive)))
                if dbg:
                    jax.block_until_ready(carry.acc)
                    print(f"  adaptive round pairs [{lo},{hi}): "
                          f"active {len(alive)}/{N} "
                          f"({len(alive)/N:.1%}), "
                          f"{_time.time() - t_round:.2f}s", flush=True)
                lo = hi
        else:
            carry = run(C, n_pairs, cv, carry, act_full, N)
    else:
        carry = run(0, n_pairs, zcv, carry, act_full, N)

    n_valid = carry.acc[:, 2]
    denom = jnp.maximum(n_valid, 1.0)
    p = carry.acc[:, 0] / denom
    grad = carry.acc[:, 3:3 + D] / denom[:, None]
    if mask_invalid:
        p = jnp.where(pd.degenerate, 0.0, p)
        grad = jnp.where(pd.degenerate[..., None], 0.0, grad)
    return p, grad, n_valid.astype(jnp.int32)
