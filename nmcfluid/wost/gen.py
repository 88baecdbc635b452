"""Generation-lockstep execution of the WoSt gradient estimator.

Third executor next to the lockstep pair loop (solver._grad_launch) and
the compacted pool (wost/pool.py): on short-walk scenes (the shipped
fluid configs run sigma = 350, where Russian roulette kills 98.3% of
walks after ONE step) the pool's scatter/refill machinery — prefix-sum
slot assignment, packed per-lane gathers, per-point scatter-adds — is
spent retiring walks that almost all died in the first advance. Here
walks are instead issued in POINT-ALIGNED generations of shape
(G pairs, 2 antithetic, N points):

  * the lane -> point map is a reshape, so per-point data broadcasts in
    and contributions reduce out with a plain sum over the (G, 2) axes —
    ZERO gathers, ZERO scatters, no prefix sums;
  * each generation advances in lockstep until every lane terminated
    (early-exit while_loop) or `gen_step_cap` is hit, whose stragglers
    are DROPPED from the statistics exactly like the reference's
    maxWalkLength overruns (walk_on_stars.h:447-459); at sigma = 350
    the surviving fraction at the default cap (64) is ~0;
  * generations chain inside one device program (fori_loop), so the
    per-launch overhead is paid once per `gen_groups_per_launch`
    generations, not per generation.

RNG streams are IDENTICAL to the pool's — start-state draws keyed on
(pair, point) via the same _strat_dir / fastrand salts, continuation
draws keyed on (per-lane step, pair*N + point) — so for any (pair,
point) the gen executor walks the SAME trajectory the pool would, and
the two executors agree to floating-point reduction order (asserted in
tests/test_gen.py). Estimator math (antithetic first samples, two-stage
frozen control variates, e^{-Z}-cancelled gradient ratios) is shared
with the pool by construction.

On long-tail scenes (karman's near-silhouette walkers) lockstep
generations pay the max walk length across all lanes — use the pool
there; `algo="gen"` is the box/short-walk fast path.
"""
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import fastrand
from .solver import (ACTIVE, DONE_DIRICHLET, DONE_RR, DROP_MAXLEN,
                     WalkSettings, WostScene, _advance, _fresh_state)
from .pool import (PointData, _first_greens, _precompute, _strat_dir,
                   _SALT_U2A, _SALT_U2B, _SALT_JIT_S, _SALT_JIT_B)


def _unpacked_cols(pd: PointData, D: int):
    """Static column slices of pd.packed (see PointData doc): the gen
    executor reads per-point fields directly (broadcast, not gathered)."""
    rot = pd.packed[:, D:2 * D - 1]
    norm1 = pd.packed[:, 2 * D]
    thr1 = pd.packed[:, 2 * D + 1]
    bgd = pd.packed[:, 2 * D + 2]
    return rot, norm1, thr1, bgd


def _start_aligned(scene, settings, pd: PointData, seed2, w, live,
                   source_args, n_pairs, n_anti, N):
    """Start states for a (G, A, N) generation: pool._start_states math
    with the (pair, half, point) decomposition explicit in the layout.
    `w` is (G, 1, 1) pair indices; `live` masks padded pairs."""
    D = scene.dim
    g1 = _first_greens(scene, settings)
    G = w.shape[0]
    lanes = (G, n_anti, N)
    i = jax.lax.broadcasted_iota(jnp.int32, (1, 1, N), 2)
    a = jax.lax.broadcasted_iota(jnp.int32, (1, n_anti, 1), 1)
    sign = 1.0 - 2.0 * a.astype(jnp.float32)
    wu = jnp.broadcast_to(w, (G, 1, 1)).astype(jnp.uint32)
    iu = i.astype(jnp.uint32)
    rot, norm1, thr1, bgd = _unpacked_cols(pd, D)

    if settings.ignore_source:
        first_src = jnp.zeros(lanes, jnp.float32)
        sgd_vec = jnp.zeros(lanes + (D,), jnp.float32)
    else:
        dir_s = _strat_dir(seed2, w, i, _SALT_JIT_S, rot, 0.0,
                           n_pairs, D)                       # (G,1,N,D)
        u2 = jnp.stack([fastrand.uniform(seed2, wu, _SALT_U2A, iu),
                        fastrand.uniform(seed2, wu, _SALT_U2B, iu)],
                       axis=-1)                              # (G,1,N,2)
        ball_b = jax.tree.map(lambda l: l[None, None, :], pd.ball1)
        r_s, _ = g1.sample_radius_u(ball_b, u2)              # (G,1,N)
        y_vol = pd.pts + (sign[..., None] * (r_s * 1.0)[..., None]
                          * dir_s)                           # (G,A,N,D)
        first_src = norm1 * scene.source_fn(y_vol, *source_args)
        sgd_vec = (sign * r_s
                   * g1.grad_norm_over_eval(ball_b, r_s))[..., None] * dir_s
        first_src = jnp.broadcast_to(first_src, lanes)
        sgd_vec = jnp.broadcast_to(sgd_vec, lanes + (D,))

    dir_b = _strat_dir(seed2, w, i, _SALT_JIT_B, rot, 0.5, n_pairs, D)
    bgd_vec = jnp.broadcast_to((sign * bgd)[..., None] * dir_b,
                               lanes + (D,))
    x0 = jnp.broadcast_to(pd.pts + (sign * pd.R1)[..., None] * dir_b,
                          lanes + (D,))
    st = _fresh_state(x0, thr=jnp.broadcast_to(thr1, lanes),
                      acc=first_src)
    ok = jnp.broadcast_to(live & ~pd.degenerate, lanes)
    return st, ok, first_src, bgd_vec, sgd_vec


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _gen_launch(scene: WostScene, settings: WalkSettings, n_pairs: int,
                n_anti: int, N: int, G: int, pd, key, lo_pair, n_groups,
                cv, acc, source_args=()):
    """`n_groups` generations of G pairs starting at pair `lo_pair`
    (dynamic), chained in-graph. Returns the updated (N, 3 + D) packed
    accumulator [sum_sol | sum_first | n_valid | sum_grad]."""
    greens = scene.greens()
    seed_w = fastrand.seed_from_key(jax.random.fold_in(key, 1))
    seed2 = fastrand.seed_from_key(jax.random.fold_in(key, 2))
    D = scene.dim
    cap = settings.gen_step_cap
    i = jax.lax.broadcasted_iota(jnp.int32, (1, 1, N), 2)

    def group_body(g_i, acc):
        lo = lo_pair + g_i * G
        w = lo + jax.lax.broadcasted_iota(jnp.int32, (G, 1, 1), 0)
        live = w < n_pairs
        st, ok, first_src, bgd_vec, sgd_vec = _start_aligned(
            scene, settings, pd, seed2, w, live, source_args,
            n_pairs, n_anti, N)
        # continuation streams: identical ids to the pool (w*N + i,
        # shared by both antithetic halves)
        pl = jnp.broadcast_to((w * N + i).astype(jnp.uint32),
                              (G, n_anti, N))
        S = G * n_anti * N
        S_tail = max(8, min(S, -(-S // max(1, settings.gen_tail_div)
                                 ) // 8 * 8))

        def adv(st, pl_arr):
            steps = st.steps.astype(jnp.uint32)

            def draw(salt, shape):
                return jnp.broadcast_to(
                    fastrand.uniform(seed_w, steps, salt, pl_arr), shape)
            return _advance(scene, greens, settings, st, draw,
                            source_args, step_cap=cap)

        # ---- phase A: full-width lockstep while more lanes survive
        # than the tail buffer holds (one step at sigma=350: 524k ->
        # ~9k actives)
        def n_act(st):
            return jnp.sum((st.status == ACTIVE).astype(jnp.int32))

        def condA(c):
            it, st = c
            return (it < cap) & (n_act(st) > S_tail)

        def bodyA(c):
            it, st = c
            return it + 1, adv(st, pl)

        itA, st = jax.lax.while_loop(condA, bodyA, (jnp.int32(0), st))

        # ---- phase B: compact the survivors ONCE into a detached
        # static S_tail buffer, run the whole tail there (the full-
        # width advance is dominated by the source eval over dead
        # lanes, and per-step S-wide bookkeeping is paid on every lane),
        # merge ONCE. Streams are keyed per-lane, so the
        # compacted execution is bit-identical to full width.
        flat = jax.tree.map(lambda a: a.reshape((S,) + a.shape[3:]), st)
        active = flat.status == ACTIVE
        rank = jnp.cumsum(active.astype(jnp.int32)) - 1
        slot = jnp.where(active & (rank < S_tail), rank, S_tail)
        tid = jnp.full((S_tail,), S, jnp.int32).at[slot].set(
            jnp.arange(S, dtype=jnp.int32), mode="drop")
        safe = jnp.minimum(tid, S - 1)
        sub = jax.tree.map(lambda a: a[safe], flat)
        issued = tid < S
        # padding slots: freeze by masking away from ACTIVE
        sub = sub._replace(status=jnp.where(issued, sub.status, -9))
        pl_sub = pl.reshape(S)[safe]

        def condB(c):
            it, sub = c
            return (it < cap) & jnp.any(sub.status == ACTIVE)

        def bodyB(c):
            it, sub = c
            return it + 1, adv(sub, pl_sub)

        _, sub = jax.lax.while_loop(condB, bodyB, (itA, sub))
        tgt = jnp.where(issued, tid, S)
        flat = jax.tree.map(
            lambda fa, sa: fa.at[tgt].set(sa, mode="drop"), flat, sub)
        st = jax.tree.map(
            lambda a: a.reshape((G, n_anti, N) + a.shape[1:]), flat)
        status = jnp.where(st.status == ACTIVE,
                           DROP_MAXLEN, st.status)

        total = st.acc
        if (settings.solve_double_sided
                and scene.dirichlet_ds_fn is not None
                and not settings.ignore_dirichlet):
            sd = scene.qmod().signed_distance(scene.dirichlet, st.x)
            total = total + jnp.where(
                status == DONE_DIRICHLET,
                st.thr * scene.dirichlet_ds_fn(st.x, sd > 0.0), 0.0)
        elif scene.dirichlet_fn is not None \
                and not settings.ignore_dirichlet:
            total = total + jnp.where(status == DONE_DIRICHLET,
                                      st.thr * scene.dirichlet_fn(st.x),
                                      0.0)
        valid = ((status == DONE_RR) | (status == DONE_DIRICHLET)) & ok
        vf = valid.astype(jnp.float32)

        bc = total - first_src
        gvec = ((bc - cv[:, 0])[..., None] * bgd_vec
                + (first_src - cv[:, 1])[..., None] * sgd_vec)
        contrib = jnp.concatenate(
            [(vf * total)[..., None], (vf * first_src)[..., None],
             vf[..., None], vf[..., None] * gvec], axis=-1)
        return acc + jnp.sum(contrib, axis=(0, 1))      # (N, 3 + D)

    return jax.lax.fori_loop(0, n_groups, group_body, acc)


def estimate_solution_and_gradient_gen(scene: WostScene,
                                       settings: WalkSettings, pts, key,
                                       n_walks=None, mask_invalid=True,
                                       source_args=()):
    """Gen-mode drop-in for solver.estimate_solution_and_gradient.
    Must be called outside jit (hosts the launch loop)."""
    if not settings.fast_rng:
        raise ValueError("gen mode needs the counter-based fast RNG")
    n_walks_total = n_walks or settings.n_walks
    n_anti = 2 if settings.use_gradient_antithetic_variates else 1
    n_pairs = (max(1, n_walks_total // 2) if n_anti == 2
               else n_walks_total)
    N, D = pts.shape
    G = max(1, settings.gen_group_pairs)
    pd = _precompute(scene, settings, pts, key)
    acc = jnp.zeros((N, 3 + D), jnp.float32)
    zcv = jnp.zeros((N, 2), jnp.float32)
    GPL = max(1, settings.gen_groups_per_launch)

    def run(lo_pair, hi_pair, cv, acc):
        n_groups = -(-(hi_pair - lo_pair) // G)
        for g0 in range(0, n_groups, GPL):
            acc = _gen_launch(scene, settings, n_pairs, n_anti, N, G,
                              pd, key, jnp.int32(lo_pair + g0 * G),
                              jnp.int32(min(GPL, n_groups - g0)),
                              cv, acc, source_args)
        return acc

    C = min(n_pairs, max(1, settings.cv_warmup_pairs))
    if n_pairs > C and settings.use_gradient_control_variates:
        # warm-up pairs run with zero CV; the frozen CV is independent
        # of the remaining pairs (unbiased, walk_on_stars.h:501-506)
        C = -(-C // G) * G          # group-aligned warmup boundary
        C = min(C, n_pairs)
        acc = run(0, C, zcv, acc)
        nv = jnp.maximum(acc[:, 2], 1.0)
        cv = acc[:, 0:2] / nv[:, None]
        acc = run(C, n_pairs, cv, acc)
    else:
        acc = run(0, n_pairs, zcv, acc)

    n_valid = acc[:, 2]
    denom = jnp.maximum(n_valid, 1.0)
    p = acc[:, 0] / denom
    grad = acc[:, 3:3 + D] / denom[:, None]
    if mask_invalid:
        p = jnp.where(pd.degenerate, 0.0, p)
        grad = jnp.where(pd.degenerate[..., None], 0.0, grad)
    return p, grad, n_valid.astype(jnp.int32)
