import sys
import os

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_points_mesh_has_8_cpu_devices():
    from nmcfluid.parallel import points_mesh
    mesh = points_mesh()
    assert mesh.devices.size == 8


def test_sharded_pressure_solve_matches_single_device():
    """The WoSt solve is embarrassingly parallel over points: sharding the
    cloud across the mesh must not change the estimates (same keys)."""
    import dataclasses
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.fluid import _divergence_grid, _pressure_solve
    from nmcfluid.wost.solver import WalkSettings

    scene = get_scene("taylorgreen")
    scene = dataclasses.replace(scene, max_n_iters=2)
    kw = dict(sample_resolution=8, wost_resolution=8, div_resolution=16,
              walk_settings=WalkSettings(n_walks=16, walk_step_cap=16))
    fl0 = NeuralFluid(scene, **kw)
    fl8 = NeuralFluid(scene, mesh=points_mesh(), **kw)
    st = fl0.init_state(0)
    key = jax.random.PRNGKey(11)
    div0 = _divergence_grid(fl0, st.params, st.eps, st.timestep)
    pts0, v0, p0, g0 = _pressure_solve(fl0, fl0._wost_scene, (div0,), key)
    with fl8.mesh:
        div8 = _divergence_grid(fl8, st.params, st.eps, st.timestep)
        pts8, v8, p8, g8 = _pressure_solve(fl8, fl8._wost_scene, (div8,), key)
    np.testing.assert_allclose(np.asarray(pts0), np.asarray(pts8), atol=0)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p8), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g8), rtol=2e-5,
                               atol=1e-5)


def test_sharded_step_matches_single_device():
    """Full step() (advect fit + WoSt projection + projection fit) with
    every hot point cloud sharded over the 8-device mesh must track the
    single-device step: same keys -> same batches, so params drift only by
    reduction-order noise amplified through ~100 Adam iterations."""
    import dataclasses
    import numpy as np
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.wost.solver import WalkSettings

    scene = get_scene("taylorgreen")
    scene = dataclasses.replace(scene, max_n_iters=40)
    kw = dict(sample_resolution=16, wost_resolution=16, div_resolution=32,
              walk_settings=WalkSettings(n_walks=16, walk_step_cap=16,
                                         pool_step_cap=64))
    fl0 = NeuralFluid(scene, **kw)
    fl8 = NeuralFluid(scene, mesh=points_mesh(), **kw)
    st0 = fl0.init_state(3)
    st8 = fl8.init_state(3)
    for l0, l8 in zip(jax.tree.leaves(st0.params),
                      jax.tree.leaves(st8.params)):
        np.testing.assert_array_equal(np.asarray(l0), np.asarray(l8))
    out0 = fl0.step(st0)
    with fl8.mesh:
        out8 = fl8.step(st8)
    u0 = np.asarray(fl0.sample_velocity_grid(out0, 24))
    u8 = np.asarray(fl8.sample_velocity_grid(out8, 24))
    scale = max(np.abs(u0).max(), 1e-6)
    np.testing.assert_allclose(u8 / scale, u0 / scale, atol=5e-3)
    assert int(out8.timestep) == 1


def test_sharded_solve_divides_points_across_devices():
    """The point-axis sharding must actually DIVIDE the work: every output
    of the sharded pressure solve carries one shard of exactly N/devices
    points per device (not a replicated copy)."""
    import dataclasses
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.fluid import _divergence_grid, _pressure_solve
    from nmcfluid.wost.solver import WalkSettings

    scene = get_scene("taylorgreen")
    scene = dataclasses.replace(scene, max_n_iters=2)
    mesh = points_mesh()
    n_dev = mesh.devices.size
    fl = NeuralFluid(scene, mesh=mesh, sample_resolution=8,
                     wost_resolution=16, div_resolution=16,
                     walk_settings=WalkSettings(n_walks=8, walk_step_cap=8))
    st = fl.init_state(0)
    with fl.mesh:
        div = _divergence_grid(fl, st.params, st.eps, st.timestep)
        pts, valid, p, g = _pressure_solve(fl, fl._wost_scene, (div,),
                                           jax.random.PRNGKey(0))
    n = pts.shape[0]
    assert n % n_dev == 0
    # `valid` is a tiny replicated bool mask; the heavy outputs must shard
    for name, arr in [("pts", pts), ("p", p), ("g", g)]:
        shards = arr.addressable_shards
        assert len(shards) == n_dev, name
        seen_devices = set()
        for s in shards:
            assert s.data.shape[0] == n // n_dev, (name, s.data.shape)
            seen_devices.add(s.device)
        assert len(seen_devices) == n_dev, name


def test_graft_entry_and_dryrun():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (4096, 2)
    g.dryrun_multichip(8)


def test_sharded_spectral_projection_matches_single_device():
    """The deterministic projection (DCT + modal obstacle correction on
    karman) must also be sharding-invariant: same keys -> same cloud, and
    the per-point modal/interp math carries no cross-point coupling."""
    import dataclasses
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.fluid import (_divergence_grid,
                                    _pressure_solve_spectral)

    scene = get_scene("karman")
    scene = dataclasses.replace(scene, max_n_iters=2)
    kw = dict(sample_resolution=8, wost_resolution=8, div_resolution=64,
              projection="spectral")
    fl0 = NeuralFluid(scene, **kw)
    fl8 = NeuralFluid(scene, mesh=points_mesh(), **kw)
    st = fl0.init_state(0)
    key = jax.random.PRNGKey(7)
    div0 = _divergence_grid(fl0, st.params, st.eps, st.timestep)
    pts0, v0, p0, g0 = _pressure_solve_spectral(fl0, div0, key, st.eps,
                                                st.timestep)
    with fl8.mesh:
        div8 = _divergence_grid(fl8, st.params, st.eps, st.timestep)
        pts8, v8, p8, g8 = _pressure_solve_spectral(fl8, div8, key, st.eps,
                                                    st.timestep)
    np.testing.assert_allclose(np.asarray(pts0), np.asarray(pts8), atol=0)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p8), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g8), rtol=2e-5,
                               atol=2e-5)


def test_sharded_bem_projection_matches_single_device():
    """The boundary-element projection is also sharding-invariant: FFT
    grids and the Nystrom inverse are replicated constants; the splat is
    per-point."""
    import dataclasses
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.bem import BemProjector
    from nmcfluid.sim.fluid import _divergence_grid, _pressure_solve_bem

    scene = get_scene("karman")
    scene = dataclasses.replace(scene, max_n_iters=2)
    kw = dict(sample_resolution=8, wost_resolution=8, div_resolution=64,
              projection="bem")
    fl0 = NeuralFluid(scene, **kw)
    fl8 = NeuralFluid(scene, mesh=points_mesh(), **kw)
    bp = BemProjector(scene, 64, eval_chunk=16)
    st = fl0.init_state(0)
    key = jax.random.PRNGKey(7)
    div0 = _divergence_grid(fl0, st.params, st.eps, st.timestep)
    pts0, v0, p0, g0 = _pressure_solve_bem(fl0, bp, div0, key)
    with fl8.mesh:
        div8 = _divergence_grid(fl8, st.params, st.eps, st.timestep)
        pts8, v8, p8, g8 = _pressure_solve_bem(fl8, bp, div8, key)
    np.testing.assert_allclose(np.asarray(pts0), np.asarray(pts8), atol=0)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p8), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g8), rtol=2e-5,
                               atol=2e-5)


def test_xla_fit_under_mesh_matches():
    """The while_loop phase fit under the 8-device mesh (minibatches
    point-sharded, parameters replicated, the loss a cross-device sum)
    must match the meshless fit from the same keys up to reduction
    order."""
    import dataclasses
    from nmcfluid.parallel import points_mesh
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.fluid import _fit_source
    from nmcfluid.wost.solver import WalkSettings

    scene = get_scene("taylorgreen")
    scene = dataclasses.replace(scene, max_n_iters=12)
    kw = dict(sample_resolution=16, wost_resolution=8, div_resolution=16,
              ls_head=0,
              walk_settings=WalkSettings(n_walks=4, walk_step_cap=4))
    fl0 = NeuralFluid(scene, **kw)
    fl8 = NeuralFluid(scene, mesh=points_mesh(), **kw)
    st = fl0.init_state(0)
    key = jax.random.PRNGKey(5)
    p0, s0 = _fit_source(fl0, st.params, key, st.eps, st.timestep)
    with fl8.mesh:
        p8, s8 = _fit_source(fl8, st.params, key, st.eps, st.timestep)
    assert int(s0.iters) == int(s8.iters) == 12
    # 12 Adam steps at lr 1e-5 move a parameter by <= 1.2e-4; the bound
    # admits reduction-order noise, not a different trajectory
    for (w0, b0), (w8, b8) in zip(p0, p8):
        np.testing.assert_allclose(np.asarray(w0), np.asarray(w8),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(b0), np.asarray(b8),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(s0.loss), float(s8.loss), rtol=1e-4)
