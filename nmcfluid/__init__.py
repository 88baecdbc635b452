"""nmcfluid — a neural Monte Carlo fluid solver in JAX.

A from-scratch rebuild of the capability set of
Pranav-Jain/Neural-Monte-Carlo-Fluid-Simulation ("Neural Monte Carlo Fluid
Simulation", Jain, Qu, Chen, Stein): an incompressible-flow simulator whose
velocity field is a per-timestep-trained SIREN coordinate network, advected
semi-Lagrangianly and made divergence-free by a walk-on-stars (WoSt) Monte
Carlo screened-Poisson pressure projection.

Layer map (see SURVEY.md for the reference analysis this build follows):

  ops/       Green's functions, Bessel functions, sphere/ball sampling,
             autodiff operators        (replaces zombie core/distributions.h,
             core/sampling.h, src/*/utils/diff_ops.py)
  geometry/  segment/triangle soups, closest-point / ray / silhouette
             queries, analytic SDFs    (replaces FCPW + geometric_queries.h)
  wost/      the batched walk-on-stars estimator — solution and gradient —
             as vectorized JAX
                                       (replaces zombie walk_on_stars.h and
             the pybind11 demo bindings)
  models/    SIREN velocity fields, per-scene hard boundary conditions
                                       (replaces src/*/models/networks.py and
             the query_velocity logic of src/*/models/base.py)
  sim/       jitted phase trainers (add-source / advect / project) and the
             operator-split time stepper
                                       (replaces src/*/models/model_split.py)
  scenes/    declarative scene specs: Taylor-Green, Karman 2D/3D, jpipe,
             smoke 3D, smoke+obstacle, vortex collide
                                       (replaces examples/*/wost.json +
             src/*/sources.py + the OBJ assets, generated procedurally)
  transport/ passive density advection + export
                                       (replaces src/*/move_density.py)
  parallel/  jax.sharding mesh utilities: point/walker sharding for the MC
             solve, batch sharding for training
  utils/     config, checkpointing, visualization, error metrics
"""

__version__ = "0.1.0"
