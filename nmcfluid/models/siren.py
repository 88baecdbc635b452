"""SIREN coordinate networks as plain JAX pytrees.

Rebuild of the reference's PyTorch MLP (src/2d/models/networks.py:25-68):
a Linear->sin(30.) stack with the SIREN initialization — first layer
U(-1/fan_in, 1/fan_in), hidden layers U(+-sqrt(6/fan_in)/30)
(networks.py:78-90) — plus the relu/elu/tanh alternatives
(networks.py:34-37, init at :71-96; the 3D file differs only in the
normal-init std, 1.0 vs 0.1).

Design notes:
  * Parameters live in a flat list-of-(W, b) pytree; `apply_siren` is a pure
    function, so phase trainers swap params freely (the reference's
    velocity/prev/tilde triple becomes three pytrees sharing one apply).
  * All matmuls are (batch, H) x (H, H) with H in {64, 128} and batches of
    128^2..512^2 points. Weights stay f32 (they are <=200k numbers;
    accuracy of the PDE fit dominates, not memory traffic).
  * Matmul precision defaults to Precision.HIGHEST, full f32: the
    reference trains in f32 (networks.py matmuls), and the sin(30x)
    layers amplify input rounding into a velocity-error floor far above
    the phase fits' 1.1e-10 early-stop MSE target. Reduced-precision
    modes (TF32 on the GPU) are selectable with NMCFLUID_MATMUL_PRECISION
    but have not passed the Taylor-Green error gate on the GPU.
  * Biases are zero-init: torch.nn.Linear's default U(+-1/sqrt(fan_in)) bias
    init is noise the SIREN paper does not rely on; zero keeps the first
    activations in sin's linear regime. (Deliberate deviation, documented.)
"""
import dataclasses
import math
import os
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def resolve_precision(name=None):
    """Matmul precision for the network layers: `name`, else the
    NMCFLUID_MATMUL_PRECISION variable, else 'highest' (full f32; see the
    module notes). An 8-bit-mantissa 'default' failed the Taylor-Green
    error gate (error_bem_prec_default_r3.txt: 6.86e-4 against the
    published 4.142e-4)."""
    if name is None:
        name = os.environ.get("NMCFLUID_MATMUL_PRECISION", "highest")
    try:
        return _PRECISIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"NMCFLUID_MATMUL_PRECISION={name!r}: expected one of "
            f"{sorted(_PRECISIONS)}") from None


_PRECISION = resolve_precision()

Params = List[Tuple[jax.Array, jax.Array]]

OMEGA_0 = 30.0  # networks.py:21


@dataclasses.dataclass(frozen=True)
class SirenConfig:
    in_features: int
    out_features: int
    num_hidden_layers: int = 2   # reference --num_hidden_layers
    hidden_features: int = 128   # reference --hidden_features
    nonlinearity: str = "sine"   # sine | relu | elu | tanh
    normal_init_std: float = 0.1  # 2D networks.py:75; 3D uses 1.0


def _layer_dims(cfg: SirenConfig):
    dims = [cfg.in_features] + [cfg.hidden_features] * (
        cfg.num_hidden_layers + 1) + [cfg.out_features]
    return list(zip(dims[:-1], dims[1:]))


def init_siren(key, cfg: SirenConfig) -> Params:
    """Initialize parameters. Matches networks.py:78-96 per nonlinearity."""
    params = []
    dims = _layer_dims(cfg)
    keys = jax.random.split(key, len(dims))
    for i, ((fan_in, fan_out), k) in enumerate(zip(dims, keys)):
        if cfg.nonlinearity == "sine":
            if i == 0:
                bound = 1.0 / fan_in          # first_layer_sine_init
            else:
                bound = math.sqrt(6.0 / fan_in) / OMEGA_0
            w = jax.random.uniform(k, (fan_in, fan_out), jnp.float32,
                                   -bound, bound)
        elif cfg.nonlinearity == "elu":
            std = math.sqrt(1.5505188080679277) / math.sqrt(fan_in)
            w = std * jax.random.normal(k, (fan_in, fan_out), jnp.float32)
        else:  # relu / tanh: normal(0, std)
            w = cfg.normal_init_std * jax.random.normal(
                k, (fan_in, fan_out), jnp.float32)
        b = jnp.zeros((fan_out,), jnp.float32)
        params.append((w, b))
    return params


def _nl(name: str, x):
    if name == "sine":
        return jnp.sin(OMEGA_0 * x)
    if name == "relu":
        return jax.nn.relu(x)
    if name == "elu":
        return jax.nn.elu(x)
    if name == "tanh":
        return jnp.tanh(x)
    raise NotImplementedError(name)


def apply_siren(params: Params, cfg: SirenConfig, x, precision=None):
    """Evaluate the network at x (..., in_features) -> (..., out_features).

    The outermost layer is linear (networks.py:53-54, outermost_linear).
    `precision` overrides the module's matmul precision."""
    w, b = params[-1]
    prec = _PRECISION if precision is None else precision
    dot = partial(jnp.dot, precision=prec)
    return dot(apply_siren_features(params, cfg, x, precision), w) + b


def apply_siren_features(params: Params, cfg: SirenConfig, x,
                         precision=None):
    """Penultimate activations: the (..., hidden_features) input to the
    final linear layer. Because that layer is linear (outermost_linear,
    networks.py:53-54), the network is affine in its head given these
    features — which is what makes the closed-form head solve in
    sim.fluid exact."""
    prec = _PRECISION if precision is None else precision
    dot = partial(jnp.dot, precision=prec)
    h = x
    for w, b in params[:-1]:
        h = _nl(cfg.nonlinearity, dot(h, w) + b)
    return h
