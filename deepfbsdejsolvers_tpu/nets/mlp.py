"""Functional MLP heads for the Y/Z/U/Γ approximators.

Capability parity with the reference's Keras models (a stack of Dense layers
with Glorot-normal kernels, zero biases, tanh/relu hidden activations, linear
output, and an optional trainable scalar ``Y0``):
coupledPricing/Networks.py:6-23 and coupledMFG/Networks.py:6-39.

Design notes
------------
* Parameters are a plain pytree ``{"W": [...], "b": [...], ("y0": scalar)}`` —
  no framework object — so the whole train state stays a flat pytree that can
  be donated, sharded, checkpointed and fed to Pallas kernels directly.
* ``mlp_apply`` works for any leading batch shape ``(..., n_in)``; the rank-3
  ``[M, B, d]`` compensator sweep of the reference (SolversJumpDiff.py:38-39)
  is just the same call — XLA maps it onto one big matmul.
* Hidden widths are intentionally NOT padded here: XLA chooses the layout of
  the tiny feature dims itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Sequence

import jax
import jax.numpy as jnp

Params = Dict[str, Any]


def get_activation(name: str) -> Callable[[jax.Array], jax.Array]:
    """Map an activation name to a function (reference accepts tanh/relu:
    coupledPricing/mainMerton.py:44-46)."""
    table = {
        "tanh": jnp.tanh,
        "relu": jax.nn.relu,
        "sigmoid": jax.nn.sigmoid,
    }
    if name not in table:
        raise ValueError(f"activation must be one of {sorted(table)}, got {name!r}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static description of one MLP head.

    ``with_y0`` adds a trainable scalar ``y0`` to the params pytree (the
    reference's ``Net.Y0`` variable, coupledPricing/Networks.py:13-14), used by
    the Global solvers as the trainable initial BSDE value.
    """

    n_in: int
    hidden: Sequence[int]
    n_out: int
    activation: str = "tanh"
    with_y0: bool = False

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(int(h) for h in self.hidden))

    @property
    def sizes(self) -> tuple:
        return (self.n_in, *self.hidden, self.n_out)


def _glorot_normal(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    fan_in = shape[0] if len(shape) else 1.0
    fan_out = shape[1] if len(shape) > 1 else 1.0
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * jax.random.normal(key, shape, dtype)


def init_mlp(key: jax.Array, spec: MLPSpec, dtype=jnp.float32) -> Params:
    """Initialize params: Glorot-normal kernels, zero biases, optional scalar y0
    (y0 itself Glorot-normal on a scalar shape => std 1, matching Keras
    semantics at coupledPricing/Networks.py:14).

    Documented deviation: the reference's MFG hat-net scalar is Glorot
    *Uniform* (`Net_hat.Y0_hat`, coupledMFG/Networks.py:15 — U(-√3, √3) on a
    scalar shape) while its pricing `Net.Y0` is GlorotNormal; here BOTH
    scalars draw from the unit normal.  Same mean/variance family, different
    distribution of a single init draw — immaterial after the first Adam
    epochs and not worth a per-net init switch."""
    sizes = spec.sizes
    n_layers = len(sizes) - 1
    keys = jax.random.split(key, n_layers + 1)
    Ws = [
        _glorot_normal(keys[i], (sizes[i], sizes[i + 1]), dtype)
        for i in range(n_layers)
    ]
    bs = [jnp.zeros((sizes[i + 1],), dtype) for i in range(n_layers)]
    params: Params = {"W": Ws, "b": bs}
    if spec.with_y0:
        params["y0"] = jax.random.normal(keys[-1], (), dtype)
    return params


def mlp_apply(
    params: Params,
    x: jax.Array,
    activation: Callable[[jax.Array], jax.Array] = jnp.tanh,
    compute_dtype=None,
) -> jax.Array:
    """Forward pass.  ``x``: (..., n_in) -> (..., n_out).

    ``compute_dtype`` optionally casts the matmuls (e.g. bfloat16); the
    result is cast back to the input dtype.
    """
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
    n = len(params["W"])
    for i, (W, b) in enumerate(zip(params["W"], params["b"])):
        if compute_dtype is not None:
            W = W.astype(compute_dtype)
            b = b.astype(compute_dtype)
        # Matmul precision: the platform default, i.e. TF32 tensor cores for
        # f32 on an H100.  Measured on an H100 80GB HBM3 at 700 W: the
        # merton_speed gate lands 1.4e-5 from the closed form (bar 1e-3),
        # and the speed-config loss / gradient sit 1.7e-5 / 2.9e-4 (relative)
        # from the same program in full f32.  The compensator's node sweeps
        # call this same function, so both sides of (Γ − comp) share the
        # rounding; the table FITS and the piece select are exact f32
        # instead (ops/piecewise.py).
        x = jnp.dot(x, W, preferred_element_type=x.dtype) + b
        if i < n - 1:
            x = activation(x)
    return x.astype(out_dtype)


def num_params(params: Params) -> int:
    return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))
