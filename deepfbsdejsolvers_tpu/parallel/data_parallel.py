"""Multi-chip SPMD training over a JAX device mesh.

The reference has no distributed execution of any kind (single-device TF;
SURVEY.md §2 last rows mandate this as new capability).  The parallelism
for this workload:

* **data parallelism** (``data`` mesh axis) — shard the simulated *paths*:
  each chip rolls out its own path shard with a distinct folded RNG key; the
  mesh-wide loss is the ``pmean`` over chips.
* **compensator parallelism** (``comp`` mesh axis) — the inner jump-expectation
  sweep (the reference's 5000-sample MC batch, SolversJumpDiff.py:34, or our
  quadrature nodes) is embarrassingly parallel over nodes and shards over a
  second axis with a ``psum`` of weighted partial sums
  (PricingSolver(comp_axis=...)).  This is the structural analogue of
  expert/sequence parallelism for this model family — the only inner axis wide
  enough to shard (SURVEY.md §5).

Correctness-first structure: the SPMD loss is a ``shard_map`` closure and the
gradient is taken OUTSIDE it (``jax.grad`` differentiates through shard_map's
collectives), so the update equals the single-chip gradient of the mesh-wide
mean loss exactly — no hand-assembled per-shard grad averaging to get wrong.
XLA lowers the transposed psum/pmean to all-reduces over whatever links
join the devices (NVLink between the GPUs of one host); the mesh assumes no
topology.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple, Union

import jax
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

Axes = Union[str, Tuple[str, ...]]


def make_mesh(axis_sizes: Sequence[int] = None,
              axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """Build a Mesh over all (or given) devices; default 1-D data mesh."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (devices.size,)
    if int(np.prod(axis_sizes)) != devices.size:
        raise ValueError(f"mesh {tuple(axis_sizes)} != #devices {devices.size}")
    return Mesh(devices.reshape(tuple(axis_sizes)), tuple(axis_names))


def per_shard_batch(global_batch: int, mesh: Mesh, data_axis: str = "data") -> int:
    """Paths each chip simulates so the mesh covers ``global_batch`` (rounded
    up — the effective global batch is ``per_shard * n_shards``)."""
    n = mesh.shape[data_axis]
    return max(1, -(-int(global_batch) // int(n)))


def make_dp_loss(loss_fn: Callable, mesh: Mesh, data_axis: str = "data") -> Callable:
    """Mesh-wide SPMD loss: per-chip path shards with folded keys, pmean'd.

    The per-shard ``loss_fn(params, key)`` simulates ``batch_per_chip`` paths;
    the wrapped loss equals  mean_i loss_fn(params, fold_in(key, i))  over the
    data axis (and is invariant over any other mesh axes, whose collectives —
    e.g. the compensator psum — run inside ``loss_fn``)."""
    all_axes = tuple(mesh.axis_names)

    # check_vma=False is deliberate: the solver losses initialize their scan
    # carries from device-INVARIANT values (model.init_x, the y0 scalar) that
    # become device-VARYING only through the shard-folded RNG key, and JAX's
    # vma type system rejects an invariant->varying scan carry unless every
    # loss builder pcasts its initial carry to the data axis — axis names the
    # solvers don't (and shouldn't) know.  The correctness property vma would
    # guard is instead tested directly: DP fit == serial fit of the mesh-mean
    # loss and 1-vs-8-shard gradient equality (tests/test_parallel.py).
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                       check_vma=False)
    def dp_loss(params, key):
        idx = jax.lax.axis_index(data_axis)
        local = loss_fn(params, jax.random.fold_in(key, idx))
        return jax.lax.pmean(local, all_axes)

    return dp_loss


def make_dp_update(loss_fn: Callable, optimizer: optax.GradientTransformation,
                   mesh: Mesh, data_axis: str = "data") -> Callable:
    """One SPMD Adam step, jitted: (params, opt_state, key) -> (params,
    opt_state, loss).  Params and optimizer state are replicated; gradients of
    the shard_map'd loss produce the all-reduces automatically."""
    dp_loss = make_dp_loss(loss_fn, mesh, data_axis)

    @jax.jit
    def update(params, opt_state, key):
        loss, grads = jax.value_and_grad(dp_loss)(params, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return update


def make_dp_epoch(loss_fn: Callable, optimizer: optax.GradientTransformation,
                  mesh: Mesh, num_inner: int, data_axis: str = "data") -> Callable:
    """Device-side scan of ``num_inner`` SPMD Adam steps (one host sync per
    outer epoch, multi-chip analogue of solvers/train.py:make_epoch_fn)."""
    dp_loss = make_dp_loss(loss_fn, mesh, data_axis)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(dp_loss)(params, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), loss

    @jax.jit
    def epoch(params, opt_state, key):
        keys = jax.random.split(key, num_inner)
        (params, opt_state), losses = jax.lax.scan(step, (params, opt_state), keys)
        return params, opt_state, losses[-1]

    return epoch
