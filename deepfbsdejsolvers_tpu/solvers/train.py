"""Training loop: Adam + device-side inner-epoch scan.

The reference trains with a fresh ``keras.optimizers.Adam`` per solver and a
host-side double loop — ``num_epochExt`` outer epochs x ``num_epoch`` inner
gradient steps — printing loss / cumulative seconds / current Y0 each outer
epoch (SolversJumpDiff.py:55-73).

Rebuild: one jitted function runs ALL ``num_epoch`` inner steps as a
``lax.scan`` over Adam updates, so the host syncs exactly once per outer epoch
(the single biggest wall-clock lever after batch vectorization).  Adam uses
eps=1e-7 to match Keras' default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import jax
import optax


@dataclasses.dataclass
class TrainResult:
    """Mirror of the reference's train() outputs (SolversJumpDiff.py:73 returns
    (listY0, duration); SolversPureJump.py:72 returns (listY0, durationList))."""

    params: Any
    y0_history: List[float]
    loss_history: List[float]
    duration: float
    duration_history: List[float]

    # tuple-compat with the reference's return convention
    def __iter__(self):
        return iter((self.y0_history, self.duration))


def make_adam(lrate: float) -> optax.GradientTransformation:
    return optax.adam(learning_rate=lrate, eps=1e-7)


def make_epoch_fn(loss_fn: Callable, optimizer: optax.GradientTransformation,
                  num_inner: int) -> Callable:
    """Jitted: (params, opt_state, key) -> (params, opt_state, mean_loss).

    Runs ``num_inner`` gradient steps on device; per-step keys are split from
    the epoch key.  Buffers are deliberately NOT donated: params here are
    KB-sized MLPs (nothing to save) and callers legitimately reuse the
    initial params across fits (warm restarts, resume tests).
    """

    def update(carry, key):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    @jax.jit
    def epoch(params, opt_state, key):
        keys = jax.random.split(key, num_inner)
        (params, opt_state), losses = jax.lax.scan(update, (params, opt_state), keys)
        return params, opt_state, losses[-1]

    return epoch


def fit(
    loss_fn: Callable,
    params,
    key: jax.Array,
    lrate: float,
    num_epoch: int,
    num_epoch_ext: int,
    val_loss_fn: Optional[Callable] = None,
    y0_fn: Optional[Callable] = None,
    verbose: bool = True,
    on_epoch: Optional[Callable[[int, dict, Any], None]] = None,
    start_epoch: int = 0,
    opt_state: Any = None,
    mesh: Any = None,
    data_axis: str = "data",
    optimizer: Optional[optax.GradientTransformation] = None,
) -> TrainResult:
    """Train ``params`` for num_epoch_ext outer epochs of num_epoch Adam steps.

    ``val_loss_fn(params, key)`` is evaluated once per outer epoch on the
    validation batch (the reference's optimizeBSDE(batchSizeVal),
    SolversJumpDiff.py:68); ``y0_fn(params)`` extracts the current Y0 estimate.

    ``on_epoch(epoch_idx, metrics, state)`` fires after each outer epoch with
    ``metrics = {loss, y0, duration_s}`` and ``state = (params, opt_state,
    key)`` — the hook point for JSONL metrics and checkpointing.
    ``start_epoch``/``opt_state`` support deterministic resume: per-epoch keys
    are folded from the epoch index, so restarting at epoch k replays the same
    noise stream the uninterrupted run would have seen.

    ``mesh``: a ``jax.sharding.Mesh`` with a ``data_axis`` axis switches every
    gradient step (and the validation eval) to the SPMD data-parallel path
    (parallel/data_parallel.py): each chip rolls out ``loss_fn``'s batch with
    its own folded key and the update is the gradient of the mesh-mean loss,
    all-reduced across the mesh.  ``loss_fn``/``val_loss_fn`` are then *per-shard*
    losses — build them with the per-chip batch size.

    ``optimizer``: optional optax transformation overriding the default
    ``make_adam(lrate)`` (``lrate`` may itself be an optax schedule — optax
    Adam accepts callables).
    """
    if optimizer is None:
        optimizer = make_adam(lrate)
    if opt_state is None:
        opt_state = optimizer.init(params)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from deepfbsdejsolvers_tpu.parallel.data_parallel import (
            make_dp_epoch, make_dp_loss)

        # Replicate (params, opt_state) onto the mesh.  Arrays committed to a
        # single device (e.g. a restored checkpoint) cannot be mixed with the
        # mesh-wide shard_map step ("incompatible devices"); fresh inits are
        # uncommitted and pass through at no cost.  This makes
        # resume-under-mesh equal resume-single-device followed by replication
        # (tests/test_checkpoint.py::test_resume_is_deterministic_under_mesh).
        replicated = NamedSharding(mesh, PartitionSpec())
        params = jax.device_put(params, replicated)
        opt_state = jax.device_put(opt_state, replicated)
        key = jax.device_put(key, replicated)
        epoch_fn = make_dp_epoch(loss_fn, optimizer, mesh, num_epoch, data_axis)
        val_fn = (jax.jit(make_dp_loss(val_loss_fn, mesh, data_axis))
                  if val_loss_fn is not None else None)
    else:
        epoch_fn = make_epoch_fn(loss_fn, optimizer, num_epoch)
        val_fn = jax.jit(val_loss_fn) if val_loss_fn is not None else None

    y0_hist: List[float] = []
    loss_hist: List[float] = []
    dur_hist: List[float] = []
    duration = 0.0
    for iout in range(start_epoch, num_epoch_ext):
        # Keys are a pure function of (key, epoch index) so a resumed run
        # replays the identical noise stream (utils/checkpointing.py).
        k_epoch = jax.random.fold_in(key, 2 * iout)
        k_val = jax.random.fold_in(key, 2 * iout + 1)
        t0 = time.perf_counter()
        params, opt_state, last_loss = epoch_fn(params, opt_state, k_epoch)
        jax.block_until_ready(last_loss)
        duration += time.perf_counter() - t0
        obj = float(val_fn(params, k_val)) if val_fn is not None else float(last_loss)
        if y0_fn is not None:
            y0 = jax.tree_util.tree_map(float, y0_fn(params))
        else:
            y0 = float("nan")
        if verbose:
            print(f" Error {obj:.6g}  elapsed time {duration:5.3f} s  "
                  f"Y0 sofar {y0}  epoch {iout}")
        y0_hist.append(y0)
        loss_hist.append(obj)
        dur_hist.append(duration)
        if on_epoch is not None:
            on_epoch(iout, {"loss": obj, "y0": y0, "duration_s": duration},
                     (params, opt_state, key))
    return TrainResult(params, y0_hist, loss_hist, duration, dur_hist)
