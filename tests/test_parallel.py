"""Multi-chip SPMD tests on the 8-device virtual CPU mesh (SURVEY.md §4:
"run the same seed on 1 chip vs k chips and assert equality of the psum'd
gradients" — the substitute for a fake NCCL backend)."""

# Tier split: the fast ``quick`` tier keeps a small
# representative DP set (device availability, loss==serial-mean, the
# update/epoch path, one MFG mesh fit); the exhaustive equality matrix —
# gradient equality, per-config hoist/chebyshev/VG twins, the 2-D
# compensator mesh, dryrun_multichip — carries ``full`` and runs in the
# default tier.  shard_map COMPILE time on the 8-device virtual mesh, not
# compute, is what made these the heaviest tests in quick.

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from deepfbsdejsolvers_tpu.models.merton import MertonJumpModel, abs_coupling
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.parallel.data_parallel import (
    make_dp_epoch,
    make_dp_loss,
    make_dp_update,
    make_mesh,
)
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import make_adam

SMALL_QUAD = CompensatorSpec(kind="quadrature", n_poisson_max=3, n_hermite=4)

# Under FBSDEJ_DEVICE_TESTS=1 (conftest.py) the real accelerator is visible
# and the virtual 8-CPU mesh is not provisioned — the SPMD tests need it.
pytestmark = pytest.mark.skipif(
    jax.device_count() < 8,
    reason="needs the 8-device virtual CPU mesh (unset FBSDEJ_DEVICE_TESTS)")


def tiny_model(n=4):
    return MertonJumpModel(T=1.0, N=n, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3,
                           lam=3.0, K=0.9, x0=1.0, coupling=abs_coupling(0.1))


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_dp_loss_equals_serial_mean(rng_key):
    """shard_map loss == mean over shards of the per-shard losses computed
    serially with the same folded keys."""
    solver = PricingSolver(tiny_model(), "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    loss_fn = solver.build_loss(16)
    mesh = make_mesh((8,))
    dp_loss = make_dp_loss(loss_fn, mesh)
    got = float(dp_loss(params, rng_key))
    jitted = jax.jit(loss_fn)  # one compile for the 8 serial reference evals
    want = float(np.mean([
        float(jitted(params, jax.random.fold_in(rng_key, i))) for i in range(8)
    ]))
    assert abs(got - want) < 1e-6


@pytest.mark.full
def test_dp_grads_equal_serial_grads(rng_key):
    """The 8-chip psum'd gradient == single-device gradient of the mesh-mean
    loss, to float32 tolerance."""
    solver = PricingSolver(tiny_model(), "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    loss_fn = solver.build_loss(16)
    mesh = make_mesh((8,))
    dp_loss = make_dp_loss(loss_fn, mesh)
    g_dp = jax.grad(dp_loss)(params, rng_key)

    def serial(params, key):
        return jnp.mean(jnp.stack([
            loss_fn(params, jax.random.fold_in(key, i)) for i in range(8)
        ]))

    g_serial = jax.grad(serial)(params, rng_key)
    for a, b in zip(jax.tree_util.tree_leaves(g_dp),
                    jax.tree_util.tree_leaves(g_serial)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-7)


def test_dp_update_step_and_epoch(rng_key):
    solver = PricingSolver(tiny_model(), "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    optimizer = make_adam(1e-3)
    opt_state = optimizer.init(params)
    mesh = make_mesh((8,))
    update = make_dp_update(solver.build_loss(8), optimizer, mesh)
    p1, s1, l1 = update(params, opt_state, rng_key)
    assert np.isfinite(float(l1))
    epoch = make_dp_epoch(solver.build_loss(8), optimizer, mesh, num_inner=5)
    p2, s2, l2 = epoch(params, opt_state, rng_key)
    assert np.isfinite(float(l2))
    # params actually moved
    delta = sum(float(jnp.sum(jnp.abs(a - b))) for a, b in zip(
        jax.tree_util.tree_leaves(p2), jax.tree_util.tree_leaves(params)))
    assert delta > 0


@pytest.mark.full
def test_compensator_sharding_matches_unsharded(rng_key):
    """2-D mesh (data=4, comp=2): sharding the quadrature node axis with psum
    must reproduce the unsharded compensator loss and gradients."""
    model = tiny_model()
    spec = CompensatorSpec(kind="quadrature", n_poisson_max=4, n_hermite=4)
    base = PricingSolver(model, "global", hidden=(8, 8), compensator=spec)
    params = base.init_params(rng_key)

    mesh2 = make_mesh((4, 2), ("data", "comp"))
    sharded = PricingSolver(model, "global", hidden=(8, 8), compensator=spec,
                            comp_axis="comp", comp_shards=2)
    dp_loss_sharded = make_dp_loss(sharded.build_loss(16), mesh2)

    mesh1 = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    dp_loss_base = make_dp_loss(base.build_loss(16), mesh1)

    a = float(dp_loss_base(params, rng_key))
    b = float(dp_loss_sharded(params, rng_key))
    assert abs(a - b) < 1e-5

    ga = jax.grad(dp_loss_base)(params, rng_key)
    gb = jax.grad(dp_loss_sharded)(params, rng_key)
    for x, y in zip(jax.tree_util.tree_leaves(ga), jax.tree_util.tree_leaves(gb)):
        # f32 reduction-order noise between the psum'd and fused sweeps
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=5e-4, atol=5e-6)


@pytest.mark.full
def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, ".")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    v = jax.jit(fn)(*args)
    assert np.isfinite(float(v))
    ge.dryrun_multichip(8)


@pytest.mark.full
def test_dp_fit_equals_serial_fit_of_mesh_mean(rng_key):
    """The production DP path (fit(mesh=...)) == single-device fit of the
    mesh-mean loss: same keys, same Adam, identical final params."""
    from deepfbsdejsolvers_tpu.solvers.train import fit

    solver = PricingSolver(tiny_model(), "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    loss_fn = solver.build_loss(8)
    mesh = make_mesh((8,))
    key = jax.random.fold_in(rng_key, 7)

    # SGD keeps the update linear in the gradient, so the comparison is at
    # f32 reduction-noise level.  (Adam's rsqrt normalization amplifies the
    # ~1e-7 pmean-vs-stacked-mean reassociation noise on near-zero-gradient
    # params to full-lr steps, which would make any param-level equality
    # vacuous.)
    sgd = optax.sgd(1e-2)
    res_dp = fit(loss_fn, params, key, lrate=1e-3, num_epoch=3,
                 num_epoch_ext=2, verbose=False, mesh=mesh, optimizer=sgd)

    def mesh_mean(p, k):
        return jnp.mean(jnp.stack([
            loss_fn(p, jax.random.fold_in(k, i)) for i in range(8)]))

    res_serial = fit(mesh_mean, params, key, lrate=1e-3, num_epoch=3,
                     num_epoch_ext=2, verbose=False, optimizer=sgd)
    for a, b in zip(jax.tree_util.tree_leaves(res_dp.params),
                    jax.tree_util.tree_leaves(res_serial.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(res_dp.loss_history, res_serial.loss_history,
                               rtol=1e-4, atol=1e-7)


def test_mfg_train_on_mesh(rng_key):
    """MFGSolver.train(mesh=...) runs the coupled MFG training data-parallel
    and returns finite Y0 pairs (production DP for the MFG stack)."""
    from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
    from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

    model = make_mfg_default(nb_days=1)
    solver = MFGSolver(model=model, scheme="global", hidden_hat=(8, 8),
                       hidden=(8, 8))
    mesh = make_mesh((8,))
    res = solver.train(key=rng_key, batch=32, batch_val=64, num_epoch=2,
                       num_epoch_ext=1, lrate=1e-3, couplage="ON",
                       verbose=False, mesh=mesh)
    assert np.isfinite(res.y0_hat_history[-1])
    assert np.isfinite(res.y0_history[-1])
    assert np.isfinite(res.loss_history[-1])


@pytest.mark.full
def test_dp_with_chebyshev_compensator(rng_key):
    """The speed-config loss (Chebyshev-collocated compensator + pricer) runs
    under shard_map: each data shard collocates over its own spot range, and
    the mesh loss/grads stay finite and consistent with the serial mean."""
    model = MertonJumpModel(T=1.0, N=4, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3,
                            lam=3.0, K=0.9, x0=1.0, coupling=abs_coupling(0.1),
                            price_mode="chebyshev", jump_sampler="icdf")
    solver = PricingSolver(
        model, "global", hidden=(8, 8),
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=8))
    params = solver.init_params(rng_key)
    mesh = make_mesh((8,), ("data",))
    loss_fn = solver.build_loss(16)  # per-shard batch
    dp_loss = make_dp_loss(loss_fn, mesh)

    with mesh:
        val, grads = jax.value_and_grad(dp_loss)(params, rng_key)
    assert np.isfinite(float(val))
    # serial reference: mean of the per-shard losses with the same folded keys
    serial = np.mean([
        float(jax.jit(loss_fn)(params, jax.random.fold_in(rng_key, idx)))
        for idx in range(8)
    ])
    assert float(val) == pytest.approx(serial, rel=1e-5)
    gn = sum(float(jnp.sum(jnp.abs(g)))
             for g in jax.tree_util.tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.full
def test_dp_with_hoisted_piecewise_tables(rng_key):
    """The round-3 production speed path (hoisted per-step collocation
    tables + piecewise evaluator — what `--fast --dataParallel` runs) under
    shard_map: each data shard builds tables from its OWN shard's noise
    marginals; mesh loss == serial mean of the per-shard losses."""
    model = MertonJumpModel(T=1.0, N=4, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3,
                            lam=3.0, K=0.9, x0=1.0, coupling=abs_coupling(0.1),
                            price_mode="chebyshev", jump_sampler="icdf")
    solver = PricingSolver(
        model, "global", hidden=(8, 8),
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise")
    params = solver.init_params(rng_key)
    mesh = make_mesh((8,), ("data",))
    loss_fn = solver.build_loss(16)  # per-shard batch
    dp_loss = make_dp_loss(loss_fn, mesh)

    with mesh:
        val, grads = jax.value_and_grad(dp_loss)(params, rng_key)
    assert np.isfinite(float(val))
    serial = np.mean([
        float(jax.jit(loss_fn)(params, jax.random.fold_in(rng_key, idx)))
        for idx in range(8)
    ])
    assert float(val) == pytest.approx(serial, rel=1e-5)
    gn = sum(float(jnp.sum(jnp.abs(g)))
             for g in jax.tree_util.tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.full
def test_vg_dp_loss_and_grads_match_serial(rng_key):
    """VG (pure-jump) speed config under shard_map: mesh loss == serial mean
    of per-shard losses, grads finite — the VG twin of the Merton DP tests
    (round 4: multi-device certification beyond Merton)."""
    import dataclasses

    from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

    model = dataclasses.replace(
        make_vg_default(), N=4, price_eval="chebyshev", jump_sampler="icdf")
    solver = PricingSolver(
        model, "global", hidden=(8, 8),
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=16),
        hoist=True, hoist_interp="piecewise")
    params = solver.init_params(rng_key)
    mesh = make_mesh((8,), ("data",))
    loss_fn = solver.build_loss(16)  # per-shard batch
    dp_loss = make_dp_loss(loss_fn, mesh)

    with mesh:
        val, grads = jax.value_and_grad(dp_loss)(params, rng_key)
    assert np.isfinite(float(val))
    serial = np.mean([
        float(jax.jit(loss_fn)(params, jax.random.fold_in(rng_key, idx)))
        for idx in range(8)
    ])
    assert float(val) == pytest.approx(serial, rel=1e-5)
    gn = sum(float(jnp.sum(jnp.abs(g)))
             for g in jax.tree_util.tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0
