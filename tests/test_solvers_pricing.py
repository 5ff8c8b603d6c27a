"""Smoke + behavior tests for the 7x2 pricing solver family (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfbsdejsolvers_tpu.models.merton import MertonJumpModel, abs_coupling
from deepfbsdejsolvers_tpu.models.variance_gamma import VGModel
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PRICING_SCHEMES, PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import fit

SMALL_QUAD = CompensatorSpec(kind="quadrature", n_poisson_max=3, n_hermite=4,
                             n_laguerre=4)


def tiny_merton(n_steps=5):
    return MertonJumpModel(T=1.0, N=n_steps, r=0.1, muJ=0.0, sigJ=0.2, sigma=0.3,
                           lam=3.0, K=0.9, x0=1.0, coupling=abs_coupling(0.1))


def tiny_vg(n_steps=5):
    return VGModel(T=1.0, N=n_steps, r=0.1, theta=-0.1, kappa=0.1, sigJ=0.2,
                   K=1.0, x0=1.0, coupling=abs_coupling(0.1))


@pytest.mark.parametrize("scheme", PRICING_SCHEMES)
@pytest.mark.parametrize("model_fn", [tiny_merton, tiny_vg], ids=["merton", "vg"])
def test_loss_finite_and_grads_nonzero(scheme, model_fn, rng_key):
    solver = PricingSolver(model_fn(), scheme, hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    loss_fn = solver.build_loss(8)
    v, g = jax.value_and_grad(loss_fn)(params, rng_key)
    assert np.isfinite(float(v))
    gnorm = sum(float(jnp.sum(jnp.abs(x))) for x in jax.tree_util.tree_leaves(g))
    assert gnorm > 0.0


@pytest.mark.parametrize("kind", ["mc", "quadrature"])
def test_compensator_modes_agree_in_expectation(kind, rng_key):
    """On a fixed net, the MC compensator converges to the quadrature value."""
    model = tiny_merton()
    sq = PricingSolver(model, "global", hidden=(8, 8),
                       compensator=CompensatorSpec(kind="quadrature",
                                                   n_poisson_max=8, n_hermite=16))
    smc = PricingSolver(model, "global", hidden=(8, 8),
                        compensator=CompensatorSpec(kind="mc", n_mc=100_000))
    params = sq.init_params(rng_key)
    x = model.init_x(16) * jnp.linspace(0.8, 1.2, 16)
    j = model.sample_jumps(rng_key, (16,))
    _, comp_q = sq._gamma_and_compensator(params, 2, x, j, rng_key)
    _, comp_mc = smc._gamma_and_compensator(params, 2, x, j, rng_key)
    np.testing.assert_allclose(np.asarray(comp_q), np.asarray(comp_mc),
                               atol=3e-3)


@pytest.mark.parametrize("scheme", ["global", "multistep1", "sumlocal_reg"])
def test_training_reduces_loss(scheme, rng_key):
    solver = PricingSolver(tiny_merton(), scheme, hidden=(8, 8),
                           compensator=SMALL_QUAD)
    k_init, k_fit = jax.random.split(rng_key)
    params = solver.init_params(k_init)
    res = fit(
        loss_fn=solver.build_loss(64), params=params, key=k_fit, lrate=3e-3,
        num_epoch=30, num_epoch_ext=2, val_loss_fn=solver.build_loss(256),
        y0_fn=solver.y0_estimate, verbose=False,
    )
    first = jax.jit(solver.build_loss(256))(params, jax.random.key(7))
    assert res.loss_history[-1] < float(first)


def test_global_simulate_paths_shapes(rng_key):
    model = tiny_merton()
    solver = PricingSolver(model, "global", hidden=(8, 8), compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    xs, ys = solver.simulate_paths(params, rng_key, 32)
    assert xs.shape == (model.N + 1, 32)
    assert ys.shape == (model.N + 1, 32)
    assert np.all(np.isfinite(np.asarray(xs)))


def test_deterministic_given_key(rng_key):
    solver = PricingSolver(tiny_merton(), "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    loss_fn = jax.jit(solver.build_loss(32))
    a = float(loss_fn(params, jax.random.key(3)))
    b = float(loss_fn(params, jax.random.key(3)))
    c = float(loss_fn(params, jax.random.key(4)))
    assert a == b
    assert a != c


def test_net_wiring_matches_reference():
    """Head wiring parity with mainMerton.py:94-102 / mainVG.py:91-95."""
    m, v = tiny_merton(), tiny_vg()
    s = PricingSolver(m, "global", compensator=SMALL_QUAD).net_specs()
    assert s["uz"].with_y0 and s["uz"].n_out == 1 and s["gam"].n_in == 3
    s = PricingSolver(m, "multistep1", compensator=SMALL_QUAD).net_specs()
    assert set(s) == {"uz"} and s["uz"].n_out == 2
    s = PricingSolver(v, "global", compensator=SMALL_QUAD).net_specs()
    assert set(s) == {"gam"} and s["gam"].with_y0  # pure-jump global: Γ-net only
    s = PricingSolver(v, "sumlocal_reg", compensator=SMALL_QUAD).net_specs()
    assert set(s) == {"uz"} and s["uz"].n_out == 1


@pytest.mark.full
def test_chunked_mc_sweep_matches_unchunked(rng_key):
    """Node-axis chunking of the MC compensator sweep (node_block) must
    reproduce the unchunked loss and gradients exactly (reference-exact
    [n_mc, B] semantics at the headline batch)."""
    model = tiny_merton()
    base = PricingSolver(model, "global", hidden=(8, 8),
                         compensator=CompensatorSpec(kind="mc", n_mc=48,
                                                     node_block=0))
    # block 7 does not divide 48 -> exercises the zero-weight pad
    chunked = PricingSolver(model, "global", hidden=(8, 8),
                            compensator=CompensatorSpec(kind="mc", n_mc=48,
                                                        node_block=7))
    params = base.init_params(rng_key)
    la = jax.jit(base.build_loss(16))
    lb = jax.jit(chunked.build_loss(16))
    va, ga = jax.value_and_grad(la)(params, rng_key)
    vb, gb = jax.value_and_grad(lb)(params, rng_key)
    assert float(va) == pytest.approx(float(vb), rel=1e-6)
    # f32 reduction-order noise: the chunked sum-of-partial-weighted-sums
    # reassociates the node reduction, which shows up as ~1e-5 absolute noise
    # on near-cancelling gradient components.
    for a, b in zip(jax.tree_util.tree_leaves(ga),
                    jax.tree_util.tree_leaves(gb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=2e-5)


def test_chunked_quadrature_sweep_matches_unchunked(rng_key):
    model = tiny_merton()
    spec0 = CompensatorSpec(kind="quadrature", n_poisson_max=3, n_hermite=4,
                            node_block=0)
    spec1 = CompensatorSpec(kind="quadrature", n_poisson_max=3, n_hermite=4,
                            node_block=5)
    base = PricingSolver(model, "multistep2", hidden=(8, 8), compensator=spec0)
    chunked = PricingSolver(model, "multistep2", hidden=(8, 8),
                            compensator=spec1)
    params = base.init_params(rng_key)
    va = float(jax.jit(base.build_loss(16))(params, rng_key))
    vb = float(jax.jit(chunked.build_loss(16))(params, rng_key))
    assert va == pytest.approx(vb, rel=1e-6)


def test_warm_start_y0(rng_key):
    """warm_start_y0 puts the trainable scalar near the uncoupled price (the
    reference's std-1 normal init lands far away ~1/3 of the time)."""
    model = tiny_merton(n_steps=8)
    solver = PricingSolver(model, "global", hidden=(8, 8),
                           compensator=SMALL_QUAD)
    params = solver.init_params(rng_key)
    warmed = solver.warm_start_y0(params, rng_key, batch=8192)
    y0 = float(warmed["uz"]["y0"])
    # coarse sanity: a positive call price in a plausible band, and only y0
    # changed
    assert 0.0 < y0 < 1.0
    for name in ("W", "b"):
        for a, b in zip(params["uz"][name], warmed["uz"][name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        s2 = PricingSolver(model, "multistep1", hidden=(8, 8),
                           compensator=SMALL_QUAD)
        s2.warm_start_y0(s2.init_params(rng_key), rng_key)
