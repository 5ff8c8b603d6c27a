"""The XLA compensator sweep against an independent float64 NumPy evaluation
of the same MLP — values AND parameter gradients — for every scheme/regime
input convention, the quadrature rule and the per-step MC node draw (plain
and node-chunked), at an odd batch; plus the comp-axis-sharded sweep against
the unsharded one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from deepfbsdejsolvers_tpu.models.merton import make_merton_default
from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver

BATCH = 97       # odd: no tiling assumption anywhere in the sweep
STEP = 5
SPECS = {
    # Merton: 1 + 6 * 8 = 49 nodes; VG: 12 * 8 = 96 nodes
    "quadrature": CompensatorSpec(),
    "mc": CompensatorSpec(kind="mc", n_mc=40),
    "mc_chunked": CompensatorSpec(kind="mc", n_mc=40, node_block=16),
}
CASES = [
    (make_merton_default, "global"),      # jump-diff, Γ-net, f = J
    (make_merton_default, "multistep2"),  # jump-diff, Γ-net, f = e^J
    (make_merton_default, "multistep1"),  # jump-diff, U-net, X·e^J
    (make_vg_default, "global"),          # pure-jump, Γ-net, f = X·J
    (make_vg_default, "sumlocal1"),       # pure-jump, U-net, X + X·J
]


def _mlp64(p, inp):
    """float64 forward of a tanh MLP; returns (output, per-layer inputs and
    activations) for the hand-written backward."""
    acts = [inp]
    h = inp
    n = len(p["W"])
    for i in range(n):
        h = h @ p["W"][i] + p["b"][i]
        if i < n - 1:
            h = np.tanh(h)
        acts.append(h)
    return h, acts


def _mlp64_vjp(p, acts, dout):
    """Parameter cotangents of _mlp64 for output cotangent ``dout``."""
    n = len(p["W"])
    dW, db = [None] * n, [None] * n
    g = dout
    for i in range(n - 1, -1, -1):
        x_in = acts[i].reshape(-1, acts[i].shape[-1])
        gf = g.reshape(-1, g.shape[-1])
        dW[i] = x_in.T @ gf
        db[i] = gf.sum(0)
        if i > 0:
            g = (g @ p["W"][i].T) * (1.0 - acts[i] ** 2)
    return dW, db


def _reference(solver, params, x, j, km):
    """(comp, grads of sum(sin(comp))) in float64 NumPy."""
    use_gam = "gam" in params and solver.scheme not in ("multistep1",
                                                        "sumlocal1")
    if solver.compensator.kind == "mc":
        nodes = solver.model.sample_jumps(km, (solver.compensator.n_mc,))
        w = np.full(nodes.shape, 1.0 / nodes.shape[0])
    else:
        nodes, w = solver._quad
        w = np.asarray(w, np.float64)
    # the head inputs (time feature, spot, jump feature) exactly as the
    # solver builds them; the network itself is evaluated in float64
    if use_gam:
        inp = solver._gamma_inputs(STEP, x[None, :], nodes[:, None])
    else:
        inp = solver._unet_jump_inputs(STEP, x[None, :], nodes[:, None])
    head = "gam" if use_gam else "uz"
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 params[head])
    out, acts = _mlp64(p64, np.asarray(inp, np.float64))
    comp = np.einsum("m,mb->b", w, out[..., 0])
    dout = np.zeros_like(out)
    dout[..., 0] = w[:, None] * np.cos(comp)[None, :]
    dW, db = _mlp64_vjp(p64, acts, dout)
    return comp, head, dW, db


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("model_fn,scheme", CASES)
def test_xla_sweep_matches_float64(model_fn, scheme, kind, rng_key):
    model = model_fn()
    solver = PricingSolver(model, scheme, compensator=SPECS[kind])
    params = solver.init_params(jax.random.key(0))
    x = jax.random.normal(rng_key, (BATCH,)) * 0.1 + 1.0
    j = model.sample_jumps(jax.random.fold_in(rng_key, 1), (BATCH,))
    km = jax.random.fold_in(rng_key, 2)

    def f(p):
        _, comp = solver._gamma_and_compensator(p, STEP, x, j, km)
        return jnp.sum(jnp.sin(comp)), comp

    (_, comp), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    want, head, dW, db = _reference(solver, params, x, j, km)
    np.testing.assert_allclose(np.asarray(comp, np.float64), want,
                               rtol=2e-5, atol=2e-6)
    got = np.concatenate([np.ravel(g) for g in grads[head]["W"]
                          + grads[head]["b"]])
    ref = np.concatenate([np.ravel(g) for g in dW + db])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


@pytest.mark.parametrize("model_fn", [make_merton_default, make_vg_default])
def test_sharded_comp_sweep_matches_unsharded(model_fn):
    """Quadrature nodes sharded over a 2-device ``comp`` axis (zero-weight
    padded to a multiple of 2), partial sums psum'd: same loss and
    gradients as the unsharded sweep."""
    from jax import shard_map

    model = dataclasses.replace(model_fn(), N=6)
    spec = CompensatorSpec(n_poisson_max=3, n_hermite=5, n_laguerre=5)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("comp",))
    key = jax.random.key(7)
    base = PricingSolver(model, "global", compensator=spec)
    sharded = PricingSolver(model, "global", compensator=spec,
                            comp_axis="comp", comp_shards=2)
    params = base.init_params(jax.random.key(0))
    loss_sh = shard_map(sharded.build_loss(63), mesh=mesh,
                        in_specs=(P(), P()), out_specs=P(), check_vma=False)
    l0, g0 = jax.jit(jax.value_and_grad(base.build_loss(63)))(params, key)
    l1, g1 = jax.jit(jax.value_and_grad(loss_sh))(params, key)
    assert float(l1) == pytest.approx(float(l0), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-6)
