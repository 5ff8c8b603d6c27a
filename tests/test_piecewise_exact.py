"""The piecewise tables' per-path coefficient select is exact: pw_eval /
pw2_eval against a float64 NumPy evaluation of the same coefficients, and
no matmul below HIGHEST precision anywhere in their forward or backward
(a DEFAULT-precision select may run in TF32 on a GPU)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jex_core

from deepfbsdejsolvers_tpu.ops.piecewise import (
    pw2_eval, pw_eval, pw_eval_with_deriv)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pw_eval", "pw2_eval"])
def test_piecewise_eval_matches_float64(name):
    cs = _chip_smoke()
    errs = cs.piece_select_errors(4099, jax.random.key(3))
    assert errs[name] <= cs.SELECT_EPS, errs


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a closed jaxpr, sub-jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _evals():
    p = jnp.ones((8, 8))
    p2 = jnp.ones((32, 40))
    x = jnp.linspace(-0.1, 1.1, 33)
    return {
        "pw_eval": (lambda c: jnp.sum(pw_eval(c, x, 0.0, 1.0)), p),
        "pw_eval_with_deriv": (
            lambda c: jnp.sum(sum(pw_eval_with_deriv(c, x, 0.0, 1.0))), p),
        "pw2_eval": (lambda c: jnp.sum(pw2_eval(
            c, x, x, 0.0, 1.0, 0.0, 1.0, 8, 7, 4, 4)), p2),
    }


@pytest.mark.parametrize("pass_", ["forward", "gradient"])
@pytest.mark.parametrize("name", ["pw_eval", "pw_eval_with_deriv", "pw2_eval"])
def test_select_has_no_reduced_precision_matmul(name, pass_):
    fn, coef = _evals()[name]
    if pass_ == "gradient":
        fn = jax.grad(fn)
    precs = _dot_precisions(jax.make_jaxpr(fn)(coef).jaxpr)
    highest = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == highest for q in p)
               for p in precs), precs
