"""Hand-written transposed-adjoint VJP for the hoisted global rollout.

Why this exists (round-3 trace): after the collocation hoist, XLA's
autodiff of the time scan spent much of the train step on the realized-Γ
head's per-step dot_generals (jvp + transpose + remat re-forward run INSIDE
the sequential scan as thin matmuls) and on scan buffer traffic (saved-head
stacking + per-step xs slicing).

The structural fix: the adjoint recurrence of the rollout is LINEAR in the
adjoints, with coefficients that depend only on the forward trajectory:

  x̄_i = x̄_{i+1}·E_i + c̄·C'_i(x_i) + z̄·Z'_i(x_i) + ā·A'_i(x_i) + ḡ·∂xΓ_i
  ȳ_i = (ȳ_{i+1} + x̄_{i+1}·φ'(u_i)·dt)·(1 − dt·f'(y_i))

so every expensive coefficient (the Γ-head's value/∂x/parameter gradients,
the table derivatives) can be recomputed in ONE batched pass over all
(N·B) states — large, matmul-dense, outside any scan — leaving a reverse
`lax.scan` whose body is ~20 elementwise ops.  The forward saves exactly
two (N, B) trajectories (x_i, y_{i+1}) as residuals: no remat, no per-step
saved-head stacking.

Outcome (measured on the chip, round 3): SLOWER than XLA's autodiff of the
scan — 2.14e8 vs 4.22e8 paths·steps/s at the 2^17 headline batch.  The
compiled cost model explains it: the batched coefficient recomputation and
the three batched table/net VJPs materialize (N·B)-sized intermediates
(15.6 GB accessed and 41.6 GFLOP per epoch vs 1.08 GB / 6.3 GFLOP for the
in-scan streaming backward), while XLA's scan backward keeps the same math
fused at (B,)-row granularity.  Kept as a correctness-tested opt-in
(`PricingSolver(adjoint=True)`, `bench.py --adjoint`) and as the measured
record that the remaining 30% head-matmul cost is NOT removable by
batching the backward out of the scan — the next lever is fusing the scan
body itself (Pallas), not restructuring autodiff.

Scope: the global jump-diffusion scheme on the fully-hoisted speed path
(compensator/pricer/Z as per-step piecewise tables — `PricingSolver(
hoist=True, hoist_z=True)` with a collocated price).  The forward body
reproduces `PricingSolver._loss_global`'s float-for-float (same op order),
and gradients are tested to match XLA autodiff to fp tolerance
(tests/test_adjoint.py).

Reference semantics unchanged: this is a gradient-computation strategy for
the same loss (SolversJumpDiff.py:25-52's trainProcedure/optimizeBSDE pair).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from deepfbsdejsolvers_tpu.ops.numerics import expm1_acc, mul_exp
from deepfbsdejsolvers_tpu.ops.piecewise import pw_eval, pw_eval_with_deriv


def make_global_adjoint_rollout(model, apply_gam: Callable):
    """Build the custom-VJP rollout for one model.

    ``apply_gam(gam_params, i, x, j) -> Γ`` must broadcast: scalar or (N, 1)
    step index against (B,) or (N, B) states (PricingSolver._gamma_inputs
    does).  Returns ``rollout(gam_params, y0, tables, dw, j) -> (x_N, y_N)``
    with ``tables = {"cc", "pc", "zc", "lo", "hi"}`` per-step piecewise
    coefficient tables ((N, P, D)) and interval bounds ((N,)).
    """
    dt = model.dt

    def _fwd_scan(gam_params, y0, tables, dw, j):
        n, batch = dw.shape
        x0 = model.init_x(batch)
        y_init = y0 * jnp.ones((batch,), jnp.float32)
        xs_in = {"i": jnp.arange(n), "dw": dw, "j": j, **tables}

        def body(carry, row):
            x, y = carry
            comp = pw_eval(row["cc"], x, row["lo"], row["hi"])
            gam = apply_gam(gam_params, row["i"], x, row["j"])
            y = y - dt * model.f(y) + gam - comp
            z = pw_eval(row["zc"], x, row["lo"], row["hi"])
            y = y + z * row["dw"]
            a = pw_eval(row["pc"], x, row["lo"], row["hi"])
            # mul_exp matches the production model.step arithmetic
            # (ops/numerics.py: f32 exp walk bias)
            x_new = (mul_exp(x, model.uncoupled_log_increments(row["dw"],
                                                               row["j"]))
                     + model.coupling(y - a) * dt)
            return (x_new, y), (x, y)

        (x_n, y_n), (xs, ys) = jax.lax.scan(body, (x0, y_init), xs_in)
        return (x_n, y_n), (xs, ys)

    @jax.custom_vjp
    def rollout(gam_params, y0, tables, dw, j):
        return _fwd_scan(gam_params, y0, tables, dw, j)[0]

    def fwd(gam_params, y0, tables, dw, j):
        out, (xs, ys) = _fwd_scan(gam_params, y0, tables, dw, j)
        return out, (gam_params, y0, tables, dw, j, xs, ys)

    def bwd(res, cot):
        gam_params, y0, tables, dw, j, xs, ys = res
        xbar_n, ybar_n = cot
        n, batch = dw.shape
        steps = jnp.arange(n)[:, None]

        # ---- batched coefficient recomputation: one (N*B) pass, no scan
        e_fac = 1.0 + expm1_acc(
            model.uncoupled_log_increments(dw, j))                  # (N, B)
        ev = jax.vmap(pw_eval_with_deriv)
        _, cps = ev(tables["cc"], xs, tables["lo"], tables["hi"])
        a_vals, aps = ev(tables["pc"], xs, tables["lo"], tables["hi"])
        _, zps = ev(tables["zc"], xs, tables["lo"], tables["hi"])
        u = ys - a_vals                                             # u_i = y_{i+1} - A_i(x_i)
        ones = jnp.ones_like(u)
        (phip,) = jax.vjp(model.coupling, u)[1](ones)               # φ'(u)
        y_prev = jnp.concatenate(
            [y0 * jnp.ones((1, batch), jnp.float32), ys[:-1]], axis=0)
        fp = jax.jvp(model.f, (y_prev,), (ones,))[1]                # f'(y_i)
        gam_of_x = lambda xx: apply_gam(gam_params, steps, xx, j)
        gx = jax.jvp(gam_of_x, (xs,), (ones,))[1]                   # ∂x Γ

        # ---- the elementwise adjoint recurrence (reverse scan)
        rows = {"E": e_fac, "cps": cps, "aps": aps, "zps": zps,
                "phip": phip, "gx": gx, "dw": dw, "fp": fp}

        def abody(carry, row):
            xb, yb = carry
            ub = xb * row["phip"] * dt          # cotangent of u_i
            yb = yb + ub                        # total ȳ_{i+1}
            xb = xb * row["E"]
            gbar = yb                           # = c̄omp sign-flipped, z̄/dw
            xb = (xb - gbar * row["cps"] + gbar * row["dw"] * row["zps"]
                  - ub * row["aps"] + gbar * row["gx"])
            yb = yb * (1.0 - dt * row["fp"])    # ȳ_i
            return (xb, yb), (gbar, ub)

        (_, yb0), (gbars, ubars) = jax.lax.scan(
            abody, (xbar_n, ybar_n), rows, reverse=True)

        # ---- parameter/table cotangents: batched VJPs over all (N, B)
        (gam_grads,) = jax.vjp(
            lambda p: apply_gam(p, steps, xs, j), gam_params)[1](gbars)
        table_eval = lambda c, lo, hi: jax.vmap(pw_eval)(c, xs, lo, hi)
        ccbar = jax.vjp(table_eval, tables["cc"], tables["lo"],
                        tables["hi"])[1](-gbars)[0]
        zcbar = jax.vjp(table_eval, tables["zc"], tables["lo"],
                        tables["hi"])[1](gbars * dw)[0]
        pcbar = jax.vjp(table_eval, tables["pc"], tables["lo"],
                        tables["hi"])[1](-ubars)[0]
        tbar = {"cc": ccbar, "pc": pcbar, "zc": zcbar,
                "lo": jnp.zeros_like(tables["lo"]),
                "hi": jnp.zeros_like(tables["hi"])}
        y0bar = jnp.sum(yb0)
        return (gam_grads, y0bar, tbar,
                jnp.zeros_like(dw), jnp.zeros_like(j))

    rollout.defvjp(fwd, bwd)
    return rollout
