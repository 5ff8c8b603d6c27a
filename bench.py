#!/usr/bin/env python
"""Headline benchmark: Merton global deep-BSDE training throughput.

Metric (BASELINE.json): paths*steps/sec/chip on Merton N=50, 2^17-path batch —
one full training step = simulate 50 coupled Euler steps (3 MLP heads + the
compensator sweep + the 30-term closed-form pricer in the drift, per step),
backprop through the whole rollout, Adam update.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
``vs_baseline`` is the throughput ratio against the single-host CPU anchor
recorded in bench_baseline.json (the TF-2.10 reference is CPU-only with no
published numbers; the anchor is this same workload on CPU).

Usage: python bench.py [--batch 131072] [--inner 10] [--rounds 3]
                       [--compensator quadrature|mc] [--anchor]  # measure CPU anchor
"""

import argparse
import json
import os
import sys
import time


# Published dense peak rates per JAX ``device_kind``: FLOP/s by operand type
# and device-memory bytes/s (NVIDIA H100 SXM5 data sheet, at its 700 W
# limit).  A device that is not listed is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       "add them to bench.PEAKS with their source")
    return PEAKS[device_kind]


def build(batch: int, compensator: str, parity: bool, model_name: str = "merton",
          adjoint: bool = False, scheme: str = "global"):
    import jax

    from deepfbsdejsolvers_tpu.models.merton import make_merton_default
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import make_adam

    if model_name == "vg":
        import dataclasses

        from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

        model = make_vg_default()
        if parity:
            solver = PricingSolver(
                model, scheme, compensator=CompensatorSpec(kind=compensator))
        else:
            # VG speed config: collocate the compensator AND the FFT-table
            # price interpolation instead of per-path table lookups.
            # Converges to ~1.3e-3 of the FFT price at the standard gate
            # budget — within the run-to-run training noise of the
            # fully-direct config.
            # jump_sampler="icdf": the fixed-shape subordinator quantile is
            # a host-precomputed piecewise table indexed by a normal draw
            # instead of jax.random.gamma's rejection while-loop (law-exact
            # to the table fit, ~1.6e-5 sup in f32 — models/variance_gamma.py).
            # scan_chunk=2: outer scan over chunks of 2 unrolled steps
            # (scripts/scan_chunk_ab.py --model vg re-tunes it).
            model = dataclasses.replace(model, price_eval="chebyshev",
                                        jump_sampler="icdf")
            solver = PricingSolver(
                model, scheme,
                compensator=CompensatorSpec(kind=compensator,
                                            x_interp="chebyshev", n_cheb=64),
                hoist=True, hoist_interp="piecewise", scan_chunk=2)
    elif model_name == "mfg":
        import dataclasses

        from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
        from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

        mfg_model = make_mfg_default()
        if not parity:
            # per-path Cox rates make jax.random.poisson a per-path
            # rejection loop; the icdf sampler is one fixed-shape table
            # lookup per draw
            mfg_model = dataclasses.replace(mfg_model, jump_sampler="icdf")
        # scan_chunk=16: outer scan over chunks of 16 unrolled steps of the
        # N=96 MFG scan (scripts/scan_chunk_ab.py --model mfg re-tunes it).
        mfg = MFGSolver(mfg_model, "global",
                        scan_chunk=0 if parity else 16)
        params = mfg.init_params(jax.random.key(0))
        optimizer = make_adam(1e-3)
        losses = mfg.build_losses(batch)
        return (mfg_model, mfg, params, optimizer, optimizer.init(params),
                losses["coupled"])
    elif parity:
        # reference-faithful numerics: exact Poisson sampler, f32 heads (at
        # the default matmul precision, nets/mlp.py), direct XLA sweep over
        # the default 49-node rule (or 5000-sample MC).
        model = make_merton_default()
        solver = PricingSolver(
            model, scheme, compensator=CompensatorSpec(kind=compensator))
    else:
        # speed config (accuracy-gated in tests/test_chebyshev.py /
        # test_fast_paths.py and the merton_speed gate of
        # scripts/convergence_gates.py):
        # Chebyshev-collocated compensator AND pricer (both are 1-D smooth
        # functions of the spot — evaluate exactly at 64 Chebyshev points,
        # Clenshaw per path) plus inverse-CDF Poisson sampling (law equal to
        # 1e-9).  Full f32: |Y0 - oracle| = 1.2e-4 on the multistep gate.
        # bfloat16 heads are deliberately NOT used — they bias the Y0
        # readout ~3e-3 (out of gate) and no longer buy throughput once the
        # sweep is collocated.
        # The collocation is HOISTED out of the time scan (per-step
        # coefficient tables from the pre-drawn noise's uncoupled marginals)
        # and evaluated as PIECEWISE degree-7 polynomials (exact per-path
        # piece select + short Clenshaw) instead of global degree-63
        # Clenshaw chains (ops/piecewise.py).
        # scan_chunk=2: outer scan over 25 chunks of 2 unrolled steps
        # (scripts/scan_chunk_ab.py re-tunes it).  Exact math: grads == flat
        # scan at fixed params (tests).
        model = make_merton_default(jump_sampler="icdf",
                                    price_mode="chebyshev")
        solver = PricingSolver(
            model, scheme,
            compensator=CompensatorSpec(kind=compensator,
                                        x_interp="chebyshev", n_cheb=64),
            hoist=True, hoist_interp="piecewise", scan_chunk=2,
            adjoint=adjoint)
    params = solver.init_params(jax.random.key(0))
    optimizer = make_adam(4e-4)
    opt_state = optimizer.init(params)
    loss_fn = solver.build_loss(batch)
    return model, solver, params, optimizer, opt_state, loss_fn


def measure(batch: int, inner: int, rounds: int, compensator: str,
            parity: bool = False, model_name: str = "merton",
            rng: str = "threefry", adjoint: bool = False,
            scheme: str = "global") -> dict:
    import jax

    from deepfbsdejsolvers_tpu.solvers.train import make_epoch_fn

    model, solver, params, optimizer, opt_state, loss_fn = build(
        batch, compensator, parity, model_name, adjoint, scheme)
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    # "rbg": JAX's alternative PRNG implementation (less per-draw arithmetic
    # than threefry); opt-in because its fold_in/split have weaker
    # statistical guarantees.
    key = (jax.random.key(1, impl="rbg") if rng == "rbg"
           else jax.random.key(1))
    t0 = time.perf_counter()
    epoch = epoch.lower(params, opt_state, key).compile()
    compile_s = time.perf_counter() - t0
    # 2 warmup epochs (the first post-compile epoch can run slow once —
    # autotune/upload effects — and must not pollute the measure)
    for w in range(2):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    per_round = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        per_round.append(time.perf_counter() - t0)
    med = sorted(per_round)[len(per_round) // 2]
    paths_steps = batch * model.N * inner
    stats = jax.devices()[0].memory_stats()
    return {
        "paths_steps_per_sec": paths_steps / med,
        "train_steps_per_sec": inner / med,
        "round_seconds": per_round,
        "compile_seconds": compile_s,
        "peak_bytes": (stats or {}).get("peak_bytes_in_use"),
        "final_loss": float(loss),
        "device": str(jax.devices()[0]),
    }


ANCHOR_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_baseline.json")


def main():
    from deepfbsdejsolvers_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--compensator", choices=["quadrature", "mc"],
                   default="quadrature")
    p.add_argument("--model", choices=["merton", "vg", "mfg"],
                   default="merton",
                   help="secondary workloads: VG pure-jump pricing (N=30) or "
                        "the coupled MFG smart-grid system (N=96)")
    p.add_argument("--scheme", default="global",
                   choices=["global", "multistep1", "multistep2", "sumlocal1",
                            "sumlocal2", "sumlocal_reg", "multistep_reg"],
                   help="pricing training scheme (SolversJumpDiff.py:75-513 "
                        "variants); the headline metric is the global scheme, "
                        "the others record the reference's full method sweep "
                        "(mainMerton.py:79-118) — see scripts/"
                        "scheme_throughput.py for the recorded table")
    p.add_argument("--parity", action="store_true",
                   help="reference-faithful numerics (f32, exact sampler, "
                        "49-node/MC sweep) instead of the speed config")
    p.add_argument("--rng", choices=["threefry", "rbg"], default="threefry",
                   help="PRNG implementation (rbg: JAX's alternative "
                        "generator, opt-in)")
    p.add_argument("--adjoint", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="hand-written transposed-adjoint VJP for the merton "
                        "speed config (solvers/adjoint.py): the batched "
                        "backward recomputation materializes (N*B) "
                        "intermediates.  An opt-in instrument")
    p.add_argument("--anchor", action="store_true",
                   help="measure the CPU anchor and write bench_baseline.json")
    args = p.parse_args()

    if args.adjoint and (args.parity or args.model != "merton"):
        p.error("--adjoint applies only to the merton speed config "
                "(no --parity, --model merton)")
    if args.scheme != "global" and args.model == "mfg":
        p.error("--scheme applies to the pricing models (merton/vg); the "
                "MFG workload benches its global scheme")

    if args.anchor:
        import jax

        jax.config.update("jax_platforms", "cpu")
        res = measure(args.batch, args.inner, args.rounds, args.compensator,
                      args.parity)
        payload = {
            "anchor_paths_steps_per_sec": res["paths_steps_per_sec"],
            "batch": args.batch,
            "compensator": args.compensator,
            "parity": args.parity,
            "device": res["device"],
        }
        with open(ANCHOR_FILE, "w") as f:
            json.dump(payload, f, indent=1)
        print(json.dumps(payload), file=sys.stderr)
        return

    res = measure(args.batch, args.inner, args.rounds, args.compensator,
                  args.parity, args.model, args.rng, args.adjoint, args.scheme)
    vs = None
    if (args.model == "merton" and args.scheme == "global"
            and os.path.exists(ANCHOR_FILE)):
        with open(ANCHOR_FILE) as f:
            anchor = json.load(f)
        vs = res["paths_steps_per_sec"] / anchor["anchor_paths_steps_per_sec"]
    n_steps = {"merton": 50, "vg": 30, "mfg": 96}[args.model]
    scheme_tag = "global" if args.model == "mfg" else args.scheme
    print(json.dumps({
        "metric": f"{args.model}_{scheme_tag}_train_throughput",
        "value": res["paths_steps_per_sec"],
        "unit": f"paths*steps/sec/chip ({args.model} N={n_steps}, "
                f"batch 2^{args.batch.bit_length() - 1})",
        "vs_baseline": vs,
    }))
    print(f"# detail: {res}", file=sys.stderr)


if __name__ == "__main__":
    main()
