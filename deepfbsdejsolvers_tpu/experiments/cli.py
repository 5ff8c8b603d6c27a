"""One CLI for every experiment: ``python -m deepfbsdejsolvers_tpu <cmd>``.

Replaces the reference's four per-script argparse blocks (mainMerton.py:12-23,
mainVG.py:12-22, mainMFGComparison.py:13-31, mainMFGPoA.py:18-36) with
subcommands whose flags keep the reference names (``--nbNeuron``,
``--nEpochExt``, ...) so reference users can port command lines verbatim.

Subcommands
-----------
merton        7-method pricing sweep on the Merton model (mainMerton)
vg            7-method pricing sweep on the Variance-Gamma model (mainVG)
mfg-compare   5-method MFG comparison (mainMFGComparison)
mfg-poa       Price-of-Anarchy case sweep (mainMFGPoA)
bench         the headline throughput benchmark (bench.py)
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from deepfbsdejsolvers_tpu.experiments.configs import (
    MFG_METHODS,
    MFGComparisonConfig,
    MFGPoAConfig,
    MertonConfig,
    PRICING_METHODS,
    RunIO,
    VGConfig,
)


def _add_io_flags(p: argparse.ArgumentParser):
    p.add_argument("--outdir", type=str, default=None,
                   help="artifact directory (metrics.jsonl, plots, ckpts)")
    p.add_argument("--savePlots", action="store_true")
    p.add_argument("--checkpointEvery", type=int, default=0,
                   help="outer epochs between checkpoints (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in outdir")
    p.add_argument("--profileDir", type=str, default=None,
                   help="capture a jax.profiler trace here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debugNans", action="store_true",
                   help="enable the jax_debug_nans guard: raise at the exact "
                        "primitive that produces a NaN (slows training; "
                        "utils/debug.py)")


def _io_from_args(args) -> RunIO:
    return RunIO(outdir=args.outdir, save_plots=args.savePlots,
                 checkpoint_every=args.checkpointEvery, resume=args.resume,
                 profile_dir=args.profileDir)


def _add_pricing_flags(p: argparse.ArgumentParser, lr_y0, lr_loc, lr_reg,
                       methods):
    p.add_argument("--nbNeuron", type=int, default=21)
    p.add_argument("--nbLayer", type=int, default=2)
    p.add_argument("--nEpochExt", type=int, default=120)
    p.add_argument("--nEpoch", type=int, default=100)
    p.add_argument("--batchSize", type=int, default=10)
    p.add_argument("--lRateY0", type=float, default=lr_y0)
    p.add_argument("--lRateLoc", type=float, default=lr_loc)
    p.add_argument("--lRateReg", type=float, default=lr_reg)
    p.add_argument("--activation", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--aLin", type=float, default=0.1)
    p.add_argument("--methods", type=str, nargs="*", default=list(methods),
                   choices=list(methods))
    p.add_argument("--compensator", type=str, default="quadrature",
                   choices=["quadrature", "mc"],
                   help="inner jump-expectation mode (reference = mc 5000)")
    p.add_argument("--nMC", type=int, default=5000)
    p.add_argument("--dataParallel", action="store_true",
                   help="shard the path batch over all visible devices "
                        "(1-D data mesh, gradient all-reduce across it); "
                        "batchSize stays the global batch")
    p.add_argument("--y0TailAvg", type=int, default=1,
                   help="report Y0 as the mean over the last k outer epochs "
                        "(1 = reference behavior)")
    p.add_argument("--y0WarmStart", action="store_true",
                   help="init the Global scheme's trainable Y0 at an "
                        "oracle-free MC payoff estimate (robustness: avoids "
                        "the spurious basin ~1/3 of std-normal inits hit)")
    p.add_argument("--fast", action="store_true",
                   help="speed preset (accuracy-gated, full f32): "
                        "hoisted piecewise collocation of the compensator "
                        "(64 points, full node rule) and of the closed-form "
                        "pricer, inverse-CDF Poisson sampling, chunked scan "
                        "(the bench.py speed config; tests/test_fast_paths.py)")


def _pricing_common(args) -> dict:
    fast = {}
    if args.fast:
        # the accuracy-gated speed preset: collocated compensator (full node
        # rule) + icdf Poisson sampling, full f32
        fast = dict(x_interp="chebyshev", n_cheb=64, jump_sampler="icdf",
                    price_mode="chebyshev", hoist=True,
                    hoist_interp="piecewise", scan_chunk=2)
    return dict(
        nb_neuron=args.nbNeuron, nb_layer=args.nbLayer,
        n_epoch_ext=args.nEpochExt, n_epoch=args.nEpoch,
        batch_size=args.batchSize, lrate_y0=args.lRateY0,
        lrate_loc=args.lRateLoc, lrate_reg=args.lRateReg,
        activation=args.activation, a_lin=args.aLin, methods=args.methods,
        compensator=args.compensator, n_mc=args.nMC, seed=args.seed,
        data_parallel=args.dataParallel, y0_tail_avg=args.y0TailAvg,
        y0_warm_start=args.y0WarmStart, io=_io_from_args(args), **fast,
    )


def _add_mfg_flags(p: argparse.ArgumentParser, defaults: MFGPoAConfig | MFGComparisonConfig):
    p.add_argument("--nbNeuron_hat", type=int, default=defaults.nb_neuron_hat)
    p.add_argument("--nbNeuron", type=int, default=defaults.nb_neuron)
    p.add_argument("--nbLayer_hat", type=int, default=defaults.nb_layer_hat)
    p.add_argument("--nbLayer", type=int, default=defaults.nb_layer)
    p.add_argument("--nEpochExt", type=int, default=defaults.n_epoch_ext)
    p.add_argument("--nEpoch", type=int, default=defaults.n_epoch)
    p.add_argument("--batchSize", type=int, default=defaults.batch_size)
    p.add_argument("--rafCoef", type=int, default=defaults.raf_coef)
    p.add_argument("--jumpFac", type=float, default=defaults.jump_factor)
    p.add_argument("--nbDays", type=int, default=defaults.nb_days)
    p.add_argument("--lRateY0", type=float, default=defaults.lrate_y0)
    p.add_argument("--lRateLoc", type=float, default=defaults.lrate_loc)
    p.add_argument("--lRateReg", type=float, default=defaults.lrate_reg)
    p.add_argument("--couplage", type=str, default="ON", choices=["ON", "OFF"])
    p.add_argument("--jumpModel", type=str, default="stochastic",
                   choices=["stochastic", "constant"])
    p.add_argument("--activation_hat", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--activation", type=str, default="tanh",
                   choices=["tanh", "relu", "sigmoid"])
    p.add_argument("--dataParallel", action="store_true",
                   help="shard the path batch over all visible chips")
    p.add_argument("--y0WarmStart", action="store_true",
                   help="initialize the Global scheme's trainable (Y0_hat, "
                        "Y0) at Picard-iterated MC estimates of the BSDE "
                        "initial values instead of the reference's std-1 "
                        "normal draws (which cannot reach the ~-46 consensus "
                        "within the reference budget's Adam travel bound)")
    p.add_argument("--fast", action="store_true",
                   help="speed config: icdf Cox jump sampler + "
                        "scan_chunk=16 (the bench.py --model mfg config). "
                        "Same laws/math; tested vs the exact sampler and "
                        "the flat scan in tests/.")


def _mfg_common(args) -> dict:
    fast = {}
    if args.fast:
        fast = dict(jump_sampler="icdf", scan_chunk=16)
    return dict(
        nb_neuron_hat=args.nbNeuron_hat, nb_neuron=args.nbNeuron,
        nb_layer_hat=args.nbLayer_hat, nb_layer=args.nbLayer,
        n_epoch_ext=args.nEpochExt, n_epoch=args.nEpoch,
        batch_size=args.batchSize, raf_coef=args.rafCoef,
        jump_factor=args.jumpFac, nb_days=args.nbDays,
        lrate_y0=args.lRateY0, lrate_loc=args.lRateLoc,
        lrate_reg=args.lRateReg, couplage=args.couplage,
        jump_model=args.jumpModel, activation_hat=args.activation_hat,
        activation=args.activation, data_parallel=args.dataParallel,
        y0_warm_start=args.y0WarmStart,
        seed=args.seed, io=_io_from_args(args), **fast,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepfbsdejsolvers_tpu",
        description="deep FBSDE solvers with jumps (JAX)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merton", help="Merton pricing sweep (mainMerton)")
    _add_pricing_flags(p, 4e-4, 3e-4, 3e-4, PRICING_METHODS)
    p.add_argument("--limit", type=int, default=30)
    _add_io_flags(p)

    p = sub.add_parser("vg", help="Variance-Gamma pricing sweep (mainVG)")
    _add_pricing_flags(p, 5e-4, 3e-4, 1.5e-4, PRICING_METHODS)
    p.add_argument("--pricer", type=str, default="fft",
                   choices=["fft", "invfourier"])
    _add_io_flags(p)

    p = sub.add_parser("mfg-compare", help="MFG method comparison")
    _add_mfg_flags(p, MFGComparisonConfig())
    p.add_argument("--methods", type=str, nargs="*", default=list(MFG_METHODS),
                   choices=list(MFG_METHODS))
    p.add_argument("--nbSimulation", type=int, default=10**5)
    _add_io_flags(p)

    p = sub.add_parser("mfg-poa", help="Price-of-Anarchy sweep")
    _add_mfg_flags(p, MFGPoAConfig())
    p.add_argument("--method", type=str, default="Global", choices=list(MFG_METHODS))
    p.add_argument("--nFrozen", type=int, default=1000,
                   help="frozen-noise trajectories (reference nbSimul)")
    p.add_argument("--nReplay", type=int, default=5,
                   help="paths plotted per sweep point (reference NbSimulation)")
    p.add_argument("--piList", type=float, nargs="*", default=[0.0, 0.1, 0.5, 0.95])
    _add_io_flags(p)

    p = sub.add_parser("bench", help="headline throughput benchmark")
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--model", type=str, default="merton",
                   choices=["merton", "vg", "mfg"])
    p.add_argument("--parity", action="store_true",
                   help="reference-faithful numerics instead of the speed "
                        "config (see bench.py)")
    p.add_argument("--compensator", type=str, default="quadrature",
                   choices=["quadrature", "mc"])
    p.add_argument("--rng", type=str, default="threefry",
                   choices=["threefry", "rbg"])

    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    verbose = not getattr(args, "quiet", False)
    if args.cmd != "bench":       # bench.py sets up its own process
        from deepfbsdejsolvers_tpu.utils.compile_cache import (
            enable_compile_cache)

        enable_compile_cache()

    import contextlib

    from deepfbsdejsolvers_tpu.utils.debug import nan_guard

    guard = (nan_guard() if getattr(args, "debugNans", False)
             else contextlib.nullcontext())
    with guard:
        return _dispatch(args, verbose)


def _dispatch(args, verbose: bool) -> int:
    if args.cmd == "merton":
        from deepfbsdejsolvers_tpu.experiments.pricing import run_pricing

        cfg = MertonConfig(limit=args.limit, **_pricing_common(args))
        res = run_pricing(cfg, verbose=verbose)
        for m, r in res.methods.items():
            print(f"{m}: Y0={r.y0:.6f}  |err|={r.abs_error:.2e}  "
                  f"({r.duration:.1f}s)")
        print(f"closed-form price: {res.reference_price:.6f}")
    elif args.cmd == "vg":
        from deepfbsdejsolvers_tpu.experiments.pricing import run_pricing

        cfg = VGConfig(pricer=args.pricer, **_pricing_common(args))
        res = run_pricing(cfg, verbose=verbose)
        for m, r in res.methods.items():
            print(f"{m}: Y0={r.y0:.6f}  |err|={r.abs_error:.2e}  "
                  f"({r.duration:.1f}s)")
        print(f"FFT reference price: {res.reference_price:.6f}")
    elif args.cmd == "mfg-compare":
        from deepfbsdejsolvers_tpu.experiments.mfg_comparison import run_mfg_comparison

        cfg = MFGComparisonConfig(methods=args.methods,
                                  n_simulation=args.nbSimulation,
                                  **_mfg_common(args))
        res = run_mfg_comparison(cfg, verbose=verbose)
        for m, r in res.methods.items():
            cost = ("" if r.eval_cost is None
                    else f"  cost={r.eval_cost:.4f}±{r.eval_ci:.4f}")
            print(f"{m}: Y0_hat={r.y0_hat_history[-1]:.6f}  "
                  f"Y0={r.y0_history[-1]:.6f}{cost}")
    elif args.cmd == "mfg-poa":
        from deepfbsdejsolvers_tpu.experiments.mfg_poa import run_mfg_poa

        cfg = MFGPoAConfig(method=args.method, n_frozen=args.nFrozen,
                           n_replay=args.nReplay, pi_list=args.piList,
                           **_mfg_common(args))
        res = run_mfg_poa(cfg, verbose=verbose)
        print(res.to_text())
    elif args.cmd == "bench":
        import os
        import subprocess

        # bench.py lives at the repo root, one level above the package —
        # resolve it from the package location so the installed console
        # script works from any cwd (it is not packaged by pyproject).
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        bench = os.path.join(os.path.dirname(pkg_dir), "bench.py")
        if not os.path.exists(bench):
            print("bench.py not found next to the package — run from a "
                  "source checkout (the benchmark script is not installed)",
                  file=sys.stderr)
            return 2
        cmd = [sys.executable, bench, "--batch", str(args.batch),
               "--inner", str(args.inner), "--rounds", str(args.rounds),
               "--model", args.model, "--compensator", args.compensator,
               "--rng", args.rng]
        if args.parity:
            cmd.append("--parity")
        return subprocess.call(cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
