"""Typed experiment configs with reference-default presets.

Defaults reproduce the reference argparse defaults exactly:
* Merton — mainMerton.py:13-23 (nbNeuron=21, nbLayer=2, nEpochExt=120,
  nEpoch=100, batchSize=10, lRateY0=4e-4, lRateLoc=3e-4, lRateReg=3e-4,
  aLin=0.1, limit=30)
* VG — mainVG.py:12-22 (lRateY0=5e-4, lRateLoc=3e-4, lRateReg=1.5e-4)
* MFG comparison — mainMFGComparison.py:13-31 (nbNeuron_hat=20, nbNeuron=22,
  nEpochExt=100, nEpoch=200, batchSize=128, jumpFac=2.16, nbDays=2,
  lRateY0=1e-3, lRateLoc=1.5e-4, lRateReg=1e-4)
* MFG PoA — mainMFGPoA.py:18-36 (nEpoch=300, batchSize=64, jumpFac=12,
  nbDays=1, lRateY0=1e-2, lRateLoc=1e-3, lRateReg=5e-3)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

PRICING_METHODS = ("Global", "SumMultiStep1", "SumMultiStep2", "SumLocal1",
                   "SumLocal2", "SumLocalReg", "SumMultiStepReg")
MFG_METHODS = ("Global", "SumMultiStep", "SumLocal", "SumLocalReg",
               "SumMultiStepReg")

# Reference method name -> internal scheme key (solvers/pricing.py, solvers/mfg.py).
PRICING_METHOD_TO_SCHEME = {
    "Global": "global",
    "SumMultiStep1": "multistep1",
    "SumMultiStep2": "multistep2",
    "SumLocal1": "sumlocal1",
    "SumLocal2": "sumlocal2",
    "SumLocalReg": "sumlocal_reg",
    "SumMultiStepReg": "multistep_reg",
}
MFG_METHOD_TO_SCHEME = {
    "Global": "global",
    "SumMultiStep": "multistep",
    "SumLocal": "sumlocal",
    "SumLocalReg": "sumlocal_reg",
    "SumMultiStepReg": "multistep_reg",
}


@dataclasses.dataclass
class RunIO:
    """Where (and whether) to write artifacts."""

    outdir: Optional[str] = None      # None -> no files written
    metrics_jsonl: bool = True        # write <outdir>/metrics.jsonl
    save_plots: bool = False          # write convergence figures
    checkpoint_every: int = 0         # outer epochs between checkpoints (0=off)
    resume: bool = False              # resume from latest checkpoint if present
    profile_dir: Optional[str] = None  # jax.profiler trace dir


@dataclasses.dataclass
class PricingConfigBase:
    """Shared knobs of the two pricing experiments."""

    nb_neuron: int = 21
    nb_layer: int = 2
    n_epoch_ext: int = 120
    n_epoch: int = 100
    batch_size: int = 10
    lrate_y0: float = 4e-4
    lrate_loc: float = 3e-4
    lrate_reg: float = 3e-4
    activation: str = "tanh"
    a_lin: float = 0.1
    methods: Sequence[str] = PRICING_METHODS
    compensator: str = "quadrature"   # "quadrature" | "mc" (reference = mc 5000)
    n_mc: int = 5000
    n_poisson_max: int = 6            # quadrature sizing (Merton)
    n_hermite: int = 8
    n_laguerre: int = 12              # quadrature sizing (VG)
    compute_dtype: Optional[str] = None   # "bfloat16" (biases Y0 ~3e-3)
    jump_sampler: str = "exact"       # "icdf" = truncated inverse-CDF Poisson
    x_interp: str = "direct"          # "chebyshev" = collocated compensator
    n_cheb: int = 64
    # Hoist the collocation tables out of the time scan + chunk the scan
    # into unrolled blocks (solvers/pricing.py round-3 speed path; requires
    # x_interp="chebyshev").
    hoist: bool = False
    hoist_interp: str = "piecewise"   # "clenshaw" | "piecewise" (see ops/piecewise.py)
    scan_chunk: int = 0
    price_mode: str = "series"        # Merton: "chebyshev" = collocated pricer
    # The reference trains the two Y-only regression schemes on 1000x the
    # nominal batch inside the solver (SolversJumpDiff.py:435,503) — kept as
    # an explicit config knob instead of a hidden multiplier.
    reg_batch_multiplier: int = 1000
    # Shard the path batch over all visible devices (1-D data mesh,
    # gradient all-reduce across it).  batch_size stays the GLOBAL batch: each chip
    # simulates ceil(batch/n_chips) paths.
    data_parallel: bool = False
    # Report Y0 as the mean of the last k outer-epoch estimates instead of
    # the final one (Polyak-style readout).  The Global scheme's trainable
    # Y0 random-walks around its optimum under SGD noise; averaging the
    # trailing epochs removes most of that variance (round-2 gate study).  1 = reference behavior (last epoch).
    y0_tail_avg: int = 1
    # Initialize the Global scheme's trainable Y0 at an oracle-free MC
    # payoff estimate instead of the reference's std-1 normal draw (~1/3 of
    # which land Adam in a spurious negative-Y0 basin — round-2 gate
    # study).  Off by default for init parity.
    y0_warm_start: bool = False
    seed: int = 0
    io: RunIO = dataclasses.field(default_factory=RunIO)

    @property
    def hidden(self) -> Tuple[int, ...]:
        return (self.nb_neuron,) * self.nb_layer

    def lrate_for(self, method: str) -> float:
        """Per-method learning rate (mainMerton.py:105-118)."""
        if method == "Global":
            return self.lrate_y0
        if method in ("SumLocalReg", "SumMultiStepReg"):
            return self.lrate_reg
        return self.lrate_loc


@dataclasses.dataclass
class MertonConfig(PricingConfigBase):
    """mainMerton.py defaults (:13-23, params :57)."""

    limit: int = 30


@dataclasses.dataclass
class VGConfig(PricingConfigBase):
    """mainVG.py defaults (:12-22, params :54)."""

    lrate_y0: float = 5e-4
    lrate_loc: float = 3e-4
    lrate_reg: float = 1.5e-4
    pricer: str = "fft"               # "fft" | "invfourier"


@dataclasses.dataclass
class MFGConfigBase:
    nb_neuron_hat: int = 20
    nb_neuron: int = 22
    nb_layer_hat: int = 2
    nb_layer: int = 2
    n_epoch_ext: int = 100
    n_epoch: int = 200
    batch_size: int = 128
    raf_coef: int = 1
    jump_factor: float = 2.16
    nb_days: int = 2
    lrate_y0: float = 1e-3
    lrate_loc: float = 1.5e-4
    lrate_reg: float = 1e-4
    couplage: str = "ON"
    jump_model: str = "stochastic"
    activation_hat: str = "tanh"
    activation: str = "tanh"
    # Speed knobs (CLI --fast sets icdf + scan_chunk=16): "icdf" replaces jax.random.poisson's per-path rejection
    # loop with the table-inverted Cox sampler; scan_chunk unrolls the time
    # scan in blocks (ops/scan.py) — same math, tested flat-equal.
    jump_sampler: str = "exact"
    scan_chunk: int = 0
    # Shard the path batch over all visible chips (see PricingConfigBase).
    data_parallel: bool = False
    # Initialize the Global scheme's trainable (Y0_hat, Y0) scalars at
    # Picard-iterated MC estimates of the BSDE initial values instead of the
    # reference's std-1 normal draws (MFGSolver.warm_start_y0).  At the
    # reference budget the Glorot-init scalars cannot travel from ~0 to the
    # ≈ −46 consensus (lr·steps bounds travel at ≈ 20 — round-4 MFG study,
    # mfg-compare).  Off by default for init parity.
    y0_warm_start: bool = False
    seed: int = 0
    io: RunIO = dataclasses.field(default_factory=RunIO)

    @property
    def hidden_hat(self) -> Tuple[int, ...]:
        return (self.nb_neuron_hat,) * self.nb_layer_hat

    @property
    def hidden(self) -> Tuple[int, ...]:
        return (self.nb_neuron,) * self.nb_layer


@dataclasses.dataclass
class MFGComparisonConfig(MFGConfigBase):
    """mainMFGComparison.py defaults (:13-31; price coefs :108)."""

    methods: Sequence[str] = MFG_METHODS
    # Frozen-noise evaluation paths: every trained policy is replayed on ONE
    # common frozen noise set and its objective cost ± 95% CI reported
    # (0 = skip).  The reference parses nbSimulation but never uses it
    # (mainMFGComparison.py:28,41) — this is its intended role.
    n_simulation: int = 10**5
    pi: float = 0.1
    p0: float = 6.159423723
    p1: float = 87.4286117
    f0: float = 0.0
    f1: float = 1e4

    def lrate_for(self, method: str) -> float:
        """Per-method lr.  NOTE the reference's crossed mapping is preserved:
        SumMultiStep trains with lRateReg and SumLocalReg with lRateLoc
        (mainMFGComparison.py:128-135)."""
        table = {
            "Global": self.lrate_y0,
            "SumMultiStep": self.lrate_reg,
            "SumLocal": self.lrate_loc,
            "SumMultiStepReg": self.lrate_reg,
            "SumLocalReg": self.lrate_loc,
        }
        return table[method]


@dataclasses.dataclass
class MFGPoAConfig(MFGConfigBase):
    """mainMFGPoA.py defaults (:18-36) and its case sweep (:189-198)."""

    nb_neuron: int = 20
    n_epoch_ext: int = 100
    n_epoch: int = 300
    batch_size: int = 64
    jump_factor: float = 12.0
    nb_days: int = 1
    lrate_y0: float = 1e-2
    lrate_loc: float = 1e-3
    lrate_reg: float = 5e-3
    method: str = "Global"
    n_frozen: int = 1000              # frozen-noise trajectory count (nbSimul)
    n_replay: int = 5                 # NbSimulation — paths recorded/plotted
    pi_list: Sequence[float] = (0.0, 0.1, 0.5, 0.95)
    # case name -> (p0, p1, f0, f1), mainMFGPoA.py:189
    cases: Dict[str, Tuple[float, float, float, float]] = dataclasses.field(
        default_factory=lambda: {
            "with jumps and with dynamic pricing": (6.159423723, 87.4286117, 0.0, 1e4),
            "with jumps and without pricing": (0.0, 0.0, 0.0, 1e4),
            "without jumps and with pricing": (6.159423723, 87.4286117, 0.0, 0.0),
        })

    def lrate_for(self, method: str) -> float:
        """mainMFGPoA.py:216-225 (no crossed mapping here)."""
        table = {
            "Global": self.lrate_y0,
            "SumMultiStep": self.lrate_loc,
            "SumLocal": self.lrate_loc,
            "SumMultiStepReg": self.lrate_reg,
            "SumLocalReg": self.lrate_reg,
        }
        return table[method]
