"""Reference-parity solver classes.

Users of the TF reference drive training through solver classes named
``SolverGlobalFBSDE``, ``SolverMultiStepFBSDE1``, ... each exposing
``train(batchSize, batchSizeVal, num_epoch, num_epochExt) -> (listY0, duration)``
plus ``lossList`` (SolversJumpDiff.py / SolversPureJump.py).  This module keeps
that surface as a thin veneer over the functional core
(:mod:`deepfbsdejsolvers_tpu.solvers.pricing`): one class per scheme, regime
inferred from the math model, nets built internally exactly as the mains wire
them (mainMerton.py:94-102, mainVG.py:91-95).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import TrainResult, fit


class _SolverFacade:
    scheme: str = ""

    def __init__(self, math_model, lrate: float, hidden=(21, 21),
                 activation: str = "tanh",
                 compensator: CompensatorSpec = CompensatorSpec(),
                 seed: int = 0, **solver_kw):
        """``solver_kw`` passes through to :class:`PricingSolver` (e.g.
        ``compute_dtype="bfloat16"``, ``hoist=True``; the Chebyshev
        collocation knobs live on ``compensator`` / the math model)."""
        self.core = PricingSolver(
            model=math_model, scheme=self.scheme, hidden=tuple(hidden),
            activation=activation, compensator=compensator, **solver_kw,
        )
        self.math_model = math_model
        self.lrate = lrate
        self.seed = seed
        self.listY0: list = []
        self.lossList: list = []
        self.duration: float = 0.0
        self.durationList: list = []
        self.params = None
        self.result: Optional[TrainResult] = None

    def train(self, batch_size: int, batch_size_val: int, num_epoch: int,
              num_epoch_ext: int, verbose: bool = True) -> Tuple[list, float]:
        key = jax.random.key(self.seed)
        key, k_init = jax.random.split(key)
        params = self.core.init_params(k_init)
        res = fit(
            loss_fn=self.core.build_loss(batch_size),
            params=params,
            key=key,
            lrate=self.lrate,
            num_epoch=num_epoch,
            num_epoch_ext=num_epoch_ext,
            val_loss_fn=self.core.build_loss(batch_size_val),
            y0_fn=self.core.y0_estimate,
            verbose=verbose,
        )
        self.result = res
        self.params = res.params
        self.listY0 = res.y0_history
        self.lossList = res.loss_history
        self.duration = res.duration
        self.durationList = res.duration_history
        return res.y0_history, res.duration


class SolverGlobalFBSDE(_SolverFacade):
    """Trainable-Y0 global deep-BSDE (SolversJumpDiff.py:17-73 /
    SolversPureJump.py:17-72)."""
    scheme = "global"


class SolverMultiStepFBSDE1(_SolverFacade):
    """One-net multistep forward replication (SolversJumpDiff.py:75-149)."""
    scheme = "multistep1"


class SolverMultiStepFBSDE2(_SolverFacade):
    """Two-net multistep forward replication (SolversJumpDiff.py:151-224)."""
    scheme = "multistep2"


class SolverSumLocalFBSDE1(_SolverFacade):
    """One-net one-step residual scheme (SolversJumpDiff.py:226-303)."""
    scheme = "sumlocal1"


class SolverSumLocalFBSDE2(_SolverFacade):
    """Two-net one-step residual scheme (SolversJumpDiff.py:305-381)."""
    scheme = "sumlocal2"


class SolverGlobalSumLocalReg(_SolverFacade):
    """Y-only local regression (SolversJumpDiff.py:385-445).  NOTE: the
    reference trains this with 1000x the nominal batch (:435); pass the batch
    you actually want — no hidden multiplier here."""
    scheme = "sumlocal_reg"


class SolverGlobalMultiStepReg(_SolverFacade):
    """Y-only multistep regression (SolversJumpDiff.py:453-513)."""
    scheme = "multistep_reg"


SOLVER_CLASSES = {
    "Global": SolverGlobalFBSDE,
    "SumMultiStep1": SolverMultiStepFBSDE1,
    "SumMultiStep2": SolverMultiStepFBSDE2,
    "SumLocal1": SolverSumLocalFBSDE1,
    "SumLocal2": SolverSumLocalFBSDE2,
    "SumLocalReg": SolverGlobalSumLocalReg,
    "SumMultiStepReg": SolverGlobalMultiStepReg,
}
