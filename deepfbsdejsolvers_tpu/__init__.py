"""deepfbsdejsolvers_tpu — a JAX framework for deep FBSDE solvers with jumps.

A from-scratch rebuild of the capability surface of the TF research code
``ZakariaBensaid/DeepFBSDEJSolvers`` (companion code of "Deep Learning Algorithms
for FBSDEs with Jumps", Alasseur–Bensaid–Dumitrescu–Warin), re-designed for
compiled accelerator execution:

* math models are pure, stateless dataclasses with precomputed device tables
  (Merton power-series pricer, VG Carr–Madan FFT price tables, MFG mean-field
  tables), replacing per-step recomputation and host round-trips;
* networks are functional MLP pytrees; solvers build pure ``loss(params, key)``
  closures whose time loop is a single ``lax.scan``;
* the compensated-jump expectation E[Γ(t,X,J)] is evaluated either by the
  reference's 5000-sample Monte-Carlo sweep or by deterministic Gauss-Hermite /
  generalized Gauss-Laguerre quadrature over the known jump law;
* training runs as a device-side ``lax.scan`` over Adam steps (one host sync per
  outer epoch) and scales over devices with ``shard_map`` + ``psum``.

See SURVEY.md for the layer map of the reference and the build plan.
"""

__version__ = "0.2.0"

from deepfbsdejsolvers_tpu.models.merton import MertonJumpModel
from deepfbsdejsolvers_tpu.models.variance_gamma import VGModel
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec

__all__ = [
    "MertonJumpModel",
    "VGModel",
    "CompensatorSpec",
    "__version__",
]
