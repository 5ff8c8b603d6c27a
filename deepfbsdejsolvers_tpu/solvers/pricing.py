"""Deep-BSDE pricing solvers — all 7 schemes x 2 noise regimes.

Rebuilds the full solver matrix of the reference as ONE parametrized rollout
family instead of 14 copy-pasted classes:

  scheme          jump-diffusion reference          pure-jump reference
  --------------  --------------------------------- ---------------------------------
  global          SolversJumpDiff.SolverGlobalFBSDE       SolversPureJump.SolverGlobalFBSDE
  multistep1      ...SolverMultiStepFBSDE1:75             ...:74
  multistep2      ...SolverMultiStepFBSDE2:151            ...:143
  sumlocal1       ...SolverSumLocalFBSDE1:226             ...:210
  sumlocal2       ...SolverSumLocalFBSDE2:305             ...:282
  sumlocal_reg    ...SolverGlobalSumLocalReg:385          ...:355
  multistep_reg   ...SolverGlobalMultiStepReg:453         ...:422

The BSDE is  dY = -f(Y) dt [+ Z dW] + Γ dΠ̃  with Γ's compensator evaluated by
an inner sweep over the jump law (ops/compensator.py).  Schemes differ in the
loss and in how Γ is parametrized:

* global        — trainable scalar Y0, terminal loss E(Y_N - g(X_N))².
* multistep1/2  — forward-replication loss mean_i E(Y_i + Σ_{j≥i} toAdd_j - g(X_N))²
                  (equivalent to the reference's "add toAdd to every previous
                  list entry" accumulation — a suffix sum; the reduction over
                  steps is a MEAN: SolversJumpDiff.py:115's reduce_sum wraps an
                  already-scalar double reduce_mean).
* sumlocal1/2   — one-step residual loss Σ_i E(Y_{i+1} - Y_i + toAdd_i)².
* *_reg         — pure regression on Y (no Z/Γ in the loss).
* "1" variants reuse the U-net as Γ (Γ = U(t, X·e^J) jump-diff / U(t, X+X·J)
  pure-jump); "2" variants carry a separate Γ-net.

Reference idiosyncrasies preserved on purpose (documented where they occur):
the time feature fed to the nets is the *raw step index* i (not i·dt); the
sumlocal variants evaluate the step-(i+1) state with time feature i; the
pure-jump global solver trains only the Γ-net, which also carries Y0.

Execution: the time loop is a single ``lax.scan``; ALL rollout noise is drawn
in three batched (N, B) kernels before the scan (``_prenoise`` — per-step RNG
kernels are both launch overhead and backward-pass recompute under remat);
everything compiles to one XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deepfbsdejsolvers_tpu.nets.mlp import MLPSpec, get_activation, init_mlp, mlp_apply
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec, compensated_mean

PRICING_SCHEMES = (
    "global",
    "multistep1",
    "multistep2",
    "sumlocal1",
    "sumlocal2",
    "sumlocal_reg",
    "multistep_reg",
)

Params = Dict[str, dict]

def _suffix_sum(x: jax.Array) -> jax.Array:
    """S_i = sum_{j >= i} x_j along axis 0 (the multistep accumulation:
    SolversJumpDiff.py:107-108 adds toAdd_i to every previous list entry)."""
    return jnp.cumsum(x[::-1], axis=0)[::-1]


@dataclasses.dataclass(frozen=True)
class PricingSolver:
    """Builds pure ``loss(params, key)`` closures for one (model, scheme) pair.

    ``model`` is a MertonJumpModel / VGModel-like object exposing:
    ``regime, N, dt, init_x, sample_jumps, step, f, payoff, jump_quadrature``.
    """

    model: object
    scheme: str
    hidden: Tuple[int, ...] = (21, 21)
    activation: str = "tanh"
    compensator: CompensatorSpec = CompensatorSpec()
    remat: bool = True
    # Matmul compute dtype for the MLP heads (params/carry stay float32).
    # "bfloat16" is an opt-in speed path; None keeps full float32
    # (reference-parity accuracy).
    compute_dtype: Optional[str] = None
    # When set, the compensator node axis is sharded over this mesh axis: each
    # shard sweeps its node slice and the weighted partial sums are psum'd
    # across the axis.  The loss must then run inside shard_map on a mesh with
    # this axis (parallel/data_parallel.py).
    comp_axis: Optional[str] = None
    comp_shards: int = 1
    # Hoist the per-step Chebyshev collocation OUT of the time scan: the
    # (N, n_cheb) compensator (and collocated-pricer) coefficient tables are
    # computed in ONE batched evaluation before the scan, on per-step
    # intervals bounded from the pre-drawn noise's UNcoupled X marginals
    # (models' ``uncoupled_log_increments``; the small coupling drift is
    # absorbed by ``hoist_pad_frac`` interval padding + Clenshaw's boundary
    # clamp).  The scan body then reduces to pure elementwise math + the
    # realized-Γ/Z heads: no per-step sweep kernels and no (N, B) sweep
    # buffers inside the scan.
    # Requires ``compensator.x_interp == "chebyshev"`` and no comp sharding.
    hoist: bool = False
    hoist_pad_frac: float = 0.15
    # Hoisted-table evaluator: "clenshaw" evaluates the global degree-(C-1)
    # Chebyshev interpolant (63 serial FMAs x ~3 ops per path per function);
    # "piecewise" evaluates P local degree-(D-1) polynomials after an exact
    # per-path piece select (short Clenshaw chains at the same 64 degrees of
    # freedom; see ops/piecewise.py).
    hoist_interp: str = "clenshaw"
    pw_pieces: int = 8
    pw_degree: int = 7
    # Collocate the Z head too (global jump-diffusion scheme only, where the
    # UZ net's output is exactly Z(t, x) — 1-D smooth in x).  Bias-free: the
    # interpolation error is a deterministic function of X_i multiplied by
    # the INDEPENDENT increment dW_i, so E[err(X_i) dW_i] = 0 — it adds
    # O(3e-5) variance, not bias.  Replaces 3 head dots per step with the
    # table evaluator.
    hoist_z: bool = True
    # Collocate the realized-jump Γ head as well (gam-net schemes on the
    # piecewise hoisted path): per-step 2-D tensor-product piecewise tables
    # over (x, j) — x on the same hoisted intervals as the other tables, j on
    # the EXACT range of that step's pre-drawn jumps; this removes the last
    # per-path per-step MLP from the scan.  OFF by default: it was measured
    # slower than the three thin head dots it replaces on the accelerator the
    # library was first tuned on, and has not been re-measured on the GPU.
    # Correctness is gated in tests (exact on CPU to ~5e-7 loss rel);
    # reference Γ-head semantics: SolversJumpDiff.py:37, SolversPureJump.py:34.
    hoist_gamma: bool = False
    pw_pieces_j: int = 4
    pw_degree_j: int = 4
    # Chunk the time scan: outer lax.scan over N/scan_chunk chunks of
    # ``scan_chunk`` fully-unrolled steps, rematerialized at chunk boundaries.
    # Cuts while-loop iteration count (fewer buffer double-buffer copies,
    # fewer kernel launches) and lets XLA fuse across steps.  0 = off.
    scan_chunk: int = 0
    # Hand-written transposed-adjoint VJP for the rollout (solvers/adjoint.py):
    # the backward's head gradients (Γ-net value/∂x/params, table derivatives)
    # are recomputed in ONE batched (N·B) pass outside any scan, leaving a
    # pure-elementwise reverse scan.  Measured slower than XLA autodiff on
    # the accelerator the library was first tuned on (the batched passes
    # materialize (N·B)-sized intermediates); not yet re-measured on the GPU.
    # Kept as a tested opt-in instrument (grads == autodiff to 3e-5,
    # tests/test_adjoint.py).  Global jump-diffusion scheme on the fully
    # hoisted piecewise path only; warns and falls back elsewhere.
    adjoint: bool = False
    # Scale applied to the raw step-index time feature before it enters the
    # nets (t = i * time_scale).  1.0 is reference parity (SolversJumpDiff.py
    # feeds the raw index).  The raw index degrades net quality at large N
    # (the N=800 cells of the round-3 bias study collapse to ~6e-3 because
    # the tanh first layer saturates over [0, 800] within the fixed Adam
    # budget); time_scale = 50/N keeps the feature range of the reference's
    # default configuration.  A study/diagnostic knob, not a default.
    time_scale: float = 1.0

    def __post_init__(self):
        if self.scheme not in PRICING_SCHEMES:
            raise ValueError(f"scheme must be one of {PRICING_SCHEMES}, got {self.scheme!r}")
        if self.model.regime not in ("jump_diffusion", "pure_jump"):
            raise ValueError(f"unknown regime {self.model.regime!r}")
        if self.hoist:
            if self.compensator.x_interp != "chebyshev":
                raise ValueError(
                    "hoist=True requires compensator.x_interp='chebyshev' "
                    "(the hoisted tables ARE the collocation)")
            if self.comp_axis is not None:
                raise ValueError("hoist=True is incompatible with "
                                 "compensator-axis sharding")
        if self.hoist_interp not in ("piecewise", "clenshaw"):
            raise ValueError(
                "hoist_interp must be 'piecewise' or 'clenshaw', got "
                f"{self.hoist_interp!r}")
        if self.compensator.kind == "quadrature":
            nodes, weights = self.model.jump_quadrature(self.compensator)
            if self.comp_axis is not None:
                # zero-weight pad so the node count divides the comp shards
                m = int(nodes.shape[0])
                per = -(-m // self.comp_shards)
                pad = per * self.comp_shards - m
                nodes = jnp.pad(nodes, (0, pad))
                weights = jnp.pad(weights, (0, pad))
        else:
            nodes, weights = None, None
            if self.comp_axis is not None and self.compensator.n_mc % self.comp_shards:
                raise ValueError(
                    f"comp_shards ({self.comp_shards}) must divide n_mc "
                    f"({self.compensator.n_mc})")
        object.__setattr__(self, "_quad", (nodes, weights))
        object.__setattr__(self, "_act", get_activation(self.activation))
        object.__setattr__(
            self, "_compute_dtype",
            jnp.dtype(self.compute_dtype) if self.compute_dtype else None)

    # ------------------------------------------------------------------ nets
    @property
    def jump_diff(self) -> bool:
        return self.model.regime == "jump_diffusion"

    def net_specs(self) -> Dict[str, MLPSpec]:
        """Network wiring per scheme, mirroring mainMerton.py:94-102 (jump-diff:
        UZ-net carries Y0 for global, 2 outputs for Z-bearing schemes, Γ-net has
        3 inputs) and mainVG.py:91-95 (pure-jump: U-net 1 output, Γ-net carries
        Y0 for global)."""
        h, a = self.hidden, self.activation
        specs: Dict[str, MLPSpec] = {}
        if self.jump_diff:
            if self.scheme == "global":
                specs["uz"] = MLPSpec(2, h, 1, a, with_y0=True)   # -> Z
                specs["gam"] = MLPSpec(3, h, 1, a)                # (t, X, J)
            elif self.scheme in ("multistep1", "sumlocal1"):
                specs["uz"] = MLPSpec(2, h, 2, a)                 # -> (Y, Z)
            elif self.scheme in ("multistep2", "sumlocal2"):
                specs["uz"] = MLPSpec(2, h, 2, a)
                specs["gam"] = MLPSpec(3, h, 1, a)                # (t, X, e^J)
            else:  # regressions
                specs["uz"] = MLPSpec(2, h, 1, a)                 # -> Y
        else:
            if self.scheme == "global":
                # Pure-jump global: ONLY the Γ-net exists/trains and it carries
                # Y0 (SolversPureJump.py:27,48; mainVG.py:95).
                specs["gam"] = MLPSpec(3, h, 1, a, with_y0=True)  # (t, X, X·J)
            elif self.scheme in ("multistep1", "sumlocal1", "sumlocal_reg",
                                 "multistep_reg"):
                specs["uz"] = MLPSpec(2, h, 1, a)                 # -> Y
            else:  # multistep2 / sumlocal2
                specs["uz"] = MLPSpec(2, h, 1, a)
                specs["gam"] = MLPSpec(3, h, 1, a)                # (t, X, X·J)
        return specs

    def init_params(self, key: jax.Array) -> Params:
        specs = self.net_specs()
        keys = jax.random.split(key, len(specs))
        return {name: init_mlp(k, spec) for (name, spec), k in zip(specs.items(), keys)}

    # ------------------------------------------------------------- head evals
    def _apply(self, p, cols) -> jax.Array:
        return mlp_apply(p, cols, self._act, compute_dtype=self._compute_dtype)

    def _uz(self, params, i, x):
        """U/Z head on [t=i, X] (SolversJumpDiff.py:36)."""
        t = jnp.broadcast_to(jnp.asarray(i, x.dtype) * self.time_scale,
                             x.shape)
        return self._apply(params["uz"], jnp.stack([t, x], -1))

    def _gamma_inputs(self, i, x, j):
        """Γ-head inputs for a 2-net scheme: (t, X, J-feature) where the
        J-feature is raw J for jump-diff global (SolversJumpDiff.py:37), e^J for
        multistep2/sumlocal2 (:173), X·J for all pure-jump 2-net schemes
        (SolversPureJump.py:34)."""
        t = jnp.broadcast_to(jnp.asarray(i, x.dtype) * self.time_scale,
                             jnp.broadcast_shapes(x.shape, j.shape))
        xb = jnp.broadcast_to(x, t.shape)
        if not self.jump_diff:
            feat = xb * jnp.broadcast_to(j, t.shape)
        elif self.scheme == "global":
            feat = jnp.broadcast_to(j, t.shape)
        else:
            feat = jnp.broadcast_to(jnp.exp(j), t.shape)
        return jnp.stack([t, xb, feat], -1)

    def _unet_jump_inputs(self, i, x, j):
        """Γ-via-U inputs for 1-net schemes: (t, X·e^J) jump-diff
        (SolversJumpDiff.py:99) / (t, X + X·J) pure-jump (SolversPureJump.py:95)."""
        shape = jnp.broadcast_shapes(x.shape, j.shape)
        t = jnp.broadcast_to(jnp.asarray(i, x.dtype) * self.time_scale, shape)
        xb = jnp.broadcast_to(x, shape)
        jb = jnp.broadcast_to(j, shape)
        arg = xb * jnp.exp(jb) if self.jump_diff else xb + xb * jb
        return jnp.stack([t, arg], -1)

    def _resolve_node_block(self, n_nodes: int, batch: int) -> Optional[int]:
        """Effective node-axis chunk size (CompensatorSpec.node_block): auto
        keeps one block's [block, B, H] activations ~1 GB and is a no-op for
        small sweeps."""
        block = self.compensator.node_block
        if block is None:                       # auto
            block = max(1, (1 << 24) // max(batch, 1))
        if block <= 0 or block >= n_nodes:
            return None
        return int(block)

    def _sweep_values(self, params, i, x_row, nodes_col, use_gam_net):
        """Raw Γ-head sweep values on the (node, path) product grid."""
        if use_gam_net:
            return self._apply(
                params["gam"], self._gamma_inputs(i, x_row, nodes_col))[..., 0]
        return self._apply(
            params["uz"], self._unet_jump_inputs(i, x_row, nodes_col))[..., 0]

    def _sweep_mean(self, params, i, x, nodes, weights, use_gam_net) -> jax.Array:
        """Weighted node sweep E_J[Γ(t, x, J)] over the batch — the direct
        O(M·B) primitive (SolversJumpDiff.py:38-39), chunked over the node
        axis when the [M, B, H] activations would not fit HBM.

        Chunking computes per-block weighted partial sums under ``lax.map``
        with rematerialized blocks: the backward pass replays one block at a
        time, so peak memory is O(block·B) instead of O(M·B) and the
        reference-exact MC-5000 semantics run at the 2^17 headline batch."""
        with jax.named_scope("comp_sweep"):
            return self._sweep_mean_blocks(params, i, x, nodes, weights,
                                           use_gam_net)

    def _sweep_mean_blocks(self, params, i, x, nodes, weights, use_gam_net):
        m = int(nodes.shape[0])
        block = self._resolve_node_block(m, int(x.shape[0]))
        if block is None:
            sweep = self._sweep_values(params, i, x[None, :], nodes[:, None],
                                       use_gam_net)
            return compensated_mean(sweep, weights)
        n_blocks = -(-m // block)
        pad = n_blocks * block - m
        # Uniform MC weights become explicit so zero-weight padding is exact.
        w = (jnp.full((m,), 1.0 / m, jnp.float32) if weights is None
             else weights)
        if pad:
            nodes = jnp.pad(nodes, (0, pad))
            w = jnp.pad(w, (0, pad))
        nodes_r = nodes.reshape(n_blocks, block)
        w_r = w.reshape(n_blocks, block)

        def blk(args):
            nd, wt = args
            sweep = self._sweep_values(params, i, x[None, :], nd[:, None],
                                       use_gam_net)
            return jnp.sum(wt[:, None] * sweep.astype(jnp.float32), axis=0)

        partials = jax.lax.map(jax.checkpoint(blk), (nodes_r, w_r))
        return jnp.sum(partials, axis=0)

    def _sweep_comp_at(self, params, i, x_pts, nodes, weights,
                       use_gam_net) -> jax.Array:
        """Direct compensator values at arbitrary spot points ``x_pts``:
        weighted node sweep of the Γ-head (the O(M·|x_pts|) primitive)."""
        with jax.named_scope("comp_sweep"):
            sweep = self._sweep_values(params, i, x_pts[None, :],
                                       nodes[:, None], use_gam_net)
            return compensated_mean(sweep, weights)

    def _gamma_realized(self, params, i, x, j, use_gam_net) -> jax.Array:
        """Γ at the realized jump (direct head evaluation)."""
        if use_gam_net:
            return self._apply(params["gam"],
                               self._gamma_inputs(i, x, j))[..., 0]
        return self._apply(params["uz"],
                           self._unet_jump_inputs(i, x, j))[..., 0]

    def _gamma_and_compensator(self, params, i, x, j, key_mc):
        """Γ(t, X, J) for the realized jump plus its compensator E_J'[Γ].

        The compensator sweep uses either ``n_mc`` fresh draws shared across the
        batch (reference semantics, SolversJumpDiff.py:34,38-39) or the static
        quadrature nodes.  Returns (gamma, compensator), both (B,)."""
        use_gam_net = "gam" in params and (self.scheme != "multistep1"
                                           and self.scheme != "sumlocal1")
        if (self.compensator.x_interp == "chebyshev"
                and self.comp_axis is None):
            from deepfbsdejsolvers_tpu.ops.chebyshev import interp_1d

            if self.compensator.kind == "mc":
                nodes = self.model.sample_jumps(key_mc, (self.compensator.n_mc,))
                weights = None
            else:
                nodes, weights = self._quad
            comp = interp_1d(
                lambda xn: self._sweep_comp_at(params, i, xn, nodes, weights,
                                               use_gam_net),
                x, self.compensator.n_cheb,
                robust_sigmas=self.compensator.cheb_robust_sigmas)
            gam = self._gamma_realized(params, i, x, j, use_gam_net)
            return self._name_heads(gam, comp)
        sharded = self.comp_axis is not None
        if self.compensator.kind == "mc":
            n = self.compensator.n_mc
            if sharded:
                # each comp shard draws its own slice of the MC node set
                key_mc = jax.random.fold_in(key_mc, jax.lax.axis_index(self.comp_axis))
                n = n // self.comp_shards
            nodes = self.model.sample_jumps(key_mc, (n,))
            weights = None
        else:
            nodes, weights = self._quad
            if sharded:
                per = nodes.shape[0] // self.comp_shards
                c = jax.lax.axis_index(self.comp_axis)
                nodes = jax.lax.dynamic_slice_in_dim(nodes, c * per, per)
                weights = jax.lax.dynamic_slice_in_dim(weights, c * per, per)
        gam = self._gamma_realized(params, i, x, j, use_gam_net)
        comp = self._sweep_mean(params, i, x, nodes, weights, use_gam_net)
        if sharded:
            if weights is None:
                comp = jax.lax.pmean(comp, self.comp_axis)  # mean of MC shards
            else:
                comp = jax.lax.psum(comp, self.comp_axis)   # weighted partials
        return self._name_heads(gam, comp)

    # ---------------------------------------------------------------- rollout
    def _prenoise(self, key, batch, rows=None):
        """All rollout noise drawn in three BATCHED kernels before the scan.

        Per-step RNG inside the scan body costs several small kernels per
        step AND is re-executed by the rematerialized backward pass; drawing
        (N, B) tensors up front replaces that with three large kernels whose
        outputs are scan inputs (stored, never recomputed).  ~105 MB at the
        2^17 headline batch — noise, not activations, so remat is unaffected.

        Returns (dw, j, kms): dw (rows, B) Brownian increments (zero-width
        (rows, 0) for pure-jump — scan still threads it, at no cost), j
        (rows, B) realized jumps, kms (rows,) per-step subkeys for the MC
        compensator's node draws (kept as keys: the sharded MC path folds
        the shard index in per step)."""
        rows = self.model.N if rows is None else rows
        kd, kj, km = jax.random.split(key, 3)
        dt = self.model.dt
        if self.jump_diff:
            dw = np.sqrt(dt) * jax.random.normal(kd, (rows, batch),
                                                 jnp.float32)
        else:
            dw = jnp.zeros((rows, 0), jnp.float32)
        j = self.model.sample_jumps(kj, (rows, batch))
        kms = jax.random.split(km, rows)
        return dw, j, kms

    def _fstep(self, i, x, dw, j, y, price=None):
        """Forward SDE step, dispatching on regime (pure-jump drops dW:
        pricingModels.py:184-185 vs :53-54)."""
        if self.jump_diff:
            return self.model.step(i, x, dw, j, y, price=price)
        return self.model.step(i, x, j, y, price=price)

    # ------------------------------------------------- hoisted collocation
    @property
    def _use_gam_net_flag(self) -> bool:
        return "gam" in self.net_specs() and self.scheme not in (
            "multistep1", "sumlocal1")

    def _price_collocated(self) -> bool:
        """Whether the model itself opted into collocated price evaluation
        (the only case where hoisting the pricer preserves the configured
        semantics — otherwise the exact per-path series stays in the body)."""
        return (getattr(self.model, "price_mode", None) == "chebyshev"
                or getattr(self.model, "price_eval", None) == "chebyshev")

    def _hoist_active(self) -> bool:
        return self.hoist and self.comp_axis is None

    def _hoist_tables(self, params, noise, shift_next: bool = False) -> dict:
        """Per-step collocation tables, computed OUTSIDE the time scan.

        Returns {"lo", "hi", "cc"[, "pc"]}: per-step interval bounds (N,) and
        Chebyshev coefficients (N, C) of the compensator (and, when the model
        collocates its pricer, of A(i, x)).  Intervals come from the exact
        UNcoupled X marginals reconstructed from the pre-drawn noise by one
        cumsum — the coupled paths deviate only by the O(aLin*dt) coupling
        drift per step, covered by ``hoist_pad_frac`` padding (outliers clamp
        to the interval boundary in cheb_eval, where the integrand is ~flat).
        ``shift_next`` fits row i on the x_{i+1} marginal (the sumlocal
        schemes evaluate the step-i heads at the step-(i+1) state:
        SolversJumpDiff.py:264-266)."""
        import math as _math

        from deepfbsdejsolvers_tpu.ops.chebyshev import _cheb_tables, cheb_fit

        model = self.model
        N = model.N
        c = self.compensator.n_cheb
        dw, j, kms = noise
        incr = model.uncoupled_log_increments(dw[:N], j[:N])       # (N, B)
        # cumsum over the step axis as one (N, N) @ (N, B) lower-triangular
        # matmul.  HIGHEST: the log-X marginals set the table intervals and
        # must not be rounded to a reduced-precision matmul mantissa.
        tri = jnp.tril(jnp.ones((N, N), jnp.float32))
        csum = jnp.matmul(tri, incr, precision=jax.lax.Precision.HIGHEST)
        lx0 = _math.log(model.x0)
        if shift_next:
            lx = lx0 + csum                                        # x_{i+1}
        else:
            lx = lx0 + jnp.concatenate(
                [jnp.zeros_like(csum[:1]), csum[:-1]], axis=0)     # x_i
        # Interval padding happens in LOG space: multiplicative, so the
        # padded lower bound stays strictly positive (an additive pad can
        # push lo below 0 at later steps, and the pricer's log(x/K) NaNs).
        llo = jnp.min(lx, axis=1)
        lhi = jnp.max(lx, axis=1)
        lpad = self.hoist_pad_frac * (lhi - llo) + 0.01
        lo = jax.lax.stop_gradient(jnp.exp(llo - lpad))
        hi = jax.lax.stop_gradient(jnp.exp(lhi + lpad))
        if self.hoist_interp == "piecewise":
            from deepfbsdejsolvers_tpu.ops.piecewise import pw_fit, pw_nodes

            nodes = pw_nodes(lo, hi, self.pw_pieces, self.pw_degree)  # (N, P*D)
            fit = lambda v: pw_fit(v, self.pw_pieces, self.pw_degree)
        else:
            u = jnp.asarray(_cheb_tables(c)[0])                    # (C,)
            nodes = (0.5 * (lo + hi)[:, None]
                     + 0.5 * (hi - lo)[:, None] * u)               # (N, C)
            fit = cheb_fit
        use_gam = self._use_gam_net_flag
        steps = jnp.arange(N)
        # Matmul-precision policy: the node sweeps below go through the same
        # mlp_apply as the in-body realized-Γ/Z heads, so both evaluate one
        # and the same net function (at the precision nets/mlp.py states)
        # and the compensator is E_J of exactly the Γ the heads see.  The FITS are
        # explicitly HIGHEST (pw_fit/cheb_fit) and the piece select is exact
        # (ops/piecewise.py): a coefficient rounded to a reduced matmul
        # mantissa is a direct per-step bias in the compensator.
        if self.compensator.kind == "mc":
            n_mc = self.compensator.n_mc

            def comp_row(args):
                i, xp, km = args
                mc = self.model.sample_jumps(km, (n_mc,))
                return self._sweep_comp_at(params, i, xp, mc, None, use_gam)

            # blocks of steps bound the [block*C, n_mc, H] sweep activations
            vals = jax.lax.map(comp_row, (steps, nodes, kms[:N]),
                               batch_size=8)
        else:
            qn, qw = self._quad
            vals = jax.vmap(
                lambda i, xp: self._sweep_comp_at(params, i, xp, qn, qw,
                                                  use_gam))(steps, nodes)
        out = {"lo": lo, "hi": hi, "cc": fit(vals)}
        # shift_next tables span the x_{i+1} marginals, and their only
        # consumer (the sumlocal scan body) evaluates the forward drift's
        # A(i, X_i) un-hoisted — so the pricer table would be dead work.
        if self._price_collocated() and not shift_next:
            pvals = jax.vmap(model.price)(steps, nodes)
            out["pc"] = fit(pvals)
        if self.hoist_z and self.scheme == "global" and self.jump_diff:
            zvals = jax.vmap(
                lambda i, xp: self._uz(params, i, xp)[..., 0])(steps, nodes)
            out["zc"] = fit(zvals)
        if (self.hoist_gamma and self.hoist_interp == "piecewise" and use_gam):
            from deepfbsdejsolvers_tpu.ops.piecewise import pw2_fit, pw2_nodes

            jrow = j[:N]
            jlo = jax.lax.stop_gradient(jnp.min(jrow, axis=1))
            jhi = jax.lax.stop_gradient(jnp.max(jrow, axis=1))
            # The j bounds are EXACT (realized jumps are pre-drawn, unlike
            # the coupled x marginals); the pad only guards the fit against
            # a degenerate width when a step draws no jumps at all.
            jpad = 0.01 * (jhi - jlo) + 1e-4
            jlo, jhi = jlo - jpad, jhi + jpad
            px, dx = self.pw_pieces, self.pw_degree
            pj, dj = self.pw_pieces_j, self.pw_degree_j
            xn, jn = pw2_nodes(lo, hi, jlo, jhi, px, dx, pj, dj)
            gvals = jax.vmap(lambda i, xr, jr: self._apply(
                params["gam"],
                self._gamma_inputs(i, xr[:, None], jr[None, :]))[..., 0]
            )(steps, xn, jn)                                   # (N, nx, nj)
            out["gc"] = pw2_fit(gvals, px, dx, pj, dj)
            out["jlo"], out["jhi"] = jlo, jhi
        return out

    @staticmethod
    def _table_eval(coef, x, lo, hi):
        """Evaluate one step's hoisted table: (P, D) piecewise coefficients
        or (C,) Chebyshev coefficients, dispatched on rank."""
        if coef.ndim == 2:
            from deepfbsdejsolvers_tpu.ops.piecewise import pw_eval

            return pw_eval(coef, x, lo, hi)
        from deepfbsdejsolvers_tpu.ops.chebyshev import cheb_eval

        return cheb_eval(coef, x, lo, hi)

    def hoist_clamp_fractions(self, params, key, batch: int = 8192):
        """Per-step fraction of COUPLED paths falling outside the hoisted
        collocation intervals [lo_i, hi_i] — the runtime diagnostic for the
        ``hoist_pad_frac`` policy.

        The intervals are built from the exact UNcoupled X marginals of the
        pre-drawn noise (see :meth:`_hoist_tables`); coupled paths deviate
        only by the accumulated O(aLin·dt·|Y−A|) coupling drift, and any
        path outside its step interval silently clamps to the boundary in
        ``pw_eval``/``cheb_eval``.  This rolls the coupled forward exactly
        as the scheme's loss body does (global: BSDE-carried Y through the
        hoisted heads; multistep: head Y; sumlocal: head Y with the
        step-(i+1) evaluation state counted against the shift_next tables)
        and returns an (N,) array of out-of-interval fractions.  A heavier-
        tailed parameterization that breaks the pad policy shows up here as
        a non-vanishing fraction — see tests/test_fast_paths.py's heavy-tail
        stress test."""
        if not self._hoist_active():
            raise ValueError("hoist_clamp_fractions needs hoist=True "
                             "(and no comp_axis sharding)")
        model, N, dt = self.model, self.model.N, self.model.dt
        sumlocal = self.scheme.startswith("sumlocal")
        is_global = self.scheme == "global"

        def out_frac(xs_i, x):
            bad = (x < xs_i["lo"]) | (x > xs_i["hi"])
            return jnp.mean(bad.astype(jnp.float32))

        @jax.jit
        def run(params, key):
            x = model.init_x(batch)
            if sumlocal:
                dw_all, j_all, km_all = self._prenoise(key, batch, rows=N + 1)
                j = j_all[N]
                y_prev = self._uz(params, 0, x)[..., 0]
                xs = self._scan_xs(params, (dw_all, j_all, km_all),
                                   shift_next=True)

                def body(carry, xs_i):
                    x, j, y_prev = carry
                    i, dw, j_next = xs_i["i"], xs_i["dw"], xs_i["j"]
                    x = self._fstep(i, x, dw, j, y_prev)
                    # shift_next tables span the x_{i+1} marginal — count
                    # the state the heads actually evaluate at.
                    f = out_frac(xs_i, x)
                    y_net = self._uz(params, i, x)[..., 0]
                    y_next = jnp.where(i == N - 1, model.payoff(x), y_net)
                    return (x, j_next, y_next), f

                _, fracs = jax.lax.scan(body, (x, j, y_prev), xs, length=N)
                return fracs

            noise = self._prenoise(key, batch)
            xs = self._scan_xs(params, noise)
            y0 = (params["uz" if self.jump_diff else "gam"]["y0"]
                  if is_global else jnp.zeros(()))
            y = y0 * jnp.ones((batch,), jnp.float32)

            def body(carry, xs_i):
                x, y = carry
                i, dw, j = xs_i["i"], xs_i["dw"], xs_i["j"]
                f = out_frac(xs_i, x)
                if is_global:
                    gam, comp = self._heads_gamma_comp(params, xs_i, x, j)
                    y = y - dt * model.f(y) + gam - comp
                    if self.jump_diff:
                        z = (self._table_eval(xs_i["zc"], x, xs_i["lo"],
                                              xs_i["hi"]) if "zc" in xs_i
                             else self._uz(params, i, x)[..., 0])
                        y = y + z * dw
                else:
                    y = self._uz(params, i, x)[..., 0]
                x = self._fstep(i, x, dw, j, y,
                                price=self._step_price(xs_i, x))
                return (x, y), f

            _, fracs = jax.lax.scan(body, (x, y), xs, length=N)
            return fracs

        return run(params, key)

    def _scan_xs(self, params, noise, shift_next: bool = False) -> dict:
        """Per-step scan inputs as a dict pytree: index, noise rows, MC keys,
        plus the hoisted collocation tables when active."""
        dw, j, kms = noise
        N = self.model.N
        xs = {"i": jnp.arange(N), "dw": dw[:N], "j": j[:N], "km": kms[:N]}
        if self._hoist_active():
            xs.update(self._hoist_tables(params, noise, shift_next))
        return xs

    def _heads_gamma_comp(self, params, xs_i, x, j):
        """(Γ(realized), compensator) for one step — hoisted Clenshaw when
        the tables are in ``xs_i``, else the full in-scan machinery."""
        if "cc" in xs_i:
            from jax.ad_checkpoint import checkpoint_name

            comp = self._table_eval(xs_i["cc"], x, xs_i["lo"], xs_i["hi"])
            if "gc" in xs_i:
                from deepfbsdejsolvers_tpu.ops.piecewise import pw2_eval

                # Fully-hoisted step: Γ(realized) is a 2-D table eval —
                # cheap to recompute, so NOTHING is checkpoint-saved and the
                # backward's saved-head stacking traffic disappears.
                gam = pw2_eval(xs_i["gc"], x, j, xs_i["lo"], xs_i["hi"],
                               xs_i["jlo"], xs_i["jhi"],
                               self.pw_pieces, self.pw_degree,
                               self.pw_pieces_j, self.pw_degree_j)
                return gam, comp
            gam = self._gamma_realized(params, xs_i["i"], x, j,
                                       self._use_gam_net_flag)
            # gam is an MLP output worth saving for the backward pass; comp
            # is a 64-FMA Clenshaw — cheaper to recompute than to round-trip
            # through HBM, so it is deliberately NOT checkpoint-named here.
            return checkpoint_name(gam, "gam"), comp
        return self._gamma_and_compensator(params, xs_i["i"], x, j,
                                           xs_i["km"])

    def _step_price(self, xs_i, x):
        """Hoisted A(i, x) for the forward drift, or None to evaluate the
        model's own pricer in the body."""
        if "pc" in xs_i:
            return self._table_eval(xs_i["pc"], x, xs_i["lo"], xs_i["hi"])
        return None

    def _scan(self, body, carry, xs, length):
        """Time scan with optional chunking (ops/scan.py): outer scan over
        chunks of ``scan_chunk`` fully-unrolled steps, rematerialized per
        chunk with the save-only-heads policy."""
        from ..ops.scan import chunked_scan

        policy = jax.checkpoint_policies.save_only_these_names("gam", "comp")
        return chunked_scan(body, carry, xs, length, self.scan_chunk,
                            remat=self.remat, policy=policy)

    @staticmethod
    def _name_heads(gam, comp):
        """Tag the jump heads for the remat policy (see ``_maybe_remat``)."""
        from jax.ad_checkpoint import checkpoint_name

        return checkpoint_name(gam, "gam"), checkpoint_name(comp, "comp")

    def _maybe_remat(self, body):
        """Rematerialize the scan step for backprop — selectively.

        Without remat, XLA must keep the [M, B, hidden] compensator-sweep
        activations of EVERY timestep alive for the backward pass — at the
        reference's M=5000 that is O(N·M·B·H) HBM (tens of GB at production
        batch sizes; observed 4x6.9 GB OOM at N=30, B=512).  ``jax.checkpoint``
        trades ~1 extra forward recompute for O(carry) memory per step.

        The sweep outputs themselves are only (B,) per step, so they are
        *saved* (``checkpoint_name`` + save_only policy): the backward pass
        re-runs the cheap elementwise step math but NOT the expensive sweep
        forward."""
        if not self.remat:
            return body
        policy = jax.checkpoint_policies.save_only_these_names("gam", "comp")
        return jax.checkpoint(body, policy=policy)

    def build_loss(self, batch: int) -> Callable[[Params, jax.Array], jax.Array]:
        """Return the pure loss closure for a static batch size."""
        if self.adjoint and self.scheme != "global":
            import warnings

            warnings.warn(f"adjoint=True is only implemented for the global "
                          f"scheme; scheme={self.scheme!r} uses autodiff")
        builder = getattr(self, f"_loss_{self.scheme}")
        return builder(batch)

    # --- global -------------------------------------------------------------
    def _adjoint_ok(self) -> bool:
        return (self._hoist_active() and self.hoist_interp == "piecewise"
                and self.jump_diff and self.hoist_z
                and self._price_collocated() and self._use_gam_net_flag
                and self.scheme == "global")

    def _loss_global_adjoint(self, batch):
        from deepfbsdejsolvers_tpu.solvers.adjoint import (
            make_global_adjoint_rollout)

        model, N = self.model, self.model.N
        apply_gam = lambda gp, i, x, j: self._apply(
            gp, self._gamma_inputs(i, x, j))[..., 0]
        roll = make_global_adjoint_rollout(model, apply_gam)

        def loss(params, key):
            noise = self._prenoise(key, batch)
            tables = self._hoist_tables(params, noise)
            x_n, y_n = roll(params["gam"], params["uz"]["y0"],
                            {k: tables[k] for k in
                             ("cc", "pc", "zc", "lo", "hi")},
                            noise[0][:N], noise[1][:N])
            return jnp.mean(jnp.square(y_n - model.payoff(x_n)))

        return loss

    def _loss_global(self, batch):
        model, N, dt = self.model, self.model.N, self.model.dt
        if self.adjoint:
            if self._adjoint_ok():
                return self._loss_global_adjoint(batch)
            import warnings

            warnings.warn(
                "adjoint=True requires the fully hoisted piecewise global "
                "jump-diffusion path (hoist=True, hoist_interp='piecewise', "
                "hoist_z=True, collocated price); falling back to autodiff")

        def loss(params, key):
            x = model.init_x(batch)
            y0 = params["uz" if self.jump_diff else "gam"]["y0"]
            y = y0 * jnp.ones((batch,), jnp.float32)
            noise = self._prenoise(key, batch)
            xs = self._scan_xs(params, noise)

            def body(carry, xs_i):
                x, y = carry
                i, dw, j = xs_i["i"], xs_i["dw"], xs_i["j"]
                gam, comp = self._heads_gamma_comp(params, xs_i, x, j)
                y = y - dt * model.f(y) + gam - comp
                if self.jump_diff:
                    if "zc" in xs_i:
                        z = self._table_eval(xs_i["zc"], x, xs_i["lo"],
                                             xs_i["hi"])
                    else:
                        z = self._uz(params, i, x)[..., 0]
                    y = y + z * dw
                x = self._fstep(i, x, dw, j, y,
                                price=self._step_price(xs_i, x))
                return (x, y), None

            (x, y), _ = self._scan(body, (x, y), xs, N)
            return jnp.mean(jnp.square(y - model.payoff(x)))

        return loss

    # --- multistep (1, 2, and the Y-only regression) --------------------------
    def _multistep_core(self, batch, with_heads: bool):
        model, N, dt = self.model, self.model.N, self.model.dt

        def loss(params, key):
            x = model.init_x(batch)
            noise = self._prenoise(key, batch)
            xs = self._scan_xs(params, noise) if with_heads else {
                "i": jnp.arange(N), "dw": noise[0], "j": noise[1],
                "km": noise[2]}

            def body(x, xs_i):
                i, dw, j = xs_i["i"], xs_i["dw"], xs_i["j"]
                out = self._uz(params, i, x)
                y = out[..., 0]
                to_add = -dt * model.f(y)
                if with_heads:
                    gam, comp = self._heads_gamma_comp(params, xs_i, x, j)
                    to_add = to_add + gam - comp
                    if self.jump_diff:
                        to_add = to_add + out[..., 1] * dw
                x = self._fstep(i, x, dw, j, y,
                                price=self._step_price(xs_i, x))
                return x, (y, to_add)

            x, (ys, adds) = self._scan(body, x, xs, N)
            y_final = model.payoff(x)
            fwd = ys + _suffix_sum(adds)           # (N, B)
            # Reference reduction is MEAN over steps: the outer reduce_sum at
            # SolversJumpDiff.py:115 acts on an already-scalar double mean
            # (batch then steps) and is a no-op.  Sumlocal, by contrast,
            # genuinely accumulates per-step means with `+` (:267).
            return jnp.mean(jnp.square(fwd - y_final[None, :]))

        return loss

    def _loss_multistep1(self, batch):
        return self._multistep_core(batch, with_heads=True)

    def _loss_multistep2(self, batch):
        return self._multistep_core(batch, with_heads=True)

    def _loss_multistep_reg(self, batch):
        return self._multistep_core(batch, with_heads=False)

    # --- sumlocal (1, 2, and the Y-only regression) ----------------------------
    def _sumlocal_core(self, batch, with_heads: bool):
        model, N, dt = self.model, self.model.N, self.model.dt

        def heads(params, i, x, j, km):
            out = self._uz(params, i, x)
            y = out[..., 0]
            z = out[..., 1] if (with_heads and self.jump_diff) else jnp.zeros_like(y)
            if with_heads:
                gam, comp = self._gamma_and_compensator(params, i, x, j, km)
            else:
                gam = comp = jnp.zeros_like(y)
            return y, z, gam, comp

        def heads_xs(params, xs_i, x, j):
            out = self._uz(params, xs_i["i"], x)
            y = out[..., 0]
            z = out[..., 1] if (with_heads and self.jump_diff) else jnp.zeros_like(y)
            if with_heads:
                gam, comp = self._heads_gamma_comp(params, xs_i, x, j)
            else:
                gam = comp = jnp.zeros_like(y)
            return y, z, gam, comp

        def loss(params, key):
            x = model.init_x(batch)
            # Row N of the pre-drawn noise serves the pre-loop draws
            # (SolversJumpDiff.py:239-247); rows 0..N-1 feed the scan.
            # Only j_all[N]/km_all[N] are consumed there — dw_all[N] is
            # intentionally never read (the pre-loop heads need a jump and an
            # MC key but no Brownian increment); the uniform (N+1)-row layout
            # keeps the three noise streams aligned by row index.
            dw_all, j_all, km_all = self._prenoise(key, batch, rows=N + 1)
            j = j_all[N]
            # The pre-loop head evaluation at (t=0, X_0) runs the direct
            # (non-hoisted) machinery — it is one step, outside the scan.
            y_prev, z_prev, gam_prev, comp_prev = heads(params, 0, x, j,
                                                        km_all[N])
            # shift_next: the in-scan heads evaluate at state X_{i+1} with
            # time feature i, so the step-i hoisted table must span the
            # x_{i+1} marginal (SolversJumpDiff.py:264-266).
            xs = self._scan_xs(params, (dw_all, j_all, km_all),
                               shift_next=True) if with_heads else {
                "i": jnp.arange(N), "dw": dw_all[:N], "j": j_all[:N],
                "km": km_all[:N]}

            def body(carry, xs_i):
                x, j, y_prev, z_prev, gam_prev, comp_prev = carry
                i, dw, j_next = xs_i["i"], xs_i["dw"], xs_i["j"]
                to_add = dt * model.f(y_prev) - gam_prev + comp_prev
                if with_heads and self.jump_diff:
                    to_add = to_add - z_prev * dw
                # The forward step's drift pricer A(i, X_i) is NOT hoisted
                # here: the hoisted tables span the x_{i+1} marginals.
                x = self._fstep(i, x, dw, j, y_prev)
                # NOTE reference idiosyncrasy: the heads at state X_{i+1} use
                # time feature i, not i+1 (SolversJumpDiff.py:264-266).
                y_net, z_n, gam_n, comp_n = heads_xs(params, xs_i, x, j_next)
                is_last = i == N - 1
                y_next = jnp.where(is_last, model.payoff(x), y_net)
                err = jnp.mean(jnp.square(y_next - y_prev + to_add))
                return (x, j_next, y_next, z_n, gam_n, comp_n), err

            carry = (x, j, y_prev, z_prev, gam_prev, comp_prev)
            _, errs = self._scan(body, carry, xs, N)
            return jnp.sum(errs)

        return loss

    def _loss_sumlocal1(self, batch):
        return self._sumlocal_core(batch, with_heads=True)

    def _loss_sumlocal2(self, batch):
        return self._sumlocal_core(batch, with_heads=True)

    def _loss_sumlocal_reg(self, batch):
        # Regression: toAdd = ±dt·f(YPrev); the jump-diff and pure-jump
        # references differ only by an overall sign inside the square
        # (SolversJumpDiff.py:400,413 vs SolversPureJump.py:370,380).
        return self._sumlocal_core(batch, with_heads=False)

    def warm_start_y0(self, params: Params, key: jax.Array,
                      batch: int = 65536) -> Params:
        """Params with the trainable scalar y0 re-initialized at the
        discounted-payoff MC estimate  e^{-rT} E[g(X_N)]  under the UNcoupled
        dynamics (coupling zeroed, Y fed as 0 — oracle-free).

        The reference inits Y0 from Glorot on a scalar shape (std-1 normal,
        coupledPricing/Networks.py:14); the round-2 gate study measured
        ~1/3 of such draws landing Adam in a spurious negative-Y0 basin of the
        Global scheme.  Global scheme only (the other schemes have no y0)."""
        import dataclasses as dc

        from deepfbsdejsolvers_tpu.models.merton import abs_coupling

        head = "uz" if self.jump_diff else "gam"
        if "y0" not in params.get(head, {}):
            raise ValueError(
                f"scheme {self.scheme!r} has no trainable y0 to warm-start")
        model = dc.replace(self.model, coupling=abs_coupling(0.0))

        @jax.jit
        def payoff_mc(k):
            def body(x, i):
                key_i = jax.random.fold_in(k, i)
                kd, kj = jax.random.split(key_i)
                j = model.sample_jumps(kj, x.shape)
                if self.jump_diff:
                    dw = jnp.sqrt(model.dt) * jax.random.normal(kd, x.shape)
                    return model.step(i, x, dw, j, jnp.zeros_like(x)), None
                return model.step(i, x, j, jnp.zeros_like(x)), None

            x, _ = jax.lax.scan(body, model.init_x(batch),
                                jnp.arange(model.N))
            return jnp.exp(-model.r * model.T) * jnp.mean(model.payoff(x))

        new_head = dict(params[head])
        new_head["y0"] = payoff_mc(key).astype(jnp.float32)
        out = dict(params)
        out[head] = new_head
        return out

    # ------------------------------------------------------------- evaluation
    def y0_estimate(self, params: Params) -> jax.Array:
        """Current Y0: the trainable scalar for global (SolversJumpDiff.py:69),
        else U(0, x0) — the reference's mean over 10^5 *identical* inputs
        X=init(1e5)=x0 (SolversJumpDiff.py:140-141) equals the single eval."""
        if self.scheme == "global":
            return params["uz" if self.jump_diff else "gam"]["y0"]
        x = self.model.init_x(1)
        return self._uz(params, 0, x)[0, 0]

    def simulate_paths(self, params: Params, key: jax.Array, batch: int):
        """Forward-simulate (X, Y) trajectories under the trained policy;
        returns arrays of shape (N+1, B).  Global scheme only (explicit Y)."""
        model, N, dt = self.model, self.model.N, self.model.dt
        x = model.init_x(batch)
        y = (params["uz" if self.jump_diff else "gam"]["y0"]
             * jnp.ones((batch,), jnp.float32))

        noise = self._prenoise(key, batch)

        def body(carry, xs):
            x, y = carry
            i, dw, j, km = xs
            gam, comp = self._gamma_and_compensator(params, i, x, j, km)
            y_n = y - dt * model.f(y) + gam - comp
            if self.jump_diff:
                z = self._uz(params, i, x)[..., 0]
                y_n = y_n + z * dw
            x_n = self._fstep(i, x, dw, j, y_n)
            return (x_n, y_n), (x, y)

        (x, y), (xs, ys) = jax.lax.scan(body, (x, y),
                                        (jnp.arange(N),) + noise)
        xs = jnp.concatenate([xs, x[None]], 0)
        ys = jnp.concatenate([ys, y[None]], 0)
        return xs, ys
