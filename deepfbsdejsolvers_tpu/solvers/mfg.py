"""MFG smart-grid solver suite — 5 schemes x couplage ON/OFF.

Rebuilds coupledMFG/MFGSolvers.py as one parametrized ``lax.scan`` family.
Two BSDEs are trained jointly on the coupled forward system:

* the *projected* one  dĥY = -f(ĥS) dt + ĥZ0 dW0 + ĥΓ (dN - λdt)   (hat net,
  inputs (t, hQ, hS, R) — MFGSolvers.py:40)
* the *full* one       dY  = -f(S) dt + Z0 dW0 + Γ (dN - λdt) + Z dW  (full
  net, inputs (t, Q, S, hQ, hS, R) — :41)

The Cox compensator λ·dt is analytic (MFGModel.py:54) — no MC sweep here.
``couplage='ON'`` trains both nets on the summed loss in one optimizer;
``'OFF'`` trains the hat net first, then the full net with the hat frozen
(MFGSolvers.py:79-115).  The hat loss depends only on hat params (hS evolves
through α̂(hY) alone), so the OFF schedule is well-posed.

Schemes (output dims per mainMFGComparison.py:119-124):

  scheme         reference class                    hat/full head outputs
  -------------  ---------------------------------  --------------------------
  global         SolverGlobalFBSDE:17        (ĥZ0,ĥΓ)+Y0_hat / (Z0,Γ,Z)+Y0
  multistep      SolverMultiStepFBSDE:180    (ĥY,ĥZ0,ĥΓ) / (Y,Z0,Γ,Z)
  sumlocal       SolverSumLocalFBSDE:321     (ĥY,ĥZ0,ĥΓ) / (Y,Z0,Γ,Z)
  sumlocal_reg   SolverGlobalSumLocalReg:463 (ĥY) / (Y)
  multistep_reg  SolverGlobalMultiStepReg:608 (ĥY) / (Y)

Reference defect fixed, not replicated: in couplage='OFF' the reference
reports Y0 by calling the *hat* net on the *full* state (MFGSolvers.py:291,431)
— here the pairing is corrected (hat net on projected state, full net on full
state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deepfbsdejsolvers_tpu.models.mfg_smart_grid import MFGState, SmartGridMFGModel
from deepfbsdejsolvers_tpu.nets.mlp import MLPSpec, get_activation, init_mlp, mlp_apply
from deepfbsdejsolvers_tpu.solvers.train import fit

MFG_SCHEMES = ("global", "multistep", "sumlocal", "sumlocal_reg", "multistep_reg")


def _suffix_sum(x: jax.Array) -> jax.Array:
    return jnp.cumsum(x[::-1], axis=0)[::-1]


@dataclasses.dataclass(frozen=True)
class MFGSolver:
    """Builds pure losses over params = {'hat': ..., 'full': ...}."""

    model: SmartGridMFGModel
    scheme: str
    hidden_hat: Tuple[int, ...] = (20, 20)
    hidden: Tuple[int, ...] = (22, 22)
    activation_hat: str = "tanh"
    activation: str = "tanh"
    remat: bool = True
    # bfloat16 matmuls for the two heads (f32 params/carries) — opt-in
    compute_dtype: str | None = None
    # Chunk the time scan (ops/scan.py): outer scan over N/k chunks of k
    # fully-unrolled steps, rematerialized per chunk.  Same math as the flat
    # scan (same xs rows, same RNG stream); tuned per config with
    # scripts/scan_chunk_ab.py.  0 = flat.
    scan_chunk: int = 0
    # Evaluate both per-step heads through ONE block-diagonal MLP chain
    # (see _make_pair) — halves the per-step dot count; same math (loss
    # bit-exact, grads ~8e-8 rel).  Measured slower on the accelerator the
    # library was first tuned on, not yet re-measured on the GPU.  Kept as
    # a tested opt-in instrument, like adjoint / hoist_gamma.
    fuse_heads: bool = False

    def __post_init__(self):
        if self.scheme not in MFG_SCHEMES:
            raise ValueError(f"scheme must be one of {MFG_SCHEMES}, got {self.scheme!r}")
        object.__setattr__(self, "_act_hat", get_activation(self.activation_hat))
        object.__setattr__(self, "_act", get_activation(self.activation))
        import jax.numpy as _jnp

        object.__setattr__(self, "_compute_dtype",
                           _jnp.dtype(self.compute_dtype)
                           if self.compute_dtype else None)

    # ---------------------------------------------------------------- nets
    def head_dims(self) -> Tuple[int, int]:
        if self.scheme == "global":
            return 2, 3
        if self.scheme in ("multistep", "sumlocal"):
            return 3, 4
        return 1, 1

    def net_specs(self) -> Dict[str, MLPSpec]:
        d_hat, d_full = self.head_dims()
        with_y0 = self.scheme == "global"  # coupledMFG/Networks.py:13-15,30-32
        return {
            "hat": MLPSpec(4, self.hidden_hat, d_hat, self.activation_hat,
                           with_y0=with_y0),
            "full": MLPSpec(6, self.hidden, d_full, self.activation,
                            with_y0=with_y0),
        }

    def init_params(self, key: jax.Array) -> Dict[str, dict]:
        k1, k2 = jax.random.split(key)
        specs = self.net_specs()
        return {"hat": init_mlp(k1, specs["hat"]), "full": init_mlp(k2, specs["full"])}

    def _hat(self, params, state: MFGState) -> jax.Array:
        return mlp_apply(params["hat"], self.model.projected_features(state),
                         self._act_hat, compute_dtype=self._compute_dtype)

    def _full(self, params, state: MFGState) -> jax.Array:
        return mlp_apply(params["full"], self.model.all_features(state),
                         self._act, compute_dtype=self._compute_dtype)

    def _can_fuse_heads(self) -> bool:
        """Block-diagonal head fusion requires matching depth + activation."""
        return (self.fuse_heads
                and self.activation_hat == self.activation
                and len(self.hidden_hat) == len(self.hidden))

    def _fused_weights(self, params):
        """Per-layer block-diag(W_hat, W_full) + concatenated biases.

        Built once per loss call, OUTSIDE the scan (step-independent).  The
        merged chain costs ONE dot per layer where the split heads cost two —
        the per-step dot count halves.  The off-diagonal zero blocks
        contribute exact-zero products, so the loss is bit-exact."""
        Ws, bs = [], []
        for Wh, bh, Wf, bf in zip(params["hat"]["W"], params["hat"]["b"],
                                  params["full"]["W"], params["full"]["b"]):
            W = jnp.zeros((Wh.shape[0] + Wf.shape[0],
                           Wh.shape[1] + Wf.shape[1]), Wh.dtype)
            W = W.at[:Wh.shape[0], :Wh.shape[1]].set(Wh)
            W = W.at[Wh.shape[0]:, Wh.shape[1]:].set(Wf)
            Ws.append(W)
            bs.append(jnp.concatenate([bh, bf], -1))
        return {"W": Ws, "b": bs}

    def _pair_features(self, state: MFGState) -> jax.Array:
        """Both heads' inputs side by side — delegates to the model's own
        feature builders so the fused path can never drift from the split
        path if the feature layout changes."""
        return jnp.concatenate([self.model.projected_features(state),
                                self.model.all_features(state)], -1)

    def _make_pair(self, params):
        """Returns pair_heads(state) -> (h_out, f_out).

        Fused path (default): one block-diagonal MLP chain evaluates both
        heads per step, halving the per-step thin dot_generals.  Falls back to
        the two separate ``mlp_apply`` calls when depths/activations differ.
        """
        if not self._can_fuse_heads():
            return lambda state: (self._hat(params, state),
                                  self._full(params, state))
        fused = self._fused_weights(params)
        d_hat = self.head_dims()[0]

        def pair_heads(state):
            out = mlp_apply(fused, self._pair_features(state), self._act,
                            compute_dtype=self._compute_dtype)
            return out[..., :d_hat], out[..., d_hat:]

        return pair_heads

    # ---------------------------------------------------------------- noise
    def _prenoise(self, key, batch, rows=None):
        """All rollout noise drawn in batched kernels before the scan (the
        pricing-side rationale applies: per-step RNG kernels are launch
        overhead + backward-pass recompute under remat).  The Cox dN itself
        depends on the state and cannot be pre-drawn — its underlying
        uniforms/normals are (icdf mode); exact mode keeps per-step subkeys
        for jax.random.poisson's state-dependent rates."""
        rows = self.model.N if rows is None else rows
        k0, k1, kn = jax.random.split(key, 3)
        sdt = np.sqrt(self.model.dt)
        dw0 = sdt * jax.random.normal(k0, (rows, batch), jnp.float32)
        dw = sdt * jax.random.normal(k1, (rows, batch), jnp.float32)
        if self.model.jump_sampler == "icdf":
            ku, kz = jax.random.split(kn)
            jn = (jax.random.uniform(ku, (rows, batch), jnp.float32),
                  jax.random.normal(kz, (rows, batch), jnp.float32))
        else:
            jn = jax.random.split(kn, rows)
        return dw0, dw, jn

    def _dn(self, jn_i, state):
        """Per-step (dN, compensator) from one row of the pre-drawn noise."""
        if self.model.jump_sampler == "icdf":
            u, z = jn_i
            return self.model.sample_dN_from(u, z, state)
        return self.model.sample_dN(jn_i, state)

    def _maybe_remat(self, body):
        return jax.checkpoint(body) if self.remat else body

    def _scan(self, body, carry, xs, length):
        """Training-loss time scan, chunked when ``scan_chunk`` is set."""
        from ..ops.scan import chunked_scan

        return chunked_scan(body, carry, xs, length, self.scan_chunk,
                            remat=self.remat)

    # ------------------------------------------------------------- rollouts
    def build_pair_loss(self, batch: int) -> Callable:
        """Returns loss(params, key) -> (loss_hat, loss_full)."""
        builder = getattr(self, f"_loss_{self.scheme}")
        return builder(batch)

    def build_losses(self, batch: int) -> Dict[str, Callable]:
        """'hat' / 'full' / 'coupled' scalar losses (MFGSolvers.py:45-47)."""
        pair = self.build_pair_loss(batch)
        return {
            "hat": lambda p, k: pair(p, k)[0],
            "full": lambda p, k: pair(p, k)[1],
            "coupled": lambda p, k: sum(pair(p, k)),
        }

    def _loss_global(self, batch):
        model, N, dt = self.model, self.model.N, self.model.dt

        def pair(params, key):
            state = model.init_state(batch)
            ones = jnp.ones((batch,), jnp.float32)
            h_y = params["hat"]["y0"] * ones
            y = params["full"]["y0"] * ones

            noise = self._prenoise(key, batch)
            pair_heads = self._make_pair(params)

            def body(carry, xs):
                state, h_y, y = carry
                i, dw0, dw, jn = xs
                h_out, f_out = pair_heads(state)
                hz0, hgam = h_out[..., 0], h_out[..., 1]
                z0, gam, z = f_out[..., 0], f_out[..., 1], f_out[..., 2]
                dn, compens = self._dn(jn, state)
                dpi = dn - compens
                h_y_next = h_y - dt * model.f(state.hS) + hz0 * dw0 + hgam * dpi
                y_next = (y - dt * model.f(state.S) + z0 * dw0 + gam * dpi
                          + z * dw)
                state = model.step(state, dw0, dw, dn, h_y, y)
                return (state, h_y_next, y_next), None

            (state, h_y, y), _ = self._scan(
                body, (state, h_y, y), (jnp.arange(N),) + noise, N)
            loss_hat = jnp.mean(jnp.square(h_y - model.g(state.hS)))
            loss_full = jnp.mean(jnp.square(y - model.g(state.S)))
            return loss_hat, loss_full

        return pair

    def _multistep_pair(self, batch, with_heads: bool):
        model, N, dt = self.model, self.model.N, self.model.dt

        def pair(params, key):
            state = model.init_state(batch)

            noise = self._prenoise(key, batch)
            pair_heads = self._make_pair(params)

            def body(state, xs):
                i, dw0, dw, jn = xs
                h_out, f_out = pair_heads(state)
                h_y, y = h_out[..., 0], f_out[..., 0]
                dn, compens = self._dn(jn, state)
                to_add_hat = -dt * model.f(state.hS)
                to_add = -dt * model.f(state.S)
                if with_heads:
                    dpi = dn - compens
                    to_add_hat = to_add_hat + h_out[..., 1] * dw0 + h_out[..., 2] * dpi
                    to_add = (to_add + f_out[..., 1] * dw0 + f_out[..., 2] * dpi
                              + f_out[..., 3] * dw)
                state = model.step(state, dw0, dw, dn, h_y, y)
                return state, (h_y, y, to_add_hat, to_add)

            state, (h_ys, ys, adds_hat, adds) = self._scan(
                body, state, (jnp.arange(N),) + noise, N)
            yf_hat = model.g(state.hS)
            yf = model.g(state.S)
            fwd_hat = h_ys + _suffix_sum(adds_hat)
            fwd = ys + _suffix_sum(adds)
            # MEAN over steps, matching MFGSolvers.py:220-223 (the reduce_sum
            # wraps an already-scalar double mean — see the pricing twin).
            loss_hat = jnp.mean(jnp.square(fwd_hat - yf_hat[None]))
            loss_full = jnp.mean(jnp.square(fwd - yf[None]))
            return loss_hat, loss_full

        return pair

    def _loss_multistep(self, batch):
        return self._multistep_pair(batch, with_heads=True)

    def _loss_multistep_reg(self, batch):
        return self._multistep_pair(batch, with_heads=False)

    def _loss_sumlocal(self, batch):
        return self._sumlocal_core(batch, with_heads=True)

    def _loss_sumlocal_reg(self, batch):
        return self._sumlocal_core(batch, with_heads=False)

    def _sumlocal_core(self, batch, with_heads: bool):
        model, N, dt = self.model, self.model.N, self.model.dt

        def pair(params, key):
            state = model.init_state(batch)
            pair_heads = self._make_pair(params)
            h_out, f_out = pair_heads(state)

            noise = self._prenoise(key, batch)

            def body(carry, xs):
                state, h_out, f_out = carry
                i, dw0, dw, jn = xs
                h_y_prev, y_prev = h_out[..., 0], f_out[..., 0]
                dn, compens = self._dn(jn, state)
                to_add_hat = dt * model.f(state.hS)
                to_add = dt * model.f(state.S)
                if with_heads:
                    dpi = dn - compens
                    to_add_hat = to_add_hat - h_out[..., 1] * dw0 - h_out[..., 2] * dpi
                    to_add = (to_add - f_out[..., 1] * dw0 - f_out[..., 2] * dpi
                              - f_out[..., 3] * dw)
                state = model.step(state, dw0, dw, dn, h_y_prev, y_prev)
                h_out_n, f_out_n = pair_heads(state)
                is_last = i == N - 1
                h_y_next = jnp.where(is_last, model.g(state.hS), h_out_n[..., 0])
                y_next = jnp.where(is_last, model.g(state.S), f_out_n[..., 0])
                err_hat = jnp.mean(jnp.square(h_y_next - h_y_prev + to_add_hat))
                err = jnp.mean(jnp.square(y_next - y_prev + to_add))
                h_out_n = h_out_n.at[..., 0].set(h_y_next)
                f_out_n = f_out_n.at[..., 0].set(y_next)
                return (state, h_out_n, f_out_n), (err_hat, err)

            _, (errs_hat, errs) = self._scan(
                body, (state, h_out, f_out), (jnp.arange(N),) + noise, N)
            return jnp.sum(errs_hat), jnp.sum(errs)

        return pair

    # ------------------------------------------------------------- training
    def warm_start_y0(self, params: dict, key: jax.Array, batch: int = 16384,
                      n_picard: int = 24) -> dict:
        """Params with the two trainable scalars re-initialized at
        fictitious-play-averaged Picard MC estimates of the BSDE initial
        values

            Y0_hat ≈ E[g(hS_N) + Σ_i dt·f(hS_i)],   Y0 ≈ E[g(S_N) + Σ_i dt·f(S_i)]

        — the MFG twin of ``PricingSolver.warm_start_y0``.  The reference
        inits Y0_hat/Y0 from Glorot on a scalar shape (std-1 normal,
        coupledMFG/Networks.py:15,32), i.e. at ~0, while the comparison
        config's consensus initial values sit at ≈ −46: at the reference's
        own budget (20,000 Adam steps × lr 1e-3) the scalars' total travel
        is bounded at ≈ 20 from init, so the Global scheme cannot reach the
        four-method consensus band at all (round-4 mfg-compare study).

        Unlike the pricing case there is no "uncoupled" limit to exploit —
        the forward controls α̂(hY), α(hY, Y) depend on the adjoint states
        intrinsically (MFGModel.py:83-89) — so the estimate Picard-iterates
        on deterministic per-step mean-Y tables: roll the forward system
        feeding hY_i/Y_i from the previous iterate's (N+1,) tables, rebuild
        the tables as  table[i] = E[g(X_N)] + dt·Σ_{s≥i} E[f(X_s)], repeat.
        The noise is frozen across iterates.  The raw Picard map's
        feedback-loop gain (hY → α̂ → S → g(hS) → hY) is ≈ −4.4 at the
        comparison config, so the plain iteration DIVERGES geometrically;
        the iterates are therefore fictitious-play averaged —
        tab_{k+1} = tab_k + (Φ(tab_k) − tab_k)/(k+1), the standard MFG
        fixed-point damping — whose error multiplier (k+λ)/(k+1) contracts
        for ANY finite negative gain without a tuned relaxation factor
        (measured: −48.7 after 24 iterates vs the −44.8…−47.5 four-method
        consensus).  Global scheme only (the other schemes have no
        trainable y0)."""
        if self.scheme != "global":
            raise ValueError(
                f"scheme {self.scheme!r} has no trainable y0 to warm-start")
        model, N, dt = self.model, self.model.N, self.model.dt
        noise = self._prenoise(key, batch)

        @jax.jit
        def picard(hy_tab, y_tab):
            state = model.init_state(batch)

            def body(state, xs):
                i, dw0, dw, jn = xs
                fh = jnp.mean(model.f(state.hS))
                ff = jnp.mean(model.f(state.S))
                dn, _ = self._dn(jn, state)
                ones = jnp.ones_like(state.hQ)
                state = model.step(state, dw0, dw, dn,
                                   hy_tab[i] * ones, y_tab[i] * ones)
                return state, (fh, ff)

            state, (mfh, mff) = jax.lax.scan(
                body, state, (jnp.arange(N),) + noise)
            gh = jnp.mean(model.g(state.hS))
            gf = jnp.mean(model.g(state.S))
            hy_new = jnp.concatenate([gh + dt * _suffix_sum(mfh), gh[None]])
            y_new = jnp.concatenate([gf + dt * _suffix_sum(mff), gf[None]])
            return hy_new, y_new

        hy_tab = jnp.zeros((N + 1,), jnp.float32)
        y_tab = jnp.zeros((N + 1,), jnp.float32)
        for k in range(1, n_picard + 1):
            hy_new, y_new = picard(hy_tab, y_tab)
            w = 1.0 / (k + 1)  # fictitious-play damping (see docstring)
            hy_tab = (1.0 - w) * hy_tab + w * hy_new
            y_tab = (1.0 - w) * y_tab + w * y_new

        out = {"hat": dict(params["hat"]), "full": dict(params["full"])}
        out["hat"]["y0"] = hy_tab[0].astype(jnp.float32)
        out["full"]["y0"] = y_tab[0].astype(jnp.float32)
        return out

    def y0_estimates(self, params) -> Tuple[jax.Array, jax.Array]:
        """(Y0_hat, Y0): trainable scalars for global (MFGSolvers.py:88), else
        head values at the initial state (:264-265)."""
        if self.scheme == "global":
            return params["hat"]["y0"], params["full"]["y0"]
        state = self.model.init_state(1)
        return self._hat(params, state)[0, 0], self._full(params, state)[0, 0]

    def train(self, key: jax.Array, batch: int, batch_val: int, num_epoch: int,
              num_epoch_ext: int, lrate: float, couplage: str = "ON",
              verbose: bool = True, on_epoch=None, mesh=None,
              y0_warm_start: bool = False):
        """Mirror of MFGSolvers .train(): returns (listY0_hat, listY0) plus the
        trained params (reference keeps them implicitly in the Keras objects).
        ``on_epoch`` is forwarded to :func:`fit` (metrics/checkpoint hook).
        ``mesh`` switches to the SPMD data-parallel path: ``batch``/
        ``batch_val`` stay the GLOBAL path counts, sharded over the mesh's
        ``data`` axis (ceil per chip).  ``y0_warm_start`` (global scheme only)
        re-initializes the trainable scalars via :meth:`warm_start_y0`."""
        key, k_init = jax.random.split(key)
        params = self.init_params(k_init)
        if y0_warm_start and self.scheme == "global":
            # dedicated key: fit() folds per-epoch constants into `key`, so a
            # fold_in(key, const) here could alias a training/validation batch
            key, k_warm = jax.random.split(key)
            params = self.warm_start_y0(params, k_warm)
            if verbose:
                print(f"warm-started Y0_hat={float(params['hat']['y0']):.4f} "
                      f"Y0={float(params['full']['y0']):.4f}")
        if mesh is not None:
            from deepfbsdejsolvers_tpu.parallel.data_parallel import per_shard_batch

            batch = per_shard_batch(batch, mesh)
            batch_val = per_shard_batch(batch_val, mesh)
        pair_train = self.build_pair_loss(batch)
        pair_val = self.build_pair_loss(batch_val)

        hist_hat: list = []
        hist_full: list = []
        if couplage == "ON":
            res = fit(
                loss_fn=lambda p, k: sum(pair_train(p, k)),
                params=params, key=key, lrate=lrate, num_epoch=num_epoch,
                num_epoch_ext=num_epoch_ext,
                val_loss_fn=lambda p, k: sum(pair_val(p, k)),
                y0_fn=self.y0_estimates, verbose=verbose, on_epoch=on_epoch,
                mesh=mesh,
            )
            params = res.params
            hist_hat = [y[0] for y in res.y0_history]
            hist_full = [y[1] for y in res.y0_history]
            loss_hist = res.loss_history
        else:
            # Phase 1: hat net alone on the hat loss (MFGSolvers.py:93-103).
            full_frozen = params["full"]

            def loss_hat_only(p_hat, k):
                return pair_train({"hat": p_hat, "full": full_frozen}, k)[0]

            res1 = fit(loss_fn=loss_hat_only, params=params["hat"], key=key,
                       lrate=lrate, num_epoch=num_epoch,
                       num_epoch_ext=num_epoch_ext,
                       val_loss_fn=lambda p, k: pair_val(
                           {"hat": p, "full": full_frozen}, k)[0],
                       y0_fn=lambda p: self.y0_estimates(
                           {"hat": p, "full": full_frozen})[0],
                       verbose=verbose, on_epoch=on_epoch, mesh=mesh)
            params = {"hat": res1.params, "full": params["full"]}
            hat_frozen = params["hat"]

            # Phase 2: full net with hat frozen (MFGSolvers.py:105-115).
            def loss_full_only(p_full, k):
                return pair_train({"hat": hat_frozen, "full": p_full}, k)[1]

            key2 = jax.random.fold_in(key, 1)
            res2 = fit(loss_fn=loss_full_only, params=params["full"], key=key2,
                       lrate=lrate, num_epoch=num_epoch,
                       num_epoch_ext=num_epoch_ext,
                       val_loss_fn=lambda p, k: pair_val(
                           {"hat": hat_frozen, "full": p}, k)[1],
                       y0_fn=lambda p: self.y0_estimates(
                           {"hat": hat_frozen, "full": p})[1],
                       verbose=verbose, on_epoch=on_epoch, mesh=mesh)
            params = {"hat": hat_frozen, "full": res2.params}
            hist_hat = res1.y0_history
            hist_full = res2.y0_history
            loss_hist = res1.loss_history + res2.loss_history

        return MFGTrainResult(params=params, y0_hat_history=hist_hat,
                              y0_history=hist_full, loss_history=loss_hist)

    # ------------------------------------------------------------ evaluators
    def simulate_global_err(self, params, key: jax.Array, batch: int):
        """Expected running+terminal cost of both BSDEs plus terminal mismatch
        (MFGSolvers.py:118-146; head-feedback variant :296-318 for non-global
        schemes).  Returns (cost_hat, cost, err)."""
        model, N, dt = self.model, self.model.N, self.model.dt
        state = model.init_state(batch)
        is_global = self.scheme == "global"
        ones = jnp.ones((batch,), jnp.float32)
        if is_global:
            h_y = params["hat"]["y0"] * ones
            y = params["full"]["y0"] * ones
        else:
            h_y = self._hat(params, state)[..., 0]
            y = self._full(params, state)[..., 0]

        noise = self._prenoise(key, batch)

        def body(carry, xs):
            state, h_y, y, cost_hat, cost = carry
            i, dw0, dw, jn = xs
            cost_hat = cost_hat + dt * model.f(state.hS)
            cost = cost + dt * model.f(state.S)
            dn, compens = self._dn(jn, state)
            if is_global:
                h_out = self._hat(params, state)
                f_out = self._full(params, state)
                dpi = dn - compens
                h_y_next = (h_y - dt * model.f(state.hS)
                            + h_out[..., 0] * dw0 + h_out[..., 1] * dpi)
                y_next = (y - dt * model.f(state.S) + f_out[..., 0] * dw0
                          + f_out[..., 1] * dpi + f_out[..., 2] * dw)
            state = model.step(state, dw0, dw, dn, h_y, y)
            if not is_global:
                h_y_next = self._hat(params, state)[..., 0]
                y_next = self._full(params, state)[..., 0]
            return (state, h_y_next, y_next, cost_hat, cost), None

        zeros = jnp.zeros((batch,), jnp.float32)
        (state, h_y, y, cost_hat, cost), _ = jax.lax.scan(
            body, (state, h_y, y, zeros, zeros), (jnp.arange(N),) + noise)
        cost_hat = cost_hat + model.g(state.hS)
        cost = cost + model.g(state.S)
        err = (jnp.mean(jnp.square(h_y - model.g(state.hS)))
               + jnp.mean(jnp.square(y - model.g(state.S))))
        return jnp.mean(cost_hat), jnp.mean(cost), err

    def follow_s(self, params, key: jax.Array, batch: int):
        """Mean/std trajectories of hS and S under the trained policy
        (MFGSolvers.py:148-178).  Returns 4 arrays of shape (N+1,)."""
        model, N, dt = self.model, self.model.N, self.model.dt
        state = model.init_state(batch)
        ones = jnp.ones((batch,), jnp.float32)
        if self.scheme == "global":
            h_y = params["hat"]["y0"] * ones
            y = params["full"]["y0"] * ones
        else:
            h_y = self._hat(params, state)[..., 0]
            y = self._full(params, state)[..., 0]

        noise = self._prenoise(key, batch)

        def body(carry, xs):
            state, h_y, y = carry
            i, dw0, dw, jn = xs
            stats = (jnp.mean(state.hS), jnp.std(state.hS),
                     jnp.mean(state.S), jnp.std(state.S))
            dn, compens = self._dn(jn, state)
            if self.scheme == "global":
                h_out = self._hat(params, state)
                f_out = self._full(params, state)
                dpi = dn - compens
                h_y_next = (h_y - dt * model.f(state.hS)
                            + h_out[..., 0] * dw0 + h_out[..., 1] * dpi)
                y_next = (y - dt * model.f(state.S) + f_out[..., 0] * dw0
                          + f_out[..., 1] * dpi + f_out[..., 2] * dw)
            state = model.step(state, dw0, dw, dn, h_y, y)
            if self.scheme != "global":
                h_y_next = self._hat(params, state)[..., 0]
                y_next = self._full(params, state)[..., 0]
            return (state, h_y_next, y_next), stats

        (state, h_y, y), stats = jax.lax.scan(body, (state, h_y, y),
                                              (jnp.arange(N),) + noise)
        last = (jnp.mean(state.hS), jnp.std(state.hS),
                jnp.mean(state.S), jnp.std(state.S))
        out = [jnp.concatenate([s, l[None]]) for s, l in zip(stats, last)]
        return tuple(out)


@dataclasses.dataclass
class MFGTrainResult:
    params: dict
    y0_hat_history: list
    y0_history: list
    loss_history: list

    def __iter__(self):
        # reference returns (listY0_hat, listY0) — MFGSolvers.py:116
        return iter((self.y0_hat_history, self.y0_history))
