"""Chunked time scan — the shared loop-structure optimization.

``chunked_scan`` replaces a flat N-step ``lax.scan`` with an outer scan over
N/k chunks of k fully-unrolled steps.  The unrolled inner steps index their
xs rows statically — no per-step dynamic_slice/dynamic_update_slice on the
big (N, B) pre-drawn noise buffers — and XLA fuses the elementwise chain
across the k steps, halving (at k=2) the while-loop iteration count.  The
math is identical to the flat scan: same xs rows in the same order, same
carry semantics; loss and gradients match to float-exactness (tested for
both the pricing and MFG solver families).

Chunk sizes are tuned per config with scripts/scan_chunk_ab.py.  The
reference has no
analogue — its time loop is a Python ``for`` unrolled into one TF graph
(coupledPricing/SolversJumpDiff.py:29-43).

Rematerialization composes at chunk granularity: the chunk function is
checkpointed as a unit, so backward memory is O(chunk * carry) instead of
O(N * activations) while the forward recompute stays one chunk deep.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax

__all__ = ["chunked_scan"]


def chunked_scan(
    body: Callable,
    carry: Any,
    xs: Any,
    length: int,
    chunk: int = 0,
    remat: bool = False,
    policy: Optional[Callable] = None,
):
    """``lax.scan(body, carry, xs)`` with optional chunk-unrolling.

    chunk <= 1 (or >= length): flat scan; ``body`` is checkpointed per step
    when ``remat`` is set (with ``policy`` if given).  Otherwise the largest
    divisor of ``length`` that is <= ``chunk`` is used as the chunk size
    (non-divisor fallback, so e.g. chunk=2 on an odd N degrades to flat),
    and the checkpoint wraps each chunk instead of each step.
    """
    k = chunk
    if k and 1 < k < length:
        while length % k:
            k -= 1

    def _ckpt(fn):
        if not remat:
            return fn
        if policy is not None:
            return jax.checkpoint(fn, policy=policy)
        return jax.checkpoint(fn)

    if not k or k <= 1 or k >= length:
        return jax.lax.scan(_ckpt(body), carry, xs, length=length)

    nch = length // k
    xs_r = jax.tree.map(lambda a: a.reshape((nch, k) + a.shape[1:]), xs)

    def chunk_fn(c, xc):
        # Explicit lengths keep the xs=None (length-only) lax.scan idiom
        # working — tree.map over None yields None, which carries no length.
        return jax.lax.scan(body, c, xc, length=k, unroll=True)

    carry, ys = jax.lax.scan(_ckpt(chunk_fn), carry, xs_r, length=nch)
    ys = jax.tree.map(lambda a: a.reshape((length,) + a.shape[2:]), ys)
    return carry, ys
