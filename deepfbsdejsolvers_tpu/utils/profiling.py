"""Profiling hooks, trace reduction and throughput metering.

The reference's only instrument is ``time.time()`` bracketing of the inner
epoch loop (SolversJumpDiff.py:61-67).  Rebuild per SURVEY.md §5:
``jax.profiler`` trace capture, the reduction of a captured device trace to
busy time and per-scope shares (``scope_weights`` + ``device_time_split``),
plus a paths·steps/sec/chip meter — the BASELINE.json primary metric.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

import jax


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace (TensorBoard/XProf format) around a block.
    No-op when ``logdir`` is None, so call sites can pass the flag through."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_SKIP_OPS = (" parameter(", " constant(", " get-tuple-element(", " tuple(",
             " bitcast(", " broadcast(")
_INSTR = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def scope_weights(hlo_text: str, scope: str) -> Dict[str, float]:
    """Per-instruction share of ``scope`` in a compiled module's HLO text
    (``compiled.as_text()``), for attributing device time to a
    ``jax.named_scope``.

    An instruction that calls a fused computation weighs the fraction of
    that computation's instructions whose ``op_name`` metadata lies inside
    ``scope`` (parameters, constants, tuples, bitcasts and broadcasts not
    counted); any
    other instruction weighs 1 if its own ``op_name`` does, else 0."""
    comps: Dict[str, List[Tuple[str, str]]] = {}
    current: Optional[str] = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            current = line.split()[1 if line.startswith("ENTRY") else 0]
            current = current.lstrip("%")
            comps[current] = []
        elif line.strip() == "}":
            current = None
        elif current is not None:
            m = _INSTR.match(line)
            if m:
                comps[current].append((m.group(1), line))

    # the scope is one path component, possibly wrapped by transformations
    # (".../transpose(jvp(comp_sweep))/dot_general")
    in_scope = re.compile(r"(^|[/(])" + re.escape(scope) + r"($|[/)])")

    def tagged(line: str) -> bool:
        m = _OP_NAME.search(line)
        return bool(m) and bool(in_scope.search(m.group(1)))

    weights: Dict[str, float] = {}
    for instrs in comps.values():
        for name, line in instrs:
            called = _CALLS.search(line)
            body = comps.get(called.group(1), []) if called else []
            counted = [ln for _, ln in body
                       if not any(op in ln for op in _SKIP_OPS)]
            if counted:
                weights[name] = sum(map(tagged, counted)) / len(counted)
            else:
                weights[name] = float(tagged(line))
    return weights


def union_ns(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_time_split(xplane_path: str, weights: Dict[str, float],
                      top: int = 15, plane_prefix: str = "/device:") -> dict:
    """Reduce a ``jax.profiler`` trace of one device to its busy and idle
    time and the share of kernel time inside the scope ``weights`` came
    from (:func:`scope_weights`).

    Events are the stream lines of the first plane named ``plane_prefix...``
    (all its lines if none is a stream line).  An event's HLO instruction is
    its own name when that names one (XLA names a kernel after its fusion,
    "." turned "_", also inside a CUDA-graph command buffer, whose
    ``hlo_op`` stat is just "command_buffer"), else its ``hlo_op`` stat.  Library kernels inside a
    command buffer (cuBLAS) match neither and count as unattributed.  Idle
    share is 1 - busy / window, with busy the union of event intervals and
    window first start to last end."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    planes = [p for p in data.planes if p.name.startswith(plane_prefix)]
    if not planes:
        raise ValueError(f"no {plane_prefix!r} plane in {xplane_path}")
    plane = planes[0]
    lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
    lines = lines or list(plane.lines)
    by_kernel_name = {k.replace(".", "_"): k for k in weights}
    intervals, per_op = [], {}
    kernel_ns = scope_ns = matched = matched_ns = 0.0
    for ln in lines:
        for ev in ln.events:
            dur = float(ev.duration_ns)
            intervals.append((float(ev.start_ns), float(ev.start_ns) + dur))
            op = by_kernel_name.get(ev.name.replace(".", "_"))
            if op is None:
                op = dict(ev.stats).get("hlo_op")
                if op not in weights:
                    op = ev.name
            kernel_ns += dur
            per_op[op] = per_op.get(op, 0.0) + dur
            if op in weights:
                matched += 1
                matched_ns += dur
                scope_ns += dur * weights[op]
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0.0)
    busy = union_ns(intervals)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "plane": plane.name, "lines": [ln.name for ln in lines],
        "events": len(intervals), "events_matched_to_hlo": int(matched),
        "unattributed_ns": kernel_ns - matched_ns,
        "window_ns": window, "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else float("nan"),
        "kernel_ns": kernel_ns, "scope_ns": scope_ns,
        "scope_share_of_kernel_time": (scope_ns / kernel_ns
                                       if kernel_ns else float("nan")),
        "top_ops_ns": ranked,
        "ops_ns": per_op,
    }


class ThroughputMeter:
    """Measures paths·steps/sec (/chip) over explicit mark() windows.

    Usage::

        meter = ThroughputMeter(paths_per_step=batch, sde_steps=model.N)
        meter.start()
        ... run k train steps, block_until_ready ...
        rate = meter.mark(k)["paths_steps_per_sec"]
    """

    def __init__(self, paths_per_step: int, sde_steps: int, n_chips: int = 1):
        self.paths_per_step = paths_per_step
        self.sde_steps = sde_steps
        self.n_chips = max(1, n_chips)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def mark(self, n_train_steps: int) -> dict:
        assert self._t0 is not None, "call start() first"
        elapsed = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        work = self.paths_per_step * self.sde_steps * n_train_steps
        return {
            "elapsed_s": elapsed,
            "train_steps_per_sec": n_train_steps / elapsed,
            "paths_steps_per_sec": work / elapsed,
            "paths_steps_per_sec_per_chip": work / elapsed / self.n_chips,
        }
