"""Traversal integrity: detect wrong answers, don't serve them (PyTorch
port of ``repro.ft.integrity``; host numpy over the port's engine).

ScalaBFS trusts HBM ECC and its fixed arbiter/apply/scatter pipeline to
deliver correct frontier words; this software reproduction has no such
guarantee — a corrupted plane word or a buggy kernel rung resolves
futures with silently WRONG levels, and the supervisor only catches
faults that raise.  This module closes that gap with a detector taxonomy
layered from cheapest to strongest (see ``INTEGRITY_MODES``):

1. **Device-side statvec invariants** (mode ``invariants``) — the engine
   appends one int32 residue slot to the per-level stats vector
   (``repro_torch.core.vertex_program.SV_CHECK``): popcounts of
   ``frontier & ~seen`` and of dirty pad bits, which are zero on every
   uncorrupted run by construction.  Zero extra syncs.
2. **Host-side protocol checks** (also ``invariants``) — per-level
   discovery popcounts must be positive-then-terminate, cumulative
   discoveries bounded by |V| x planes, final value rows bounded by the
   iteration count with each plane's own root at 0
   (:func:`check_level_rows`, :func:`check_popcount_sequence`).
3. **Sampled witness audit** (mode ``witness``) — for K sampled
   discovered vertices per wave, verify ON DEVICE that some in-neighbor
   sits exactly one level closer (the parent that discovered it).  One
   extra fused reduction riding the run's final fetch; the
   ``host_transfers == iterations + 2`` invariant holds.
4. **Rate-sampled differential audit** (mode ``audit``) — the supervisor
   re-runs a sampled fraction of CLEAN waves through a reference path
   (packed off, or on the CPU kernels off) and compares rows exactly.
   Strongest and costliest; ``audit_rate`` bounds the amortized overhead.

All violations raise :class:`IntegrityError`, which the supervisor
treats as a KERNEL-CLASS transient fault: retry, then demote down the
degradation ladder (``kernels -> torch -> bool-plane`` on the CPU,
``kernels -> bool-plane`` on the card, where the plain torch rung does not
exist; a corrupted kernel rung is the prime suspect, and the bool-plane
rung is the audit reference itself).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bfs_local import INF
from repro_torch.core.vertex_program import INTEGRITY_MODES, IntegrityError

__all__ = [
    "INTEGRITY_MODES", "IntegrityConfig", "IntegrityError",
    "check_level_rows", "check_popcount_sequence",
]


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """Supervisor-level integrity policy (engine + host + audit knobs).

    ``mode`` picks the detector tier; ``witness_k``/``witness_budget``
    size the sampled witness reduction; ``audit_rate`` is the fraction of
    clean waves the ``audit`` tier re-runs through the reference path
    (deterministic given ``seed``, so two supervisors audit the same
    schedule only when seeded alike).
    """

    mode: str = "invariants"
    witness_k: int = 64
    witness_budget: int = 4096
    audit_rate: float = 0.05
    seed: int | None = 0

    def __post_init__(self):
        if self.mode not in INTEGRITY_MODES:
            raise ValueError(
                f"integrity mode must be one of {INTEGRITY_MODES}, "
                f"got {self.mode!r}")
        if not (0.0 <= self.audit_rate <= 1.0):
            raise ValueError(
                f"audit_rate must be in [0, 1], got {self.audit_rate}")


def check_level_rows(rows: np.ndarray, roots: np.ndarray,
                     iterations: int | None = None) -> None:
    """Host-side result validation: every value is INF or in
    ``[0, iterations]`` (``[0, n]`` when the iteration count is unknown,
    e.g. after a bool-plane demotion), and each plane's value at its own
    root is exactly 0.  Raises :class:`IntegrityError`.

    This is the check that catches RESULT corruption — e.g. a bit flip in
    the returned rows after the device run completed — which the
    in-flight statvec invariants cannot see.
    """
    rows = np.asarray(rows)
    roots = np.asarray(roots)
    bound = int(iterations) if iterations is not None else rows.shape[1]
    bad = (rows != int(INF)) & ((rows < 0) | (rows > bound))
    if bad.any():
        b, v = (int(x) for x in np.argwhere(bad)[0])
        raise IntegrityError(
            f"{int(bad.sum())} result values outside [0, {bound}] ∪ "
            f"{{INF}} (first: plane {b}, vertex {v}, value "
            f"{int(rows[b, v])})")
    at_root = rows[np.arange(roots.size), roots]
    if np.any(at_root != 0):
        b = int(np.argwhere(at_root != 0)[0][0])
        raise IntegrityError(
            f"plane {b} lost its root: value[{int(roots[b])}] = "
            f"{int(at_root[b])}, expected 0")


def check_popcount_sequence(pcs) -> None:
    """Per-level discovery popcounts must be positive-then-terminate:
    every level before the last discovers at least one (vertex, plane)
    pair, the final level discovers none, and no count is negative.
    A zero mid-sequence means the loop ran on a drained frontier; a
    negative count is a corrupt statvec.  Raises :class:`IntegrityError`.
    """
    pcs = [int(x) for x in pcs]
    if not pcs:
        raise IntegrityError("empty discovery popcount sequence")
    if any(x < 0 for x in pcs):
        raise IntegrityError(f"negative discovery popcount: {pcs}")
    if pcs[0] <= 0:
        raise IntegrityError(
            f"initial discovery popcount {pcs[0]} <= 0 (roots must seed "
            "their own planes)")
    # body counts (between init and the terminating level) must be > 0
    body = pcs[1:-1] if len(pcs) > 1 else []
    if any(x == 0 for x in body):
        lvl = 1 + body.index(0)
        raise IntegrityError(
            f"discovery popcount hit 0 at level {lvl} but the traversal "
            f"ran {len(pcs) - 1} levels (positive-then-terminate "
            "violated)")
    if len(pcs) > 1 and pcs[-1] != 0:
        raise IntegrityError(
            f"traversal ended with nonzero discovery popcount "
            f"{pcs[-1]} (frontier not drained)")
