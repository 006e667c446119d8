"""Analytic performance model (paper §V, Eq. 1-7); the port's copy of
``repro.core.perf_model``.

Reproduces Fig. 7 exactly with the paper's U280 constants and
re-parameterizes the same model for one NVIDIA H100 (the port's target), so
the roofline of a step program can be read beside it.

Also implements the multi-layer crossbar resource model (Eq. 7) and the
FIFO-count comparison of §IV-D (full vs k-layer crossbar).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.roofline import H100


@dataclasses.dataclass(frozen=True)
class PerfModelConfig:
    """Paper's symbols. Defaults = paper's Fig. 7 setting."""
    s_v_bits: int = 32            # S_v: storage size of a vertex
    freq_hz: float = 100e6        # F: PE clock
    bw_max: float = 13.27e9       # BW_MAX: single-PC physical bandwidth (B/s)


def axi_data_width_bits(n_pe: int, s_v_bits: int = 32) -> int:
    """Eq. 1: DW = 2 * N_pe * S_v (double-pump BRAM: 2 ops/cycle/PE)."""
    return 2 * n_pe * s_v_bits


def pc_bandwidth(n_pe: int, cfg: PerfModelConfig) -> float:
    """Eq. 2: min(DW*F, BW_MAX) in bytes/s."""
    dw_bytes = axi_data_width_bits(n_pe, cfg.s_v_bits) / 8
    return min(dw_bytes * cfg.freq_hz, cfg.bw_max)


def p_nl(n_pe: int, len_nl: float, cfg: PerfModelConfig) -> float:
    """Eq. 3: fraction of PC bandwidth spent on neighbor lists."""
    dw = axi_data_width_bits(n_pe, cfg.s_v_bits)
    return (len_nl * cfg.s_v_bits) / (dw + len_nl * cfg.s_v_bits)


def perf_pg(n_pe: int, len_nl: float, cfg: PerfModelConfig) -> float:
    """Eq. 5: theoretical TEPS of a single processing group."""
    bw_nl = pc_bandwidth(n_pe, cfg) * p_nl(n_pe, len_nl, cfg)
    return bw_nl / (cfg.s_v_bits / 8)


def perf_total(n_pe: int, n_pc: int, len_nl: float,
               cfg: PerfModelConfig | None = None) -> float:
    """Eq. 6: Perf = Perf_pg * N_pc (TEPS)."""
    cfg = cfg or PerfModelConfig()
    return perf_pg(n_pe, len_nl, cfg) * n_pc


def fig7_curves(pe_counts=(1, 2, 4, 8, 16, 32, 64, 128),
                len_nls=(1, 2, 4, 8, 16, 32, 64, 128),
                cfg: PerfModelConfig | None = None):
    """Fig. 7 data: GTEPS per (len_nl curve, n_pe point), single PC."""
    cfg = cfg or PerfModelConfig()
    return {ln: [perf_total(p, 1, ln, cfg) / 1e9 for p in pe_counts]
            for ln in len_nls}


def break_point_pes(cfg: PerfModelConfig | None = None) -> int:
    """Largest power-of-two #PEs whose AXI width still fits the PC's
    physical bandwidth (2*N_pe*S_v*F <= BW_MAX) -- the Fig. 7 peak."""
    cfg = cfg or PerfModelConfig()
    n = cfg.bw_max / (2 * (cfg.s_v_bits / 8) * cfg.freq_hz)
    return 2 ** math.floor(math.log2(n))


# ---------------------------------------------------------------------------
# Crossbar resource model (§IV-D + Eq. 7)
# ---------------------------------------------------------------------------

def full_crossbar_fifos(n: int) -> int:
    return n * n


def multilayer_crossbar_fifos(factors: tuple[int, ...]) -> int:
    """Sum over layers of (N/C_i) * C_i^2 FIFOs, N = prod(C_i)."""
    n = math.prod(factors)
    return sum((n // c) * c * c for c in factors)


def crossbar_lut_constraint(n_pe: int, k: int, r_fifo: float, r_pe: float,
                            r_limit: float) -> bool:
    """Eq. 7: k * N^(1/k + 1) * R_FIFO + N * R_PE < R_limit."""
    return (k * n_pe ** (1.0 / k + 1.0) * r_fifo + n_pe * r_pe) < r_limit


# ---------------------------------------------------------------------------
# H100 re-parameterization (hardware-adaptation of §V)
# ---------------------------------------------------------------------------

def h100_model_teps(n_chips: int, len_nl: float, s_v_bits: int = 32,
                    visit_eff: float = 1.0) -> float:
    """The paper's Eq. 6 with PC->card: TEPS if each card streams neighbor
    lists at its HBM bandwidth (``launch.roofline.H100.hbm_bw``).
    ``visit_eff`` discounts for edges inspected more than once across
    modes (hybrid ~= 1)."""
    bw_nl = H100.hbm_bw * (len_nl * s_v_bits) / (64 + len_nl * s_v_bits)
    # 64-bit overhead per vertex: offset-pair read, the DW analogue.
    return n_chips * bw_nl / (s_v_bits / 8) * visit_eff
