"""The port's analytic model (``repro_torch.core.perf_model``, paper §V)
against the reference's, exactly, and its H100 re-parameterisation."""
import dataclasses
import itertools

import pytest

pytest.importorskip("jax")

from repro.core import perf_model as jpm            # noqa: E402
from repro_torch.core import perf_model as tpm      # noqa: E402
from repro_torch.launch.roofline import H100        # noqa: E402

CFGS = [dict(), dict(s_v_bits=64, freq_hz=250e6, bw_max=14.37e9),
        dict(s_v_bits=16, freq_hz=450e6, bw_max=19.2e9)]
GRID = list(itertools.product((1, 2, 3, 8, 32, 64, 128, 512), (1, 4, 32),
                              (0.5, 1, 7, 16, 32, 200)))


def _pair(cfg: dict):
    return tpm.PerfModelConfig(**cfg), jpm.PerfModelConfig(**cfg)


def test_config_defaults_are_the_papers():
    assert dataclasses.asdict(tpm.PerfModelConfig()) == \
        dataclasses.asdict(jpm.PerfModelConfig())
    assert [f.name for f in dataclasses.fields(tpm.PerfModelConfig)] == \
        [f.name for f in dataclasses.fields(jpm.PerfModelConfig)]


@pytest.mark.parametrize("cfg", CFGS)
def test_eq1_to_eq6_equal_reference_on_grid(cfg):
    tc, jc = _pair(cfg)
    for n_pe, n_pc, len_nl in GRID:
        assert tpm.axi_data_width_bits(n_pe, tc.s_v_bits) == \
            jpm.axi_data_width_bits(n_pe, jc.s_v_bits)
        assert tpm.pc_bandwidth(n_pe, tc) == jpm.pc_bandwidth(n_pe, jc)
        assert tpm.p_nl(n_pe, len_nl, tc) == jpm.p_nl(n_pe, len_nl, jc)
        assert tpm.perf_pg(n_pe, len_nl, tc) == jpm.perf_pg(n_pe, len_nl, jc)
        assert tpm.perf_total(n_pe, n_pc, len_nl, tc) == \
            jpm.perf_total(n_pe, n_pc, len_nl, jc)
    assert tpm.perf_total(8, 32, 16) == jpm.perf_total(8, 32, 16)


@pytest.mark.parametrize("cfg", CFGS)
def test_fig7_and_break_point_equal_reference(cfg):
    tc, jc = _pair(cfg)
    assert tpm.fig7_curves(cfg=tc) == jpm.fig7_curves(cfg=jc)
    assert tpm.fig7_curves((3, 5), (2, 9), tc) == \
        jpm.fig7_curves((3, 5), (2, 9), jc)
    assert tpm.break_point_pes(tc) == jpm.break_point_pes(jc)
    assert tpm.fig7_curves() == jpm.fig7_curves()
    assert tpm.break_point_pes() == jpm.break_point_pes()


def test_crossbar_model_equals_reference():
    for n in (1, 4, 16, 32, 64, 256):
        assert tpm.full_crossbar_fifos(n) == jpm.full_crossbar_fifos(n)
    for factors in ((32,), (4, 8), (8, 4), (2, 4, 4), (2, 16, 16)):
        assert tpm.multilayer_crossbar_fifos(factors) == \
            jpm.multilayer_crossbar_fifos(factors)
    for n_pe, k, r_fifo, r_pe, r_limit in itertools.product(
            (16, 64, 256), (1, 2, 3), (50.0, 310.5), (900.0, 4000.0),
            (1.3e5, 1.3e6)):
        assert tpm.crossbar_lut_constraint(n_pe, k, r_fifo, r_pe, r_limit) \
            == jpm.crossbar_lut_constraint(n_pe, k, r_fifo, r_pe, r_limit)


@pytest.mark.parametrize("n_chips", [1, 4, 256])
@pytest.mark.parametrize("len_nl", [1, 8, 30.0, 64])
@pytest.mark.parametrize("s_v_bits,visit_eff", [(32, 1.0), (64, 0.5)])
def test_h100_model_is_the_references_formula_at_h100_hbm(n_chips, len_nl,
                                                          s_v_bits,
                                                          visit_eff):
    got = tpm.h100_model_teps(n_chips, len_nl, s_v_bits, visit_eff)
    want = jpm.tpu_model_teps(n_chips, len_nl, s_v_bits, visit_eff)
    assert got * jpm.V5E["hbm_bw"] / H100.hbm_bw == pytest.approx(
        want, rel=1e-12)
    assert H100.hbm_bw == 3.35e12
