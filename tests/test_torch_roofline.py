"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's, for the same ``Hardware`` values, and its H100 constants."""
import dataclasses

import pytest

pytest.importorskip("jax")

from repro.launch import roofline as jroof           # noqa: E402
from repro_torch.launch import roofline as troof     # noqa: E402

CARDS = [dict(name="h100-sxm", peak_bf16=989e12, hbm_bw=3.35e12,
              ici_bw=450e9),
         dict(name="other", peak_bf16=197e12, hbm_bw=819e9, ici_bw=50e9)]
LOADS = [dict(flops=5.5e11, bytes=2.7e8),                    # compute bound
         dict(flops=0.0, bytes=1.3e8),                       # memory bound
         dict(flops=1e9, bytes=1e6, collective_bytes=4e9)]   # collective


def test_h100_constants():
    h = troof.H100
    assert (h.name, h.peak_bf16, h.hbm_bw, h.ici_bw) == (
        "h100-sxm", 989e12, 3.35e12, 450e9)
    assert troof.Hardware() == h
    assert [f.name for f in dataclasses.fields(troof.Hardware)] == \
        [f.name for f in dataclasses.fields(jroof.Hardware)]


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("load", LOADS)
def test_roofline_terms_equal_reference(card, load):
    got = troof.roofline_terms(load, troof.Hardware(**card))
    assert got == jroof.roofline_terms(load, jroof.Hardware(**card))
    assert got["bound_s"] == max(got["compute_s"], got["memory_s"],
                                 got["collective_s"])


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analyze_cell_and_format_row_equal_reference(card, kind):
    load = dict(flops=3.1e15, bytes=2.2e12, collective_bytes=1e11)
    got = troof.analyze_cell(load, kind, 8.0e9, 65536, 4,
                             troof.Hardware(**card))
    want = jroof.analyze_cell(load, kind, 8.0e9, 65536, 4,
                              jroof.Hardware(**card))
    assert got == want
    assert troof.model_flops(kind, 8.0e9, 4096) == jroof.model_flops(
        kind, 8.0e9, 4096)
    assert troof.format_row("cell", got) == jroof.format_row("cell", want)


def test_default_is_the_h100():
    load = dict(flops=989e12, bytes=3.35e12)
    got = troof.roofline_terms(load)
    assert got["compute_s"] == 1.0 and got["memory_s"] == 1.0
    assert troof.analyze_cell(load, "decode", 1e9, 1, 1) == \
        troof.analyze_cell(load, "decode", 1e9, 1, 1, troof.H100)
