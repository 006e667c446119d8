"""The benchmark on the card at test sizes: the device generator and
CSR build against a numpy rebuild of the same edges, and each tiny cell's
whole run, traced, with the device-trace readers finding something to
read.  Marked ``cuda``: each skips without a card."""
from __future__ import annotations

import time

import numpy as np
import pytest
from conftest import TINY_CELLS
from test_bench_graph import CFG, numpy_csr

from bfsbench import harness, kron

pytestmark = pytest.mark.cuda


def test_device_csr_build_equals_numpy_rebuild(cuda_device):
    n = 1 << CFG["scale"]
    src, dst = kron.kronecker_edges(CFG["scale"], CFG["edge_factor"],
                                    CFG["initiator"], 2**31 + 3, cuda_device)
    csr, csc = kron.build_graph(CFG, 2**31 + 3, cuda_device)
    assert csc is csr
    s, d = src.cpu().numpy(), dst.cpu().numpy()
    want = numpy_csr(np.concatenate([s, d]), np.concatenate([d, s]), n)
    got = kron.to_host(csr)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_cell_on_the_card(bench_copy, cuda_device, cell):
    out = harness.run_cell(cell, 2**31 + 7, 0.5, True, cuda_device,
                           time.perf_counter(), here=bench_copy)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    idle = ("idle_share.served" if cell.endswith("served")
            else "idle_share")
    assert 0 <= out["metrics"][idle]["value"] < 100
    assert out["breakdown"]["device_ops"]
