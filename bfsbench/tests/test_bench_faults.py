"""Whole runs on the CPU (the look for a card skipped) with the timed path
broken underneath: each fault a cell can have must come out as not
correct.  One chip, so there is no exchange between chips to leave out.
Also the control, put in the program's place, on each tiny cell."""
from __future__ import annotations

import numpy as np
import pytest
from conftest import run_tiny

from bfsbench.control import ControlEngine


def state_unchanged(mp):
    """Every step returns its input values: levels never advance."""
    from repro_torch.core import bfs_local, vertex_program

    def keep(step, at):
        def broken(*args, **kw):
            out = list(step(*args, **kw))
            out[at] = args[3]           # the step's input level / value
            return tuple(out)
        return broken
    mp.setattr(vertex_program, "vp_push_step",
               keep(vertex_program.vp_push_step, 2))
    mp.setattr(vertex_program, "vp_pull_step",
               keep(vertex_program.vp_pull_step, 2))
    mp.setattr(bfs_local, "push_step", keep(bfs_local.push_step, 2))
    mp.setattr(bfs_local, "pull_step", keep(bfs_local.pull_step, 2))


def half_batch(mp):
    """The second half of every wave's planes left out of the rows."""
    from repro_torch.core.vertex_program import INF, VertexProgramRunner
    fetch_many = VertexProgramRunner._fetch_many

    def broken(self, *ts):
        rows, *rest = fetch_many(self, *ts)
        rows = rows.copy()
        rows[rows.shape[0] // 2:] = INF
        return [rows, *rest]
    mp.setattr(VertexProgramRunner, "_fetch_many", broken)


def answer_altered(mp):
    """One vertex of every answer off by one where it is read back."""
    from repro_torch.core.bfs_local import BFSRunner
    from repro_torch.core.vertex_program import VertexProgramRunner
    fetch_many = VertexProgramRunner._fetch_many
    fetch = BFSRunner._fetch

    def broken_many(self, *ts):
        rows, *rest = fetch_many(self, *ts)
        rows = rows.copy()
        rows[:, -1] += 1
        return [rows, *rest]

    def broken_one(self, t):
        out = fetch(self, t)
        if out.size > 64:
            out = out.copy()
            out[-1] += 1
        return out
    mp.setattr(VertexProgramRunner, "_fetch_many", broken_many)
    mp.setattr(BFSRunner, "_fetch", broken_one)


def half_requests(mp):
    """The batcher serves the second half of a wave's real requests rows
    that were never traversed."""
    from repro_torch.core import bitmap
    from repro_torch.core.vertex_program import INF
    from repro_torch.launch import dynbatch
    slice_rows = bitmap.slice_plane_rows

    def broken(levels, b):
        rows = np.array(slice_rows(levels, b))
        rows[b // 2:] = INF
        return rows
    mp.setattr(dynbatch.bitmap, "slice_plane_rows", broken)


def misrouted(mp):
    """The batcher hands each request another request's row."""
    from repro_torch.core import bitmap
    from repro_torch.launch import dynbatch
    slice_rows = bitmap.slice_plane_rows

    def broken(levels, b):
        return np.roll(slice_rows(levels, b), 1, axis=0)
    mp.setattr(dynbatch.bitmap, "slice_plane_rows", broken)


@pytest.mark.parametrize("cell, fault", [
    ("tiny.wave32", state_unchanged), ("tiny.wave32", half_batch),
    ("tiny.wave32", answer_altered),
    ("tiny.single", state_unchanged), ("tiny.single", answer_altered),
    ("tiny.served", state_unchanged), ("tiny.served", half_requests),
    ("tiny.served", answer_altered), ("tiny.served", misrouted),
])
def test_fault_is_not_correct(bench_copy, monkeypatch, cell, fault):
    fault(monkeypatch)
    # A closed loop samples one row of each wave, so a fault in half of
    # the rows escapes a run of k waves with probability 2**-k: give the
    # tiny waves (some 7 a second here) a window of some 20 of them.
    seconds = 0.4 if cell.endswith("served") else 3.0
    out = run_tiny(bench_copy, cell, seed=23, seconds=seconds)
    assert not out["correct"]
    assert out["checks"]["mismatched_levels"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.wave32", "tiny.single",
                                  "tiny.served"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_is_not_correct(bench_copy, cell, seed):
    out = run_tiny(bench_copy, cell, seed=seed,
                   make_entry=ControlEngine.make)
    assert not out["correct"]
    assert out["checks"]["mismatched_levels"]["value"] > 0
    assert out["checks"]["unanswered"]["value"] == 0
