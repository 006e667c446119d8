"""``kernels.expand_frontier``, the engines' P1 + P2 in one entry, against
the two plain functions it stands for and a numpy oracle of the same slots.

On the CPU the entry runs ``compact_indices`` + ``expand_edges`` (the
reference's jnp functions hold those in ``test_torch_sbfs.py``); on the
card it launches the kernels, which ``test_torch_cuda.py`` holds to the
same cases bit for bit.  This file
imports neither JAX nor the reference package, so the card's tests share
its cases.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_local_graph, expand_edges
from repro_torch.graph import csr_from_edges, transpose_csr
from repro_torch.kernels import expand_frontier as kef
from repro_torch.kernels import ref

N = 300                       # vertices (n_pad 320: 20 pad rows, no edges)
DIRECTIONS = ("csr", "csc")
MASKS = ("random", "empty", "full")
BUDGETS = ("below", "equal", "above")


def case_graph(n: int = N, seed: int = 0, device="cpu"):
    """A random directed graph with zero-degree vertices both ways (a
    third of the vertices send no edge, a quarter receive none), repeated
    arcs and self-loops, as a ``LocalGraph``."""
    rng = np.random.default_rng(seed)
    senders = rng.choice(n, size=2 * n // 3, replace=False)
    takers = rng.choice(n, size=3 * n // 4, replace=False)
    src = rng.choice(senders, size=6 * n)
    dst = rng.choice(takers, size=6 * n)
    csr = csr_from_edges(src, dst, n)
    return build_local_graph(csr, transpose_csr(csr), device=device)


def case_inputs(g, direction: str, mask_kind: str, budget_kind: str,
                seed: int = 1):
    """(mask, indptr, indices, budget) of one case on ``g``'s device: the
    mask over all n_pad rows, the budget below, at or above the edge
    total of the masked lists (``above`` not a multiple of 4)."""
    indptr, indices = ((g.out_indptr, g.out_indices) if direction == "csr"
                       else (g.in_indptr, g.in_indices))
    rng = np.random.default_rng(seed)
    mask = {"random": rng.random(g.n_pad) < 0.4,
            "empty": np.zeros(g.n_pad, bool),
            "full": np.ones(g.n_pad, bool)}[mask_kind]
    deg = np.diff(indptr.cpu().numpy())
    total = int(deg[mask].sum())
    budget = {"below": total // 2, "equal": total,
              "above": total + 37}[budget_kind]
    return torch.from_numpy(mask).to(g.device), indptr, indices, budget


def oracle(mask, indptr, indices, budget: int):
    """The slots in numpy: the masked vertices ascending, each list in
    order, -1 / -1 / False past the edge total; and the total."""
    m, ptr, idx = (t.cpu().numpy() for t in (mask, indptr, indices))
    act = np.flatnonzero(m)
    lens = ptr[act + 1] - ptr[act]
    src = np.repeat(act, lens)
    nbr = (idx[np.concatenate([np.arange(ptr[v], ptr[v + 1]) for v in act])]
           if act.size else np.zeros(0, np.int32))
    total = int(lens.sum())
    out = np.full((2, budget), -1, np.int32)
    k = min(total, budget)
    out[0, :k], out[1, :k] = src[:k], nbr[:k]
    return out[0], out[1], np.arange(budget) < total, total


def assert_same(got, want) -> None:
    """Bit for bit: each output's dtype, shape and every slot."""
    for g, w, name in zip(got, want, ("src", "nbr", "valid", "total")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.parametrize("budget_kind", BUDGETS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_expand_frontier_equals_plain(direction, mask_kind, budget_kind):
    """Slot for slot what compact_indices + expand_edges give, and the
    oracle's slots: overflow (budget below the total), a budget at it and
    one above."""
    args = case_inputs(case_graph(), direction, mask_kind, budget_kind)
    got = kef.expand_frontier(*args)
    assert_same(got, ref.expand_frontier_ref(*args))
    src, nbr, valid, total = oracle(*args)
    np.testing.assert_array_equal(got[0].numpy(), src)
    np.testing.assert_array_equal(got[1].numpy(), nbr)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert got[3].dtype == torch.int32 and got[3].dim() == 0
    assert int(got[3]) == total
    if budget_kind == "below" and total:
        assert int(got[3]) > args[3]            # the caller's overflow


def test_cpu_launches_nothing_and_card_args_are_checked():
    """The CPU runs the plain version (no launch counted); the card's
    argument checks refuse what the kernels cannot read."""
    g = case_graph()
    mask, indptr, indices, budget = case_inputs(g, "csr", "random", "equal")
    kef.reset_launches()
    assert_same(kef.expand_frontier(mask, indptr, indices, budget),
                ref.expand_frontier_ref(mask, indptr, indices, budget))
    assert kef.LAUNCHES == {"expand_frontier": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        kef.check_args(mask, indptr, indices, budget)
    meta = torch.device("meta")
    m, p, i = (t.to(meta) for t in (mask, indptr, indices))
    with pytest.raises(ValueError, match="unsupported device"):
        kef.check_args(m, p, i, budget)


def test_expand_traffic_counts_each_byte_once():
    """The bound's bytes: the mask, n + 1 indptr entries, a neighbour id
    a slot that holds an edge, 9 bytes a budget slot and the total."""
    g = case_graph()
    mask, indptr, _, _ = case_inputs(g, "csc", "random", "equal")
    total = int(np.diff(indptr.numpy())[mask.numpy()].sum())
    n = g.n_pad
    for budget in (total // 2, total, total + 37):
        assert kef.expand_traffic(mask, indptr, budget) == (
            n + 4 * (n + 1) + 4 * min(total, budget) + 9 * budget + 4)


def test_steps_expand_through_the_entry(monkeypatch):
    """Every engine step that expands a level goes through
    ``kernels.expand_frontier``, once a step: the packed wave's push and
    pull, the single source's, the bool-plane baseline's.  No step calls
    ``expand_edges`` but through it (on the CPU the entry's plain version
    calls it once), and ``budget_slots`` sums the budgets expanded."""
    from repro_torch.core import (BFSRunner, MultiSourceBFSRunner,
                                  SchedulerConfig, bfs_local)
    g = case_graph()
    entry, inner = [], []
    orig = kef.expand_frontier

    def spy_entry(*args):
        entry.append(int(args[3]))
        return orig(*args)

    def spy_inner(*args):
        inner.append(int(args[3]))
        return expand_edges(*args)

    monkeypatch.setattr(kef, "expand_frontier", spy_entry)
    monkeypatch.setattr(bfs_local, "expand_edges", spy_inner)
    roots = np.array([0, 5, 17, 40])
    for policy in ("push", "pull"):
        sched = SchedulerConfig(policy=policy)
        for runner in (MultiSourceBFSRunner(g, sched, use_kernels=True),
                       MultiSourceBFSRunner(g, sched, use_kernels=True,
                                            packed=False),
                       BFSRunner(g, sched, use_kernels=True)):
            entry.clear()
            inner.clear()
            res = runner.run(roots if hasattr(runner, "packed") else 0)
            assert len(entry) == res.iterations + res.overflow_retries > 0
            assert inner == entry
            if hasattr(runner, "last_stats"):
                assert runner.last_stats["budget_slots"] == sum(entry)
