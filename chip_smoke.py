#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--graph rmat20-16] [--batch 64] [--seed 0]
                          [--profile]

Needs one CUDA card and nvcc; exits non-zero (printing no result) without
them.  Phases, each failing the run on any error:

  (a) card: name and power limit (nvidia-smi), torch and CUDA versions;
  (b) build: nvcc builds every kernel source from the checkout, one nvcc
      per source, all started together, timed; ptxas's registers and
      spills of every kernel, and the dynamic shared memory a block of
      K6 and K7 takes;
  (c) kernels against their plain versions ON THE CARD, bit-exact: the
      propagate kernels K1/K2 (both combine ops; K1 in its trash-row form
      and on the edge list as it stands with valid and n_edges none / 0 /
      inside / m / beyond m, its launches one at a time at nw 1, 2, 3, 4,
      8; K2
      given its run heads) on the adversarial cases of the kernel test
      suites, then on every level of a real traversal of --graph at
      --batch roots and at 256 roots: K1 timed as the engine calls it
      (``ops.msbfs_propagate(tile_rows=0)``, wrapper included) and alone
      (its C launch function's three launches replayed from a CUDA
      graph, its P3 and zero launches alone), its
      bound counting what the level's data makes it move, with a work
      estimate and the first design's padded bound beside it; K2's pad
      chunks logged per level, and K2 timed alone at three load widths;
      the P3 kernels K3/K4 on adversarial word counts, then on the inputs
      of every level of (h)'s 64 single-source runs (K4 into out= buffers
      as the runner calls it, with fresh outputs, and alone by graph
      replay as launched and as the first design's atomics) and of a
      bool-plane wave (K3); kernel, plain and bound times of each, and
      the cost of K3's two transposes;
  (d) the serving path: ``serve_bfs(graph, batch)`` (warm-up + timed
      wave, auto kernel plan) with launch counts reset just before; every
      plane is validated Graph500-style on the card and 4 roots against a
      vectorised numpy BFS;
  (e) the same call with ``tile_rows=0`` (the whole-array kernel), whose
      levels must equal (d)'s;
  (o) ``serve_bfs(graph, 256)`` with the tiled plan (K2) and with the
      whole-array plan (K1), every plane validated as in (d), the two
      plans' levels equal; then, at --batch and at 256, one wave of each
      plan in turns (tiled, whole, whole, tiled) through ``bfs_batch``,
      and the plan the auto rule picks;
  (h) single-source BFS, the paper's metric: ``BFSRunner`` over 64 roots
      (Graph500's count of search keys, seed 0, non-isolated) after one
      warm-up root; every root validated Graph500-style and 4 against the
      numpy BFS; min / median / harmonic-mean GTEPS;
  (i) the bool-plane baseline ``MultiSourceBFSRunner(packed=False)`` at
      --batch on (d)'s roots: its levels must equal (d)'s;
  (j) CC and SSSP through ``serve_bfs(algo=...)``: SSSP distances equal
      (d)'s levels (unit weights), CC's reach equals (d)'s (--graph is
      symmetric);
  (k) integrity: a ``witness`` wave equals (d)'s levels; a wave with one
      injected frontier bit flip must raise ``IntegrityError``;
  (p) supervised async serving: ``serve_bfs_async`` (256 requests, window
      0.05 s, max_batch 64, pipelined, ``EngineSupervisor`` with 2
      retries and the ``audit`` integrity tier at SERVE_AUDIT_RATE) closed
      loop, then open loop (Poisson) at half the rate the closed loop
      sustained, then two pooled workers closed loop on 128 requests;
      every served row validated Graph500-style on the card; no demotion,
      retry, timeout or quarantine, at least two audits, no audit
      failure; K1 launched by every run's served waves (counted from the
      stream's start, past ``serve_bfs_async``'s warm-up) and K3 by its
      audits; a served wave's time split into its levels and its
      readback, and what the audit tier adds to it;
  (q) chaos on the card: ``DynamicBatcher`` over ``EngineSupervisor``
      (``witness``, explicit wave deadline) over ``FaultyEngine`` with a
      fixed ``FaultPlan`` — two kernel faults in one wave (a
      ``kernels->boolplane`` demotion whose wave launches K3 and gives the
      packed engine's rows), a runtime fault, a stuck wave, a plane flip
      and a result flip — serving 128 requests in five waves, one of them
      carrying an out-of-range root; every request resolves with a row
      that validates or a typed error, the bad root is quarantined,
      neither flip is served, and no runner on the card ever has its
      kernels turned off;
  (r) the distributed engine (``DistributedBFS``) in a one-rank NCCL
      group on the card (a file store in a temporary directory) over a
      ("data",) mesh of 1: (r1) the paper's peak configuration
      ``scalabfs-32pc-64pe`` (bitmap, staged crossbar, beamer; 64 shards =
      32 PCs x 2 PEs on one rank) runs one ``run_batch`` wave of (d)'s
      roots; every plane validated as in (d), the rows equal (d)'s, K2
      (the batched pull's msgs form) launched on every pull step, one pull
      level's K2 call equal to its plain version; then a warm wave with
      the same rows; (r2) Fig. 10 on one card: single-source ``run`` from
      8 of (h)'s keys at 1, 4, 16 and 64 PEs (bitmap, flat crossbar), each
      root equal to the numpy BFS, median GTEPS per k; one queue-dispatch
      run at 64 PEs, equal to the numpy BFS;
  (l) the paged CSR gather K5, bit-exact: adversarial pages, counts, ids
      out of range and a misaligned edge array, then ``read_neighbor_pages``
      over --graph's edge array for the largest level of (h)'s first root
      (page table from ``build_page_table``), with 1,000 of its vertices'
      neighbour lists reassembled from the pages;
  (m) the block-sparse pull SpMV K6 (wgmma on the tensor cores),
      bit-exact: adversarial tiles, then ``ops.pull_spmv`` over the dense
      hub blocks of --graph (its 8,192 highest-degree vertices in
      128-blocks) with (d)'s level-1 frontier of its 64 roots as lanes;
  (n) flash attention K7 (bf16 by wgmma on the tensor cores, f32 on the
      CUDA cores) within its stated tolerance: adversarial dtypes, head
      dims, lengths and blocks, then llama3-8b's attention (32 heads,
      head dim 128, S = 8192, causal, bf16);
  (t) the LM stack (``repro_torch.models``; it launches none of the
      seven kernels): (t1) each of the ten reduced configs, bf16 weights
      from a seeded CPU generator copied to the card, runs ``loss_fn``
      and its backward (loss and every grad finite) and 4 ``serve_step``
      positions; the loss within 1e-2 and the logits within an rms ratio
      of 2e-2 of the CPU port's on the same weights; (t2) the slice's
      main path, ``greedy_decode("llama3-8b", reduced=False, batch=4,
      prompt_len=64, gen_tokens=32)``: 32 layers, 7.505e9 parameters,
      15.0 GB of bf16 weights drawn on the card; prefill and decode
      tok/s and the peak memory allocated; the logits finite, and the
      tokenwise decode's last prompt position within an rms ratio of
      3e-2 of ``prefill_step`` over the same prompt; (t3)
      qwen3-moe-30b-a3b at full width (d 2048, 128 experts, top-8,
      expert d_ff 768, ``moe_chunk`` 2048; ``ep`` falls back to
      ``gather`` on one rank) with its depth cut from 48 to 4 layers: a
      prefill over 2 x 2048 tokens and 8 decode steps, the share of
      (token, slot) pairs dropped by capacity counted; then the first
      layer's ``moe_forward`` in float32 on its prefill input, on the
      card and on the CPU: the same top-k indices, the same drops,
      outputs within 1e-4 + 1e-4·|want|;
  (s) the step analysis, the dry-run and the analytic model: (s1) (d)'s
      wave (its roots, ``MultiSourceBFSRunner``) and one (h) root counted
      by ``launch.step_analysis.StepAnalysis`` on the card: FLOPs, bytes,
      collective bytes and the roofline bound beside (d)'s measured wave
      and levels' seconds, level by level; the K1 and K4 calls counted as
      often as ``LAUNCHES`` counts their launches, K1's bytes equal to
      ``k1_bytes`` of its calls, and every count equal to the CPU's for
      the same wave and root (``use_kernels=True``); (s2) ``python -m
      repro_torch.launch.dryrun --all`` on the card, while the CPU counts:
      the eight BFS cells (rmat22-16 bitmap/staged, bitmap/flat,
      queue/staged, rmat23-64 and lj-like bitmap/staged on the 16x16 mesh;
      the three bitmap/staged on 2x16x16) each record one push and one
      pull step of one rank of a fake 256- or 512-rank group, their shard
      fields the reference's arithmetic, each step's peak bytes logged
      against the card's memory; (s3) ``perf_model.h100_model_teps(1,
      len_nl)`` at --graph's mean degree beside (d)'s TEPS;
  (f) one JSON line of per-kernel results: K1 with its launches in (e)
      and times at --batch, K2 with its launches in (o)'s tiled call and
      (r1)'s wave and times at 256 roots, K3 in (i), K4 in (h), K5 in
      (l), K6 in (m), K7 in (n); every bound from
      ``repro_torch.launch.roofline`` (H100), every library yardstick
      timed here and used nowhere in the port; the
      (l)-(n) rows also log the share of the bound and the ratio to the
      library time;
  (g) with --profile only: device time by kernel and the device's idle
      share over one wave of each plan at --batch, over one
      single-source root of (h) and over (r1)'s warm wave
      (torch.profiler).

Before the ``kernels`` line, one ``serving`` JSON line carries (p)'s and
(q)'s numbers, one ``distributed`` JSON line (r)'s, one ``analysis``
JSON line (s)'s and one ``lm`` JSON line (t)'s.  The last line
of standard output is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = str(Path(__file__).resolve().parent / "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (ARCH_NAMES, get_config,  # noqa: E402
                                 get_reduced_config)
from repro_torch.core.bfs_local import (INF, BFSRunner,  # noqa: E402
                                        build_local_graph)
from repro_torch.core.vertex_program import (IntegrityError,  # noqa: E402
                                             MultiSourceBFSRunner,
                                             component_labels)
from repro_torch.core.perf_model import h100_model_teps  # noqa: E402
from repro_torch.graph import edge_sources, get_dataset  # noqa: E402
from repro_torch.graph.datasets import DATASETS  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bitmap_update as kbu  # noqa: E402
from repro_torch.kernels import csr_gather as kcg  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import msbfs_propagate as kmod  # noqa: E402
from repro_torch.kernels import pull_spmv as kps  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.roofline import H100, roofline_terms  # noqa: E402
from repro_torch.launch.serve import (decode_loop,  # noqa: E402
                                      greedy_decode, serve_bfs,
                                      serve_bfs_async)
from repro_torch.launch.step_analysis import StepAnalysis  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

# kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "msbfs_propagate_planes": (
        "src/repro_torch/kernels/csrc/msbfs_propagate.cu",
        "src/repro/kernels/msbfs_propagate.py:142"),
    "msbfs_propagate_planes_tiled": (
        "src/repro_torch/kernels/csrc/msbfs_propagate.cu",
        "src/repro/kernels/msbfs_propagate.py:254"),
    "bitmap_update_batch": (
        "src/repro_torch/kernels/csrc/bitmap_update.cu",
        "src/repro/kernels/bitmap_update.py:59"),
    "bitmap_update": (
        "src/repro_torch/kernels/csrc/bitmap_update.cu",
        "src/repro/kernels/bitmap_update.py:91"),
    "gather_pages": (
        "src/repro_torch/kernels/csrc/csr_gather.cu",
        "src/repro/kernels/csr_gather.py:32"),
    "pull_spmv_blocks": (
        "src/repro_torch/kernels/csrc/pull_spmv.cu",
        "src/repro/kernels/pull_spmv.py:43"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:67"),
}
SOURCES = ("msbfs_propagate", "bitmap_update", "csr_gather", "pull_spmv",
           "flash_attention")
MODULES = (kmod, kbu, kcg, kps, kfa)
SEARCH_KEYS = 64                 # Graph500's count of BFS roots per run
WIDE_BATCH = 256                 # planes outgrow the 50 MB L2 at rmat20
TILE, BLOCK = 16, 32             # small-case tiling of the kernel tests


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def demangle(names: list[str]) -> list[str]:
    """Kernel names as c++filt gives them, without the arguments (the
    mangled names where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return [o.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for o in out]


def ptxas_report(log_text: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` report: registers,
    spills and static shared memory."""
    names, facts = [], []
    for line in log_text.splitlines():
        if "Function properties for" in line:
            names.append(line.split("Function properties for")[1].strip())
            facts.append([])
        elif names and ("spill" in line or "registers" in line):
            facts[-1].append(line.split(":", 1)[-1].strip())
    return [f"{n}: {'; '.join(f)}" for n, f in zip(demangle(names), facts)]


def log_smem() -> None:
    """The dynamic shared memory a block of K6 and K7 takes (ptxas reports
    only static shared memory)."""
    fa = _build.load("flash_attention").flash_attention_smem_bytes
    ps = _build.load("pull_spmv").pull_spmv_smem_bytes
    fa.argtypes, fa.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    ps.argtypes, ps.restype = [ctypes.c_int], ctypes.c_int
    log("(b) dynamic shared memory a block: flash_attention " + ", ".join(
        f"hd {hd} {dt} {fa(hd, code)} B" for hd in kfa.HEAD_DIMS
        for dt, code in (("bf16", 1), ("f32", 0))) + "; pull_spmv " +
        ", ".join(f"L {lanes} {ps(lanes)} B" for lanes in (64, 128)))


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` with no host time between its launches:
    ``reps`` calls captured in one CUDA graph, replayed once to warm up
    and once timed (CUDA events), after one warm-up call.  ``fn`` must
    launch on the current stream."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_launches() -> None:
    for mod in MODULES:
        mod.reset_launches()


def launches() -> dict:
    return {k: v for mod in MODULES for k, v in mod.LAUNCHES.items()}


def assert_same(got, want, what: str) -> int:
    """Bit-exact equality of every output; returns the max |difference|
    (0 when equal, else raises)."""
    err = 0
    for g, w, name in zip(got, want, ("new", "seen_out", "count")):
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        if g64.shape != w64.shape:
            raise AssertionError(f"{what}: {name} shape {tuple(g.shape)} "
                                 f"!= {tuple(w.shape)}")
        e = int((g64 - w64).abs().max()) if g64.numel() else 0
        if e:
            raise AssertionError(f"{what}: {name} differs (max abs {e})")
        err = max(err, e)
    return err


# -- kernel inputs ----------------------------------------------------------

def trash_row_inputs(frontier, seen, src, tgt, valid):
    """K1's older call form: a trash row (frontier 0, seen all-ones)
    appended and every dropped slot pointed at it."""
    n, nw = frontier.shape
    ok = ops._edge_ok(valid, src, tgt, n)
    f1 = torch.cat([frontier, frontier.new_zeros((1, nw))])
    s1 = torch.cat([seen, seen.new_full((1, nw), -1)])
    return (f1, s1, torch.where(ok, src, n).to(torch.int32),
            torch.where(ok, tgt, n).to(torch.int32))


def tiled_inputs(frontier, seen, src, tgt, valid, tile_rows, block_edges):
    """K2's inputs as ``ops.msbfs_propagate`` builds them: (seen, msg,
    tgt, chunk_tile) and the run heads ``tile_chunks``."""
    ok = ops._edge_ok(valid, src, tgt, frontier.shape[0])
    *args, heads = ops._tiled_inputs(seen, frontier, src, tgt, ok, tile_rows,
                                     block_edges)
    return args, heads


def gathered_msgs(frontier, src, ok):
    """msg[e] = frontier[src[e]] where ok, else 0: the msgs-form input."""
    msg = frontier[src.to(torch.int64).clamp(0, frontier.shape[0] - 1)]
    return torch.where(ok[:, None], msg, 0)


def k2_alone(k2, tile_rows: int, block_edges: int, reps: int) -> dict:
    """K2 alone: run ends, outputs and counters made once; each timed call
    zeroes ``new`` and the counters, as the launch requires, then calls the
    C launch function (no wrapper, no allocation).  Timed with the load
    widths (vec, vec4) the wrapper picks ("chosen"), with a scalar P3
    ("p3_scalar": vec, 0) and with the simplest widths ("simple": uint2
    message groups at even nw, scalar P3), in turns forward then back;
    every variant must give the chosen one's outputs.  Returns the means,
    the largest spread of a variant's two turns over its mean, and the
    zero fill's time."""
    (seen, msg, tgt, ct), heads = k2
    run_first, work_off = kmod._tile_runs(ct, heads, seen.shape[0] //
                                          tile_rows, block_edges)
    new, seen_out = torch.empty_like(seen), torch.empty_like(seen)
    scratch = torch.empty(seen.shape[0] // tile_rows + 1, dtype=torch.int32,
                          device=seen.device)
    chosen = kmod._load_widths(seen, msg, new, seen_out, tile_rows)
    variants = {"kernel_only_ms": chosen, "p3_scalar_ms": (chosen[0], 0),
                "simple_ms": (2 if seen.shape[1] % 2 == 0
                              and msg.data_ptr() % 8 == 0 else 1, 0)}

    def run(widths):
        new.zero_()
        scratch.zero_()
        _build.raise_on_error(kmod._launch_tiled(
            seen, msg, tgt, run_first, work_off, new, seen_out, scratch,
            tile_rows, "or", widths), "msbfs_propagate_planes_tiled")

    want = None
    for name, widths in variants.items():
        run(widths)
        got = (new.clone(), seen_out.clone(), scratch[:1].clone())
        want = want or got
        assert_same(got, want, f"K2 load widths {widths}")
    t = {name: [] for name in variants}
    for name in [*variants, *reversed(variants)]:
        t[name].append(time_ms(lambda: run(variants[name]), reps))
    out = {name: float(np.mean(v)) for name, v in t.items()}
    out["turn_spread"] = max(abs(v[0] - v[1]) / np.mean(v)
                             for v in t.values())
    out["zero_ms"] = time_ms(lambda: (new.zero_(), scratch.zero_()), reps)
    out["widths"] = " / ".join(str(w) for w in variants.values())
    return out


def check_k1(args, op, what, valid=None, n_edges=None) -> int:
    got = kmod.msbfs_propagate_planes(*args, op=op, valid=valid,
                                      n_edges=n_edges)
    want = ref.msbfs_propagate_planes_ref(*args, op=op, valid=valid,
                                          n_edges=n_edges)
    return assert_same(got, want, f"K1 {what} [{op}]")


def k1_alone(frontier, seen, src, tgt, valid, n_edges, reps: int) -> dict:
    """K1 alone: outputs made once, its C launch function's three launches
    replayed from a CUDA graph (device time, :func:`graph_ms`) in two
    turns, the launches one at a time (zero, scatter, P3) giving the same
    outputs as all three at once; then its P3 launch and its zero launch
    alone.  Returns the mean, the spread of the two turns over it, p3_ms
    and zero_ms."""
    lib = kmod._lib()
    new, seen_out = torch.empty_like(seen), torch.empty_like(seen)
    cnt = torch.empty((1, 1), dtype=torch.int32, device=seen.device)
    args = kmod.whole_launch_args(frontier, seen, src, tgt, valid, n_edges,
                                  new, seen_out, cnt, "or")

    def run(phases=kmod.PHASES_ALL):
        _build.raise_on_error(lib.msbfs_propagate_planes_launch(
            *args, phases, _build.stream_ptr(seen.device)),
            f"K1 phases {phases}")

    run()
    want = (new.clone(), seen_out.clone(), cnt.clone())
    for phases in (0x1, 0x2, 0x4):
        run(phases)
    assert_same((new, seen_out, cnt), want, "K1 one launch at a time")
    turns = [graph_ms(run, reps) for _ in range(2)]
    return dict(kernel_only_ms=float(np.mean(turns)),
                turn_spread=abs(turns[0] - turns[1]) / np.mean(turns),
                p3_ms=graph_ms(lambda: run(0x4), reps),
                zero_ms=graph_ms(lambda: run(0x1), reps))


def check_k2(k2, tile_rows, block_edges, op, what) -> int:
    """K2 given its run heads, as the path calls it, against the plain
    version, which reads every chunk."""
    args, heads = k2
    want = ref.msbfs_propagate_planes_tiled_ref(*args, tile_rows,
                                                block_edges, op=op)
    got = kmod.msbfs_propagate_planes_tiled(*args, heads, tile_rows,
                                            block_edges, op=op)
    return assert_same(got, want, f"K2 {what} [{op}]")


def small_cases(dev):
    """The adversarial cases of tests/test_kernels.py and
    tests/test_msbfs_tiled.py: (name, frontier, seen, src, tgt, valid).
    Random words set bit 31 in about half of them."""
    def planes(n, nw, seed):
        rng = np.random.default_rng(seed)
        return (rng.integers(0, 2**32, (n, nw), dtype=np.uint32),
                rng.integers(0, 2**32, (n, nw), dtype=np.uint32))

    cases = []
    for n, nw, m in ((33, 1, 64), (65, 2, 128), (129, 1, 256), (17, 3, 96)):
        f, s = planes(n, nw, m + nw)
        rng = np.random.default_rng(m)
        cases.append((f"random n={n} nw={nw}", f, s,
                      rng.integers(0, n, m), rng.integers(0, n, m),
                      np.ones(m, bool)))
    f, s = planes(65, 2, 21)
    rng = np.random.default_rng(22)
    tgt = rng.integers(0, 65, 192)
    tgt[:64] = tgt[0]
    cases.append(("colliding targets", f, s, rng.integers(0, 65, 192), tgt,
                  np.ones(192, bool)))
    for batch in (1, 32, 48, 96):
        nw = (batch + 31) // 32
        f, s = planes(100, nw, batch)
        rng = np.random.default_rng(batch + 1)
        cases.append((f"invalid+OOR B={batch}", f, s,
                      rng.integers(-2, 103, 700), rng.integers(-2, 103, 700),
                      rng.random(700) < 0.85))
    n = 8 * TILE
    f, s = planes(n, 2, 3)
    b = np.arange(TILE, n, TILE)
    tgt = np.tile(np.concatenate([b - 1, b, b + 1, [0, n - 1]]), 5)
    cases.append(("tile straddling", f, s,
                  np.random.default_rng(4).integers(0, n, tgt.size), tgt,
                  np.ones(tgt.size, bool)))
    f, s = planes(6 * TILE, 1, 11)
    tgt = np.arange(5 * TILE)
    cases.append(("hub source spans tiles", f, s, np.full(tgt.size, 7), tgt,
                  np.ones(tgt.size, bool)))
    f, s = planes(5 * TILE, 1, 17)
    m = 6 * BLOCK + 11
    rng = np.random.default_rng(18)
    tgt = np.full(m, 2 * TILE + 3)
    tgt[::13] = rng.integers(0, 5 * TILE, tgt[::13].size)
    cases.append(("hub target overflows a chunk", f, s,
                  rng.integers(0, 5 * TILE, m), tgt, np.ones(m, bool)))
    f, s = planes(7 * TILE, 1, 23)
    cases.append(("empty tiles", f, s, np.arange(40), np.full(40, 3),
                  np.ones(40, bool)))
    f, s = planes(3 * TILE, 1, 29)
    cases.append(("all edges invalid", f, s, np.arange(50),
                  np.arange(50) % (3 * TILE), np.zeros(50, bool)))
    for n in (TILE + 1, 3 * TILE - 1, 37):
        f, s = planes(n, 1, n)
        rng = np.random.default_rng(n + 1)
        cases.append((f"rows not a tile multiple n={n}", f, s,
                      rng.integers(0, n, 200), rng.integers(0, n, 200),
                      np.ones(200, bool)))

    def t(a, dtype=torch.int32):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return [(name, t(f), t(s), t(src.astype(np.int32)),
             t(tgt.astype(np.int32)), t(valid, torch.bool))
            for name, f, s, src, tgt, valid in cases]


def phase_small(dev) -> int:
    err, bit31 = 0, False
    cases = small_cases(dev)
    for name, f, s, src, tgt, valid in cases:
        bit31 |= bool((f < 0).any())
        m = int(src.shape[0])
        for op in ("or", "max"):
            err = max(err, check_k1(trash_row_inputs(f, s, src, tgt, valid),
                                    op, f"{name} trash-row form"))
            for ne in (None, 0, m // 3, m, m + 7):
                ne_t = None if ne is None else torch.tensor(
                    ne, dtype=torch.int32, device=dev)
                err = max(err, check_k1((f, s, src, tgt), op,
                                        f"{name} n_edges={ne}", valid, ne_t))
            err = max(err, check_k2(
                tiled_inputs(f, s, src, tgt, valid, TILE, BLOCK), TILE,
                BLOCK, op, name))
            # and the two ops-level paths against the unpadded semantics
            n = f.shape[0]
            ok = ops._edge_ok(valid, src, tgt, n)
            want = ref.msbfs_propagate_msgs_ref(
                s, gathered_msgs(f, src, ok), tgt, ok, op=op)
            for tr in (0, TILE):
                got = ops.msbfs_propagate(f, s, src, tgt, valid,
                                          block_edges=BLOCK, op=op,
                                          tile_rows=tr)
                assert_same(got, want, f"ops tile_rows={tr} {name} [{op}]")
            got = ops.msbfs_propagate_msgs(s, gathered_msgs(f, src, ok), tgt,
                                           valid, tile_rows=TILE,
                                           block_edges=BLOCK, op=op)
            assert_same(got, want, f"ops msgs form {name} [{op}]")
    if not bit31:
        raise AssertionError("no small case had a word with bit 31 set")
    # K1's launches one at a time give its words at every nw it
    # specialises (1, 2, 4, 8) and one it does not (3), a grid far larger
    # than the slots included
    for nw in (1, 2, 3, 4, 8):
        _, f, s, src, tgt, valid = cases[5]
        f = f[:, :1].repeat(1, nw) ^ torch.arange(nw, dtype=torch.int32,
                                                 device=dev)
        s = s[:, :1].repeat(1, nw)
        k1_alone(f, s, src, tgt, valid, None, 1)
    log(f"(c) small cases: {len(cases)} cases x 2 ops, K1 (the trash-row "
        "form, and valid with n_edges none / 0 / m/3 / m / m+7) + K2 + the "
        "three ops paths bit-exact; K1's launches one at a time equal at nw "
        "1, 2, 3, 4, 8")
    return err


def capture_levels(g, roots) -> list:
    """Run the engine once (kernel path) and return the inputs of every
    propagate call it made, one per level: (frontier, seen, src, tgt,
    valid, n_edges).  The engine never writes a tensor in place, so the
    captured inputs stay as they were."""
    calls = []
    orig = ops.msbfs_propagate

    def spy(frontier_w, seen_w, src, tgt, valid, **kw):
        calls.append((frontier_w, seen_w, src, tgt, valid,
                      kw.get("n_edges")))
        return orig(frontier_w, seen_w, src, tgt, valid, **kw)

    ops.msbfs_propagate = spy
    try:
        MultiSourceBFSRunner(g, use_kernels=True).run(roots)
    finally:
        ops.msbfs_propagate = orig
    return calls


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the H100 could take to move ``nbytes`` and do
    ``flops`` (``repro_torch.launch.roofline``), and which bounds it:
    "bytes" or "operations"."""
    t = roofline_terms({"flops": flops, "bytes": nbytes}, H100)
    return t["bound_s"] * 1e3, ("operations" if t["dominant"] == "compute"
                                else "bytes")


def k1_bytes(frontier, src, tgt, valid, n_edges) -> tuple[int, dict]:
    """K1's bound in bytes: what this level's data makes it move
    (``kmod.propagate_traffic``, the count K1 reports to the step
    analysis).  Also, for the log: a work estimate that counts the nw
    frontier words of every real edge, a read-modify-write of the
    candidate words of every non-zero message and the accumulator's
    zeroing, as if nothing stayed in L2 or merged in a warp (it exceeds
    K1's time at B = 256); the first design's padded bound (its whole
    padded edge list and four plane arrays with the trash row); and the
    slot counts."""
    n, nw = frontier.shape
    m = int(src.shape[0])
    t = kmod.propagate_traffic(frontier, src, tgt, valid, n_edges)
    work = (t["slots"] * 9 + t["real"] * nw * 4 + t["live"] * nw * 8
            + 5 * n * nw * 4 + 4)
    be = ops._auto_block_edges(m, nw)
    padded = 4 * (n + 1) * nw * 4 + 2 * (-(-m // be) * be) * 4 + 4
    return t["bytes"], dict(
        slots=t["slots"], real=t["real"], live=t["live"], rows=t["rows"],
        work_ms=bound(work)[0], padded_bound_ms=bound(padded)[0])


def phase_real(g, deg: np.ndarray, graph: str, batch: int, seed: int
               ) -> dict:
    """Both kernels against their plain versions on the inputs of every
    level of one wave of ``batch`` roots (both ops), timed level by level.
    Each kernel's ms / plain_ms / bound_ms are means over the wave's
    calls.  K1 is timed as the engine calls it (``ops.msbfs_propagate``
    with ``tile_rows=0`` on the level's inputs as they stand, wrapper
    included) and alone (:func:`k1_alone`); its bound counts the work the
    level needs (:func:`k1_bytes`), the first design's padded bound logged
    beside it.  K2's bound (``kmod.tiled_traffic``) counts the message
    of each slot of the tiles' head chunks, the target of each slot whose
    message is not zero, and its three plane arrays."""
    roots = np.random.default_rng(seed).choice(np.flatnonzero(deg > 0),
                                               batch, replace=False)
    calls = capture_levels(g, roots)
    per = {name: [] for name in ("msbfs_propagate_planes",
                                 "msbfs_propagate_planes_tiled")}
    for lvl, (frontier, seen, src, tgt, valid, ne) in enumerate(calls):
        n, nw = frontier.shape
        m = int(src.shape[0])
        be = ops._auto_block_edges(m, nw)
        tr = ops._auto_tile_rows(nw)
        k2 = tiled_inputs(frontier, seen, src, tgt, valid, tr, be)
        what = f"{graph} B={batch} level {lvl}"
        e1 = 0
        for op in ("or", "max"):
            e1 = max(e1, check_k1((frontier, seen, src, tgt), op, what,
                                  valid, ne))
            want = ref.msbfs_propagate_planes_ref(frontier, seen, src, tgt,
                                                  op, valid, ne)
            got = ops.msbfs_propagate(frontier, seen, src, tgt, valid, op=op,
                                      tile_rows=0, n_edges=ne)
            assert_same(got, (want[0], want[1], want[2][0, 0]),
                        f"ops tile_rows=0 {what} [{op}]")
        e2 = max(check_k2(k2, tr, be, op, what) for op in ("or", "max"))
        (s2, sm, st, ct), heads = k2
        pad = int(ct.shape[0]) - int(heads.sum())
        # the tiled path's feed: the bucket count alone (searchsorted on
        # the sorted tile keys), and the whole bucketing with its gather
        ok = ops._edge_ok(valid, src, tgt, n)
        t_ = int(s2.shape[0]) // tr
        keys, _ = torch.sort(torch.where(ok, tgt // tr, t_).to(torch.int16))
        count_ms = time_ms(lambda: ops._key_starts(keys, t_), 5)
        feed_ms = time_ms(lambda: tiled_inputs(frontier, seen, src, tgt,
                                               valid, tr, be), 2)
        b1, sl = k1_bytes(frontier, src, tgt, valid, ne)
        b2 = kmod.tiled_traffic(s2, sm, heads, be)
        r1 = dict(bytes=b1, bound_ms=bound(b1)[0], max_abs_err=e1,
                  work_ms=sl["work_ms"],
                  padded_bound_ms=sl["padded_bound_ms"],
                  ms=time_ms(lambda: ops.msbfs_propagate(
                      frontier, seen, src, tgt, valid, tile_rows=0,
                      n_edges=ne), 5),
                  plain_ms=time_ms(lambda: ref.msbfs_propagate_planes_ref(
                      frontier, seen, src, tgt, "or", valid, ne), 1),
                  **k1_alone(frontier, seen, src, tgt, valid, ne, 20))
        r2 = dict(bytes=b2, bound_ms=bound(b2)[0], max_abs_err=e2,
                  count_ms=count_ms, feed_ms=feed_ms,
                  **k2_alone(k2, tr, be, 20),
                  ms=time_ms(lambda: kmod.msbfs_propagate_planes_tiled(
                      s2, sm, st, ct, heads, tr, be), 5),
                  plain_ms=time_ms(
                      lambda: ref.msbfs_propagate_planes_tiled_ref(
                          s2, sm, st, ct, tr, be), 1))
        per["msbfs_propagate_planes"].append(r1)
        per["msbfs_propagate_planes_tiled"].append(r2)
        nz = int((frontier != 0).any(1).sum())
        widths = r2.pop("widths")
        log(f"(c) B={batch} level {lvl}: budget={m} n_edges={sl['slots']} "
            f"real edges={sl['real']} of them non-zero messages="
            f"{sl['live']} distinct source rows={sl['rows']} frontier rows="
            f"{nz} | K1 {r1['ms']:.4f} ms as the "
            f"engine calls it (bound {r1['bound_ms']:.4f}, work estimate "
            f"{r1['work_ms']:.4f}, padded bound {r1['padded_bound_ms']:.4f}, "
            f"plain {r1['plain_ms']:.3f}); alone (graph replay) "
            f"{r1['kernel_only_ms']:.4f} (turn spread "
            f"{r1['turn_spread']:.3f}); its P3 launch alone "
            f"{r1['p3_ms']:.4f}, zero launch {r1['zero_ms']:.4f} "
            f"| K2 block_edges={be} tile_rows={tr} chunks={ct.shape[0]} pad "
            f"chunks={pad}: {r2['ms']:.4f} ms (bound {r2['bound_ms']:.4f}, "
            f"plain {r2['plain_ms']:.3f}; alone {r2['kernel_only_ms']:.4f} / "
            f"scalar P3 {r2['p3_scalar_ms']:.4f} / simple widths "
            f"{r2['simple_ms']:.4f} (vec, vec4 {widths}; turn spread "
            f"{r2['turn_spread']:.3f}), zero fill {r2['zero_ms']:.4f}; feed "
            f"{feed_ms:.3f} ms, its bucket count {count_ms:.4f} ms)")
        del k2
    out = {}
    for name, rows in per.items():
        out[name] = {k: float(np.mean([r[k] for r in rows]))
                     for k in rows[0] if k != "max_abs_err"}
        out[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        r = out[name]
        if "feed_ms" in r:
            extra = (f" kernel_only_ms={r['kernel_only_ms']:.4f} (C launch "
                     f"function back to back, zero fill of new and counters "
                     f"included) p3_scalar_ms={r['p3_scalar_ms']:.4f} "
                     f"simple_widths_ms={r['simple_ms']:.4f} "
                     f"turn_spread_mean={r['turn_spread']:.4f} "
                     f"zero_fill_ms={r['zero_ms']:.4f} feed_ms="
                     f"{r['feed_ms']:.4f} bucket_count_ms={r['count_ms']:.4f}")
        else:
            extra = (" (as the engine calls it, wrapper included) alone "
                     f"(graph replay): kernel_only_ms={r['kernel_only_ms']:.4f}"
                     f" turn_spread_mean={r['turn_spread']:.4f} p3_launch_ms="
                     f"{r['p3_ms']:.4f} zero_launch_ms={r['zero_ms']:.4f} "
                     f"work_estimate_ms={r['work_ms']:.4f} "
                     f"padded_bound_ms={r['padded_bound_ms']:.4f}")
        log(f"(c) {name}: mean over {len(rows)} levels of one {graph} "
            f"B={batch} wave, both ops bit-exact on each: kernel_ms="
            f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
            f"{r['bound_ms']:.4f} (bytes={r['bytes']:.0f}) share_of_bound="
            f"{r['bound_ms'] / r['ms']:.3f} library_ms=null{extra}")
    return out


# -- the P3 kernels K3 and K4 ------------------------------------------------

P3_ODD_W = (1, 31, 127, 129, 8191)          # 8191 is prime


def p3_words(shape, seed: int, dev) -> torch.Tensor:
    """Random int32 words (bit 31 set in about half of them)."""
    w = np.random.default_rng(seed).integers(0, 2**32, shape,
                                             dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def check_p3(kernel, plain, cand, vis, what: str) -> int:
    return assert_same(kernel(cand, vis), plain(cand, vis), what)


def phase_p3_small(n_pad: int, batch: int, dev) -> int:
    """K4 and K3 against their plain versions on odd and prime word
    counts, all-ones words, bit 31, 4-byte-misaligned views (the scalar
    path), and at their real sizes: K4 at n_pad / 32 words, K3 at
    [ceil(batch / 32), n_pad]."""
    err, cases = 0, 0
    g_real = -(-batch // 32)
    for w in P3_ODD_W + (n_pad // 32,):
        c, v = p3_words((w,), w, dev), p3_words((w,), w + 1, dev)
        c[: min(w, 5)] = -1
        err = max(err, check_p3(kbu.bitmap_update, ref.bitmap_update_ref,
                                c, v, f"K4 w={w}"))
        if w > 1:
            err = max(err, assert_same(
                kbu.bitmap_update(c[1:], v[1:]),
                ref.bitmap_update_ref(c[1:].clone(), v[1:].clone()),
                f"K4 misaligned w={w - 1}"))
        cases += 1
    for g in sorted({1, 2, 3, g_real}):
        for w in P3_ODD_W + ((n_pad,) if g == g_real else ()):
            c = p3_words((g, w), g * w, dev)
            v = p3_words((g, w), g * w + 1, dev)
            c[0] = -1                        # an all-ones plane
            v[-1] = 0                        # a plane with nothing seen
            err = max(err, check_p3(kbu.bitmap_update_batch,
                                    ref.bitmap_update_batch_ref, c, v,
                                    f"K3 g={g} w={w}"))
            cases += 1
    full = torch.full((g_real, n_pad), -1, dtype=torch.int32, device=dev)
    nf, _, cnt = kbu.bitmap_update_batch(full, torch.zeros_like(full))
    if not bool((cnt == n_pad * 32).all()) or not torch.equal(nf, full):
        raise AssertionError("K3 all-ones planes: wrong words or counts")
    torch.cuda.synchronize()
    log(f"(c) P3 small cases: {cases} cases + misaligned views + all-ones "
        "planes, K3 and K4 bit-exact")
    return err


def capture_p3(g, keys: np.ndarray, roots: np.ndarray) -> tuple[list, list]:
    """The inputs of every P3 call of one single-source run from each of
    ``keys`` ((h)'s runs: K4, cloned, since the runner reuses its output
    sets two levels on) and of one bool-plane wave over ``roots`` (K3)."""
    k4, k3 = [], []
    orig4, orig3 = ops.fused_frontier_update, ops.fused_frontier_update_batch

    def spy4(cand, vis, out=None):
        k4.append((cand.clone(), vis.clone()))
        return orig4(cand, vis, out=out)

    def spy3(cand, vis):
        k3.append((cand, vis))
        return orig3(cand, vis)

    ops.fused_frontier_update = spy4
    ops.fused_frontier_update_batch = spy3
    try:
        runner = BFSRunner(g)
        for r in keys:
            runner.run(int(r))
        MultiSourceBFSRunner(g, packed=False).run(roots)
    finally:
        ops.fused_frontier_update = orig4
        ops.fused_frontier_update_batch = orig3
    return k4, k3


def k4_alone(c: torch.Tensor, v: torch.Tensor, reps: int) -> dict:
    """K4 alone: outputs made once, the C launch function's launch replayed
    from a CUDA graph (device time, :func:`graph_ms`), in turns forward
    then back: as the wrapper launches it (the last CTA sums the
    partials) and as the first design ran (K3's launch at one plane: an
    atomic a block into a count zeroed once).  Each gives the same
    outputs.  Returns the means and the larger spread of a variant's two
    turns over its mean."""
    lib = kbu._lib()
    new, vout = torch.empty_like(c), torch.empty_like(v)
    cnt = torch.zeros((1, 1), dtype=torch.int32, device=c.device)
    scratch = kbu.scratch_for(c.device).data_ptr()
    ptrs = (c.data_ptr(), v.data_ptr(), new.data_ptr(), vout.data_ptr(),
            cnt.data_ptr())
    w = int(c.numel())
    variants = {
        "kernel_only_ms": lambda st: lib.bitmap_update_launch(
            *ptrs, scratch, w, st),
        "atomic_ms": lambda st: lib.bitmap_update_batch_launch(
            *ptrs, 1, w, st)}

    def run(name):
        _build.raise_on_error(variants[name](_build.stream_ptr(c.device)),
                              f"K4 {name}")

    want = ref.bitmap_update_ref(c, v)
    for name in variants:
        cnt.zero_()
        run(name)
        assert_same((new, vout, cnt), want, f"K4 alone {name}")
    t = {name: [] for name in variants}
    for name in [*variants, *reversed(variants)]:
        t[name].append(graph_ms(lambda: run(name), reps))
    out = {name: float(np.mean(x)) for name, x in t.items()}
    out["turn_spread"] = max(abs(x[0] - x[1]) / np.mean(x)
                             for x in t.values())
    return out


def phase_p3_real(g, keys: np.ndarray, roots: np.ndarray) -> dict:
    """K4 and K3 against their plain versions on every level's real
    inputs, timed level by level (means over the levels): K4 over every
    level of (h)'s 64 single-source runs, as the runner calls it (into
    out= buffers), with fresh outputs, and alone (:func:`k4_alone`); K3
    over one bool-plane wave, with the two [n_pad, nw] -> [nw, n_pad]
    transposes around each call."""
    k4, k3 = capture_p3(g, keys, roots)
    out, trans_ms = {}, []
    for name, kern, plain, calls in (
            ("bitmap_update", kbu.bitmap_update, ref.bitmap_update_ref, k4),
            ("bitmap_update_batch", kbu.bitmap_update_batch,
             ref.bitmap_update_batch_ref, k3)):
        rows = []
        for lvl, (c, v) in enumerate(calls):
            e = check_p3(kern, plain, c, v, f"{name} level {lvl}")
            nbytes = kbu.p3_bytes(c)
            row = dict(max_abs_err=e, bytes=nbytes, bound_ms=bound(nbytes)[0],
                       plain_ms=time_ms(lambda: plain(c, v), 3))
            if c.dim() == 1:
                o = (torch.empty_like(c), torch.empty_like(v),
                     torch.empty((1, 1), dtype=torch.int32, device=c.device))
                e = max(e, assert_same(kern(c, v, out=o), plain(c, v),
                                       f"{name} out= level {lvl}"))
                row.update(max_abs_err=e,
                           ms=time_ms(lambda: kern(c, v, out=o), 20),
                           fresh_ms=time_ms(lambda: kern(c, v), 20),
                           **k4_alone(c, v, 50))
            else:
                row["ms"] = time_ms(lambda: kern(c, v), 20)
                # the engine's planes come [n_pad, nw]: two copies per call
                cp, vp = c.T.contiguous(), v.T.contiguous()
                trans_ms.append(time_ms(
                    lambda: (cp.T.contiguous(), vp.T.contiguous()), 20))
            rows.append(row)
        out[name] = {k: float(np.mean([r[k] for r in rows]))
                     for k in rows[0] if k != "max_abs_err"}
        out[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        r = out[name]
        where = ("(h)'s 64 single-source runs" if c.dim() == 1
                 else "one bool-plane wave")
        log(f"(c) {name}: mean over the {len(rows)} P3 calls of {where} "
            f"(shape {tuple(c.shape)}), bit-exact on each: kernel_ms="
            f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
            f"{r['bound_ms']:.5f} (bytes={r['bytes']:.0f}) library_ms=null")
        if name == "bitmap_update":
            log(f"(c) bitmap_update: wrapper into out= buffers (as the runner "
                f"calls it) {r['ms']:.5f} ms, with fresh outputs "
                f"{r['fresh_ms']:.5f}; alone (C launch function, graph "
                f"replay): as launched {r['kernel_only_ms']:.5f}, the first "
                f"design (an atomic a block, count zeroed once) "
                f"{r['atomic_ms']:.5f} "
                f"(turn spread mean {r['turn_spread']:.4f}; bound "
                f"{r['bound_ms']:.5f})")
    out["transpose_ms"] = float(np.mean(trans_ms))
    log(f"(c) K3's two input transposes ([n_pad, nw] -> [nw, n_pad], cand "
        f"and seen): {out['transpose_ms']:.4f} ms per call (mean over "
        f"{len(trans_ms)} calls)")
    return out


# -- validation of a served wave --------------------------------------------

def graph500_validate(ds, roots: np.ndarray, levels: np.ndarray, iters: int,
                      dev) -> None:
    """Every plane on the card: root at 0, values in [0, iters] or INF, no
    edge u->v with level[v] > level[u] + 1, and every reached non-root has
    an in-neighbour at level - 1."""
    n = levels.shape[1]
    # rows arrive [B, n]: transpose them on the card, not on the host
    lv = torch.from_numpy(np.ascontiguousarray(levels)).to(dev)
    lv = lv.T.contiguous()                                      # [n, B]
    b = lv.shape[1]
    chunk = max((1 << 28) // b, 1 << 16)    # edges a pass: 1 GB of levels
    cols = torch.arange(b, device=dev)
    r = torch.from_numpy(roots.astype(np.int64)).to(dev)
    if bool((lv[r, cols] != 0).any()):
        raise AssertionError("a plane's root is not at level 0")
    finite = lv < INF
    if bool(((lv < 0) | (finite & (lv > iters))).any()):
        raise AssertionError(f"level values outside [0, {iters}] or INF")
    src_all = torch.from_numpy(edge_sources(ds.csr)).to(dev)
    dst_all = torch.from_numpy(ds.csr.indices).to(dev)
    has_parent = torch.zeros((n, b), dtype=torch.int32, device=dev)
    for s in range(0, src_all.shape[0], chunk):
        u = src_all[s: s + chunk].to(torch.int64)
        v = dst_all[s: s + chunk].to(torch.int64)
        lu, lvv = lv[u], lv[v]
        if bool(((lu < INF) & (lvv > lu + 1)).any()):
            raise AssertionError("an edge u->v has level[v] > level[u] + 1")
        has_parent.index_add_(0, v, ((lu < INF) & (lu == lvv - 1)).to(
            torch.int32))
    nonroot = finite & (lv > 0)
    if bool((nonroot & (has_parent == 0)).any()):
        raise AssertionError("a reached vertex has no in-neighbour at "
                             "level - 1")


def numpy_bfs(indptr: np.ndarray, indices: np.ndarray, root: int
              ) -> np.ndarray:
    """Vectorised level-synchronous BFS on the host."""
    level = np.full(indptr.shape[0] - 1, INF, dtype=np.int64)
    level[root] = 0
    front = np.asarray([root], np.int64)
    d = 0
    while front.size:
        starts = indptr[front]
        deg = indptr[front + 1] - starts
        total = int(deg.sum())
        if total == 0:
            break
        first = np.cumsum(deg) - deg
        idx = np.repeat(starts - first, deg) + np.arange(total)
        fresh = np.zeros(level.shape[0], dtype=bool)
        fresh[indices[idx]] = True
        fresh &= level == INF
        nbr = np.flatnonzero(fresh)
        d += 1
        level[nbr] = d
        front = nbr
    return level


def phase_serve(graph: str, batch: int, seed: int, dev, tile_rows,
                label: str) -> dict:
    ds = get_dataset(graph)
    reset_launches()
    t0 = time.perf_counter()
    out = serve_bfs(graph, batch, seed, device=dev, tile_rows=tile_rows,
                    keep_levels=True)
    wall = time.perf_counter() - t0
    counts = launches()
    roots, levels = out.pop("roots"), out.pop("levels")
    for k in ("traversed_per_plane", "discovery_popcounts"):
        out.pop(k, None)
    log(f"({label}) serve_bfs({graph!r}, {batch}, tile_rows={tile_rows}) "
        f"wall={wall:.2f}s launches={counts}")
    log(f"({label}) " + json.dumps(out))
    if out["host_transfers"] != out["iterations"] + 2:
        raise AssertionError(f"host_transfers {out['host_transfers']} != "
                             f"iterations + 2 ({out['iterations'] + 2})")
    t0 = time.perf_counter()
    graph500_validate(ds, roots, levels, out["iterations"], dev)
    log(f"({label}) Graph500 validation of all {batch} planes passed "
        f"({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    for i in range(4):
        want = numpy_bfs(ds.csr.indptr, ds.csr.indices, int(roots[i]))
        if not np.array_equal(levels[i].astype(np.int64), want):
            raise AssertionError(f"root {roots[i]}: levels differ from the "
                                 "numpy BFS")
    log(f"({label}) 4 roots equal the numpy BFS "
        f"({time.perf_counter() - t0:.2f}s)")
    return dict(out=out, launches=counts, levels=levels, roots=roots)


def plan_turns(g, deg: np.ndarray, batch: int, seed: int) -> dict:
    """Wave seconds of the tiled plan (K2 at the auto tile size) and the
    whole-array plan (K1) on one graph in turns (tiled, whole, whole,
    tiled) after one warm-up wave each, through ``bfs_batch``; the two
    plans' levels must be equal.  Returns the seconds by plan and the
    plan the auto rule picks at this batch."""
    from repro_torch.launch.serve import bfs_batch
    roots = np.random.default_rng(seed).choice(np.flatnonzero(deg > 0),
                                               batch, replace=False)
    nw = -(-batch // 32)
    tr = ops._auto_tile_rows(nw)
    engines = {"tiled": MultiSourceBFSRunner(g, tile_rows=tr),
               "whole": MultiSourceBFSRunner(g, tile_rows=0)}
    want = None
    for name, engine in engines.items():                 # warm-up
        levels = bfs_batch(roots, engine=engine, out_deg=deg)["levels"]
        if want is None:
            want = levels
        elif not np.array_equal(levels, want):
            raise AssertionError(f"B={batch}: tiled and whole-array plans' "
                                 "levels differ")
    del want, levels
    secs = {"tiled": [], "whole": []}
    levels_s = {"tiled": [], "whole": []}
    for name in ("tiled", "whole", "whole", "tiled"):
        out = bfs_batch(roots, engine=engines[name], out_deg=deg)
        secs[name].append(out["seconds"])
        levels_s[name].append(sum(engines[name].last_level_seconds))
        log(f"(o) turn B={batch} {name}: wave seconds={out['seconds']} "
            f"aggregate_teps={out['aggregate_teps']:.4e} levels' seconds="
            f"{levels_s[name][-1]:.4f} iterations={out['iterations']}")
    auto = "tiled" if ops.propagate_plan(g.n_pad, nw)["tiled"] else "whole"
    by_wave = min(secs, key=lambda k: sum(secs[k]))
    by_levels = min(levels_s, key=lambda k: sum(levels_s[k]))
    log(f"(o) plan turns B={batch} (tile_rows={tr}): wave seconds tiled "
        f"{secs['tiled']} whole {secs['whole']}, levels' seconds (the "
        f"traversal before the readback, which both plans share) tiled "
        f"{[round(x, 4) for x in levels_s['tiled']]} whole "
        f"{[round(x, 4) for x in levels_s['whole']]}; faster by wave: "
        f"{by_wave}, by levels: {by_levels}; the auto plan picks: {auto}")
    return dict(seconds=secs, level_seconds=levels_s, auto=auto)


def phase_wide(graph: str, seed: int, dev) -> dict:
    """(o) ``serve_bfs`` at WIDE_BATCH with the tiled and the whole-array
    plan, every plane validated, the two plans' levels equal."""
    nw = -(-WIDE_BATCH // 32)
    tiled = phase_serve(graph, WIDE_BATCH, seed, dev,
                        ops._auto_tile_rows(nw), "o")
    whole = phase_serve(graph, WIDE_BATCH, seed, dev, 0, "o")
    if not np.array_equal(tiled["levels"], whole["levels"]):
        raise AssertionError(f"B={WIDE_BATCH}: tiled and whole-array plans' "
                             "levels differ")
    log(f"(o) B={WIDE_BATCH}: the two plans' levels are equal")
    return dict(tiled=tiled, whole=whole)


def phase_sbfs(ds, g, roots: np.ndarray, dev) -> dict:
    """(h) The paper's metric: one single-source BFS per root, GTEPS each
    (traversed out-degrees over the run's wall time, the final readback
    excluded as in the reference)."""
    runner = BFSRunner(g)
    reset_launches()
    runner.run(int(roots[0]))                        # warm-up root
    results = [runner.run(int(r)) for r in roots]
    counts = launches()
    bad = [(int(r), res.host_transfers, res.iterations, res.overflow_retries)
           for r, res in zip(roots, results)
           if res.host_transfers != res.iterations + 2 + res.overflow_retries]
    if bad:
        raise AssertionError(f"host_transfers != iterations + 2 + overflow "
                             f"retries for (root, transfers, iterations, "
                             f"retries) {bad[:4]}")
    gteps = np.asarray([res.gteps for res in results])
    iters = [res.iterations for res in results]
    log(f"(h) BFSRunner on {len(roots)} roots after one warm-up root: "
        f"launches={counts}")
    log(f"(h) GTEPS min={gteps.min():.4f} median={np.median(gteps):.4f} "
        f"harmonic_mean={statistics.harmonic_mean(gteps):.4f} "
        f"max={gteps.max():.4f}; seconds per root median="
        f"{np.median([res.seconds for res in results]):.5f}")
    log(f"(h) levels per root: {iters}; overflow retries: "
        f"{sum(res.overflow_retries for res in results)}; host_transfers == "
        "iterations + 2 + overflow retries on every root")
    levels = np.stack([res.level for res in results])
    t0 = time.perf_counter()
    graph500_validate(ds, roots, levels, max(iters), dev)
    log(f"(h) Graph500 validation of all {len(roots)} roots passed "
        f"({time.perf_counter() - t0:.2f}s)")
    for i in range(4):
        want = numpy_bfs(ds.csr.indptr, ds.csr.indices, int(roots[i]))
        if not np.array_equal(levels[i].astype(np.int64), want):
            raise AssertionError(f"root {roots[i]}: single-source levels "
                                 "differ from the numpy BFS")
    log("(h) 4 roots equal the numpy BFS")
    return dict(launches=counts, gteps=gteps, level0=levels[0])


def phase_boolplane(g, roots: np.ndarray, want: np.ndarray, out_deg,
                    d_teps: float) -> dict:
    """(i) The bool-plane baseline through the serving entry (warm-up +
    timed wave) on (d)'s roots; its levels must equal (d)'s."""
    from repro_torch.launch.serve import bfs_batch
    runner = MultiSourceBFSRunner(g, packed=False)
    reset_launches()
    bfs_batch(roots, engine=runner, out_deg=out_deg)    # warm-up
    out = bfs_batch(roots, engine=runner, out_deg=out_deg)
    counts = launches()
    if not np.array_equal(out.pop("levels"), want):
        raise AssertionError("bool-plane levels differ from (d)'s")
    log(f"(i) MultiSourceBFSRunner(packed=False) B={roots.size}: launches="
        f"{counts}")
    log(f"(i) wave seconds={out['seconds']} aggregate_teps="
        f"{out['aggregate_teps']:.4e} (packed wave (d): {d_teps:.4e}); "
        f"iterations={out['iterations']} host_transfers="
        f"{out['host_transfers']}; levels equal (d)'s")
    return dict(launches=counts, out=out)


def phase_programs(graph: str, batch: int, seed: int, dev, d: dict) -> None:
    """(j) CC and SSSP through ``serve_bfs``: SSSP's distances equal (d)'s
    levels (unit weights); CC's levels and labels equal what (d)'s levels
    give (the graph is symmetric, so CC traverses the same arcs)."""
    for algo in ("sssp", "cc"):
        t0 = time.perf_counter()
        out = serve_bfs(graph, batch, seed, algo=algo, device=dev,
                        keep_levels=True)
        wall = time.perf_counter() - t0
        roots, levels = out.pop("roots"), out.pop("levels")
        if not np.array_equal(roots, d["roots"]):
            raise AssertionError(f"{algo}: roots differ from (d)'s")
        if not np.array_equal(levels, d["levels"]):
            raise AssertionError(f"{algo}: value rows differ from (d)'s "
                                 "levels")
        if out["host_transfers"] != out["iterations"] + 2:
            raise AssertionError(f"{algo}: host_transfers != iterations + 2")
        extra = ""
        if algo == "cc":
            labels = component_labels(levels, roots)
            if not np.array_equal(labels,
                                  component_labels(d["levels"], roots)):
                raise AssertionError("cc: labels differ from (d)'s reach")
            extra = (f" components={out['components']} labelled vertices="
                     f"{int((labels >= 0).sum())}")
        log(f"(j) serve_bfs(algo={algo!r}) wall={wall:.2f}s wave seconds="
            f"{out['seconds']} aggregate_teps={out['aggregate_teps']:.4e} "
            f"iterations={out['iterations']}{extra}; equal to (d)")


def phase_integrity(g, roots: np.ndarray, want: np.ndarray) -> None:
    """(k) A witness wave equals (d)'s levels; a wave with one frontier
    bit flipped at level 1 must raise IntegrityError."""
    runner = MultiSourceBFSRunner(g, integrity="witness")
    res = runner.run(roots)
    if not np.array_equal(res.levels, want):
        raise AssertionError("witness wave levels differ from (d)'s")
    if res.host_transfers != res.iterations + 2:
        raise AssertionError("witness wave: host_transfers != iterations + 2")
    log(f"(k) witness wave: levels equal (d)'s, integrity="
        f"{json.dumps(runner.last_stats['integrity'])} host_transfers="
        f"{res.host_transfers} seconds={res.seconds:.4f}")
    # plane 0's frontier bit at a vertex of level >= 3 (or unreached),
    # set at level 1: a discovery no edge can explain
    far = int(np.flatnonzero(want[0] >= 3)[0])
    runner._corrupt_plane = (1, far, 0)
    try:
        runner.run(roots)
    except IntegrityError as exc:
        log(f"(k) injected flip (level 1, vertex {far}, plane 0) raised "
            f"IntegrityError: {exc}")
    else:
        raise AssertionError("an injected plane bit flip went undetected")


# -- (p) supervised async serving, (q) chaos on the card ----------------------

SERVE_REQUESTS, POOL_REQUESTS = 256, 128
SERVE_WINDOW, SERVE_MAX_BATCH = 0.05, 64
# IntegrityConfig's seed 0 draws 0.637, 0.270, 0.041, 0.017, ...: at 0.05
# the third and fourth waves of a run are audited, so the closed loop's
# four full waves give two audits
SERVE_AUDIT_RATE = 0.05


@contextlib.contextmanager
def counted_from_stream(marks: dict):
    """Reset the launch counts where ``serve_bfs_async`` starts its stream
    (its call of ``drive_open_loop``), past the engine build and the
    warm-up waves, so what ``launches()`` reads after it is the served
    waves' and the audits' alone.  ``marks`` gets the seconds the build
    and warm-up took and the seconds the audits' re-runs took."""
    from repro_torch.ft import supervisor
    from repro_torch.launch import dynbatch
    drive, t0 = dynbatch.drive_open_loop, time.perf_counter()
    audit = supervisor.EngineSupervisor._differential_audit
    marks["audit_seconds"] = 0.0

    def drive_counted(*a, **kw):
        marks["build_warmup_seconds"] = round(time.perf_counter() - t0, 4)
        reset_launches()
        return drive(*a, **kw)

    def audit_timed(self, *a, **kw):
        t = time.perf_counter()
        try:
            return audit(self, *a, **kw)
        finally:
            marks["audit_seconds"] += time.perf_counter() - t

    dynbatch.drive_open_loop = drive_counted
    supervisor.EngineSupervisor._differential_audit = audit_timed
    try:
        yield
    finally:
        dynbatch.drive_open_loop = drive
        supervisor.EngineSupervisor._differential_audit = audit
        marks["audit_seconds"] = round(marks["audit_seconds"], 4)


def serve_run(ds, graph: str, seed: int, dev, label: str, requests: int,
              **kw) -> dict:
    """One ``serve_bfs_async`` run, launch counts reset as its stream
    starts; every served row validated on the card; the fault-free
    contract held.  Returns its stats (without the rows), the stream's
    launches and where the call's wall time went."""
    reset_launches()
    marks = {}
    t0 = time.perf_counter()
    with counted_from_stream(marks):
        out = serve_bfs_async(graph, requests=requests, window=SERVE_WINDOW,
                              max_batch=SERVE_MAX_BATCH, pipeline=True,
                              ft_max_retries=2, ft_integrity="audit",
                              ft_audit_rate=SERVE_AUDIT_RATE, seed=seed,
                              device=dev, keep_levels=True, **kw)
    wall = time.perf_counter() - t0
    counts = launches()
    if "build_warmup_seconds" not in marks:
        raise AssertionError(f"({label}) the stream never started")
    roots, levels = out.pop("roots"), out.pop("levels")
    fts = out["fault_tolerance"]
    fts = fts if isinstance(fts, list) else [fts]
    summary = dict(
        waves=out["waves"],
        mean_batch=round(out["requests"] / max(out["waves"], 1), 2),
        latency_p50=out["latency_p50"], latency_p99=out["latency_p99"],
        aggregate_teps=out["aggregate_teps"],
        busy_seconds=out["busy_seconds"],
        engine_idle_seconds=out["engine_idle_seconds"],
        stream_seconds=round(out["stream_seconds"], 4),
        busy_share=round(out["busy_seconds"] / out["stream_seconds"], 4),
        sustained_rps=round(roots.size / out["stream_seconds"], 2),
        rate=out["rate"], supervisor=fts, integrity=out["integrity"],
        launches=counts, call_seconds=round(wall, 4), **marks)
    log(f"({label}) serve_bfs_async({graph!r}, {requests} requests, "
        f"{kw}) wall={wall:.2f}s: engine build and warm-up "
        f"{marks['build_warmup_seconds']:.2f}s, stream "
        f"{out['stream_seconds']:.2f}s (engine busy "
        f"{out['busy_seconds']:.2f}s, audits {marks['audit_seconds']:.2f}s)")
    log(f"({label}) " + json.dumps(summary))
    if out.get("errors") or out.get("requests_failed") or \
            roots.size != requests:
        raise AssertionError(f"({label}) {requests - roots.size} requests "
                             f"failed: errors={out.get('errors')}")
    for ft in fts:
        for k in ("retries", "timeouts", "bisections"):
            if ft[k]:
                raise AssertionError(f"({label}) supervisor {k}={ft[k]} in "
                                     "a fault-free run")
        if ft["demotions"] or ft["quarantined"]:
            raise AssertionError(f"({label}) demotions {ft['demotions']} "
                                 f"quarantined {ft['quarantined']}")
    if out["integrity"]["audit_failures"] or out["integrity"]["violations"]:
        raise AssertionError(f"({label}) integrity {out['integrity']}")
    if counts["msbfs_propagate_planes"] <= 0:
        raise AssertionError(f"({label}) the served waves never launched K1")
    if out["integrity"]["audits"] and counts["bitmap_update_batch"] <= 0:
        raise AssertionError(f"({label}) the audits never launched K3")
    t0 = time.perf_counter()
    graph500_validate(ds, roots, levels, ds.csr.num_vertices, dev)
    summary["validate_seconds"] = round(time.perf_counter() - t0, 4)
    log(f"({label}) Graph500 validation of all {roots.size} served rows "
        f"passed ({summary['validate_seconds']:.2f}s)")
    return summary


def phase_serve_async(ds, g, graph: str, seed: int, dev) -> dict:
    """(p) Closed loop, open loop at half its sustained rate, a pool of
    two workers; then one 64-root wave of the served stream's roots split
    into its levels and its readback, and what the audit tier adds to
    it."""
    from repro_torch.ft import check_level_rows
    from repro_torch.launch.serve import bfs_batch
    t_phase = time.perf_counter()
    closed = serve_run(ds, graph, seed, dev, "p closed", SERVE_REQUESTS)
    rate = 0.5 * closed["sustained_rps"]
    opened = serve_run(ds, graph, seed, dev, "p open", SERVE_REQUESTS,
                       rate=rate)
    pool = serve_run(ds, graph, seed, dev, "p pool", POOL_REQUESTS,
                     workers=2)
    audits = sum(r["integrity"]["audits"] for r in (closed, opened, pool))
    if closed["integrity"]["audits"] < 2:
        raise AssertionError(f"(p) closed loop audited "
                             f"{closed['integrity']['audits']} waves, "
                             "expected at least 2")
    deg = np.diff(ds.csr.indptr)
    roots = np.random.default_rng(seed).choice(
        np.flatnonzero(deg > 0), SERVE_MAX_BATCH, replace=True)
    runner = MultiSourceBFSRunner(g)
    bfs_batch(roots, engine=runner, out_deg=deg)          # warm-up
    w = bfs_batch(roots, engine=runner, out_deg=deg)
    lv = sum(runner.last_level_seconds)
    split = dict(wave_seconds=w["seconds"], levels_seconds=round(lv, 4),
                 readback_seconds=round(w["seconds"] - lv, 4),
                 readback_share=round(1 - lv / w["seconds"], 4))
    # what the audit tier adds to a served wave: the runner's own checks
    # (statvec slot, witness, host row guards) inside the wave, then the
    # supervisor's host row check and the per-request row copies after it
    runner.integrity = "audit"              # the same runner, already warm
    a = bfs_batch(roots, engine=runner, out_deg=deg)
    t0 = time.perf_counter()
    check_level_rows(a["levels"], roots, a["iterations"])
    t1 = time.perf_counter()
    copies = [np.ascontiguousarray(r) for r in a["levels"]]
    t2 = time.perf_counter()
    del copies
    split.update(audit_tier_wave_seconds=a["seconds"],
                 host_row_check_seconds=round(t1 - t0, 4),
                 row_copies_seconds=round(t2 - t1, 4))
    phase_s = round(time.perf_counter() - t_phase, 4)
    log(f"(p) audits over the three runs: {audits}; a served wave of "
        f"{SERVE_MAX_BATCH}: {json.dumps(split)}; (p) took {phase_s:.2f}s")
    return dict(closed=closed, open=opened, pool=pool, audits=audits,
                audit_rate=SERVE_AUDIT_RATE, wave_split=split,
                phase_seconds=phase_s)


class GuardedRunner(MultiSourceBFSRunner):
    """A card runner that fails the run if anything turns its kernels off
    (the card has no plain torch rung)."""

    def __setattr__(self, name, value):
        if name == "use_kernels" and not value:
            raise AssertionError("use_kernels set to False on a CUDA runner")
        super().__setattr__(name, value)


CHAOS_WAVES = ((0, 32), (32, 64), (64, 96), (96, 112), (112, 128))
# engine-call index -> fault: calls 0-2 are the first wave (two kernel
# faults, then the demoted wave); 3-14 the second (the out-of-range root
# first, isolated in six failing calls, 13 a clean half hit by a runtime
# fault); 15-16 the stuck wave; 17-18 the plane flip; 19-20 the result flip
CHAOS_PLAN = ((0, "kernel"), (1, "kernel"), (13, "runtime"), (15, "stuck"),
              (17, "plane_flip"), (19, "result_flip"))
CHAOS_DEADLINE, CHAOS_STALL = 1.0, 2.0


def phase_chaos(ds, g, deg: np.ndarray, seed: int, dev) -> dict:
    """(q) The fault schedule of ``tests/test_torch_chaos.py`` on the card,
    one fake-clock wave at a time."""
    from repro_torch.ft import (EngineSupervisor, FaultPlan, FaultyEngine,
                                RequestQuarantined, WaveAbandoned,
                                WaveTimeout)
    from repro_torch.launch.dynbatch import BFSFuture, DynamicBatcher
    t_phase = time.perf_counter()
    runner = GuardedRunner(g)
    roots = np.random.default_rng(seed + 1).choice(
        np.flatnonzero(deg > 0), CHAOS_WAVES[-1][1]).astype(np.int64)
    bad = int(g.n) + 5
    packed0 = runner.run(roots[:32]).levels          # also the warm-up
    row = runner.run(roots[96:112]).levels[0]
    far = int(np.flatnonzero(row >= 3)[0])           # INF counts too
    chaos = FaultyEngine(runner, FaultPlan(CHAOS_PLAN),
                         plane_flip=(1, far, 0), result_flip=(0, 0, 16),
                         stall_seconds=CHAOS_STALL)
    sup = EngineSupervisor(chaos, integrity="witness", max_retries=3,
                           wave_deadline=CHAOS_DEADLINE)
    clock = [0.0]
    batcher = DynamicBatcher(sup, out_deg=deg, window=1.0, max_batch=32,
                             clock=lambda: clock[0])
    futures, per_wave = [], []
    t_all = time.perf_counter()
    for w, (lo, hi) in enumerate(CHAOS_WAVES):
        if w == 1:      # past submit()'s check, as a redispatch would be
            f = BFSFuture(bad, clock[0])
            batcher._submit_future(f)
            futures.append(f)
            lo += 1
        futures += [batcher.submit(int(r), block=False)
                    for r in roots[lo:hi]]
        reset_launches()
        t0 = time.perf_counter()
        ws = batcher.flush()
        secs = time.perf_counter() - t0
        counts = launches()
        z = sup._zombie
        if z is not None:
            z.join(60.0)
        if len(ws) != 1:
            raise AssertionError(f"(q) wave {w} cut into {len(ws)} waves")
        rec = dict(wave=w, batch=ws[0].batch, traversals=ws[0].traversals,
                   retries=ws[0].retries, timeouts=ws[0].timeouts,
                   failed=ws[0].failed, quarantined=ws[0].quarantined,
                   demotions=ws[0].demotions, seconds=round(secs, 4),
                   launches=counts)
        per_wave.append(rec)
        log(f"(q) wave {w}: {json.dumps(rec)}")
        if runner.use_kernels is not True:
            raise AssertionError("(q) a CUDA runner lost its kernels")
    batcher.close()
    wall = time.perf_counter() - t_all
    st = sup.stats()
    log(f"(q) supervisor {json.dumps(st)} injected={chaos.plan.injected} "
        f"flips={chaos.flips} wall={wall:.2f}s")
    w0 = per_wave[0]
    if w0["demotions"] != ["kernels->boolplane"]:
        raise AssertionError(f"(q) wave 0 demotions {w0['demotions']}")
    if w0["launches"]["bitmap_update_batch"] <= 0:
        raise AssertionError("(q) the demoted wave never launched K3")
    if any(r["launches"]["msbfs_propagate_planes"] <= 0
           for r in per_wave[1:]):
        raise AssertionError("(q) a packed wave never launched K1")
    if chaos.plan.pending():
        raise AssertionError(f"(q) faults never fired: "
                             f"{chaos.plan.pending()}")
    typed = (WaveAbandoned, RequestQuarantined, WaveTimeout)
    ok_roots, ok_rows = [], []
    for f in futures:
        exc = f.exception(timeout=0)
        if not f.done():
            raise AssertionError(f"(q) root {f.root} never resolved")
        if exc is None:
            ok_roots.append(f.root)
            ok_rows.append(f.result(timeout=0))
        elif not isinstance(exc, typed):
            raise AssertionError(f"(q) root {f.root}: untyped {exc!r}")
        elif f.root != bad:
            raise AssertionError(f"(q) clean root {f.root} failed: {exc!r}")
    bad_f = [f for f in futures if f.root == bad]
    if not (len(bad_f) == 1 and isinstance(bad_f[0].exception(),
                                           RequestQuarantined)
            and st["quarantined"] == [bad]):
        raise AssertionError("(q) the out-of-range root was not quarantined")
    if st["integrity"]["violations"] < 2 or len(chaos.flips) != 2:
        raise AssertionError(f"(q) flips {chaos.flips} violations "
                             f"{st['integrity']['violations']}")
    if st["timeouts"] < 1:
        raise AssertionError("(q) the stuck wave never timed out")
    ok_rows = np.stack(ok_rows)
    if not np.array_equal(ok_rows[:32], packed0):
        raise AssertionError("(q) the demoted wave's rows differ from the "
                             "packed engine's")
    t0 = time.perf_counter()
    graph500_validate(ds, np.asarray(ok_roots), ok_rows,
                      ds.csr.num_vertices, dev)
    phase_s = round(time.perf_counter() - t_phase, 4)
    log(f"(q) {len(ok_roots)} served rows validated Graph500-style "
        f"({time.perf_counter() - t0:.2f}s); the demoted wave's rows equal "
        "the packed engine's; the out-of-range root quarantined; neither "
        f"flip served; (q) took {phase_s:.2f}s")
    return dict(supervisor=st, waves=per_wave, wall_seconds=round(wall, 4),
                served=len(ok_roots), requests=len(futures),
                deadline=CHAOS_DEADLINE, stall_seconds=CHAOS_STALL,
                phase_seconds=phase_s)


# -- (r) the distributed engine on one H100 ---------------------------------

DIST_CONFIG = "scalabfs-32pc-64pe"   # the paper's peak configuration
FIG10_PES = (1, 4, 16, 64)           # PEs on one card (Fig. 10's direction)
FIG10_ROOTS = 8
FIG10_QUEUE_CAPACITY = 1 << 18       # FIFO depth of (r2)'s queue run


@contextlib.contextmanager
def nccl_group():
    """A one-rank NCCL group on cuda:0 (a file store in a temporary
    directory, no network) and its ("data",) mesh of 1, destroyed after.
    One all-reduce creates the communicator before anything is timed."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1,), ("data",))
            one = torch.ones(1, device="cuda")
            dist.all_reduce(one)
            if float(one) != 1.0:
                raise AssertionError("a one-rank all-reduce changed its "
                                     "input")
            yield mesh
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def k2_per_step(eng, captured: dict):
    """Record every call of the engine's batched push and pull steps in
    order, as (kind, K2's launches in it), and keep the first K2 call's
    inputs and outputs (cloned) for the check against the plain
    version."""
    steps = captured.setdefault("steps", [])

    def counted(kind, step):
        def call(*a, **kw):
            before = kmod.LAUNCHES["msbfs_propagate_planes_tiled"]
            out = step(*a, **kw)
            steps.append((kind, kmod.LAUNCHES["msbfs_propagate_planes_tiled"]
                          - before))
            return out
        return call

    tiled = ops.msbfs_propagate_planes_tiled

    def tiled_kept(seen, msg, tgt, ct, heads, tile_rows, block_edges,
                   op="or"):
        out = tiled(seen, msg, tgt, ct, heads, tile_rows, block_edges, op)
        if "k2_call" not in captured:
            captured["k2_call"] = (
                [t.clone() for t in (seen, msg, tgt, ct, heads)],
                tile_rows, block_edges, op, [t.clone() for t in out])
        return out

    eng._push_b = counted("push", eng._push_b)
    eng._pull_b = counted("pull", eng._pull_b)
    ops.msbfs_propagate_planes_tiled = tiled_kept
    try:
        yield
    finally:
        del eng._push_b, eng._pull_b
        ops.msbfs_propagate_planes_tiled = tiled


def dist_wave(ds, pg, mesh, roots: np.ndarray, want: np.ndarray,
              deg: np.ndarray, dev, profile: bool) -> dict:
    """(r1) One ``run_batch`` wave of the paper's peak configuration: every
    plane validated, the rows equal to (d)'s, K2 on every pull level and
    one of its calls equal to the plain version; then one warm wave,
    whose rows must be the same (profiled with ``profile``)."""
    from repro_torch.configs import CONFIGS
    from repro_torch.core.bfs_distributed import (DistributedBFS,
                                                  pull_tile_rows)
    from repro_torch.core.bfs_local import count_traversed_edges
    eng = DistributedBFS(pg, mesh, cfg=CONFIGS[DIST_CONFIG].dist_config())
    if not eng.use_kernels:
        raise AssertionError("the distributed engine on the card runs "
                             "without its kernels")
    captured: dict = {}
    with k2_per_step(eng, captured):
        reset_launches()
        t0 = time.perf_counter()
        rows = eng.run_batch(roots)
        wave_s = time.perf_counter() - t0
        counts = launches()
    stats = dict(eng.last_stats)
    level_s = [round(x, 4) for x in eng.last_level_seconds]
    steps = captured["steps"]
    per_pull = [n for kind, n in steps if kind == "pull"]
    if len(per_pull) < stats["pull_iters"] or min(per_pull, default=0) < 1:
        raise AssertionError(f"K2 did not launch on every pull level: "
                             f"{steps} over {stats['pull_iters']} levels")
    args, tile_rows, block_edges, op, got = captured["k2_call"]
    want_k2 = ref.msbfs_propagate_planes_tiled_ref(*args[:4], tile_rows,
                                                   block_edges, op=op)
    err = assert_same(got, want_k2, "(r1) K2 on a pull level")
    del captured, args, got, want_k2
    t0 = time.perf_counter()
    graph500_validate(ds, roots, rows, stats["iterations"], dev)
    val_s = time.perf_counter() - t0
    if not np.array_equal(rows, want):
        raise AssertionError("(r1) the distributed wave's rows differ from "
                             "(d)'s")
    t0 = time.perf_counter()
    again = eng.run_batch(roots)
    warm_s = time.perf_counter() - t0
    if not np.array_equal(again, rows):
        raise AssertionError("(r1) a second wave's rows differ")
    del again
    nw = -(-roots.size // 32)
    traversed = count_traversed_edges(deg, rows)
    out = dict(config=DIST_CONFIG, shards=pg.num_shards, pes=eng.k,
               verts_per_shard=eng.vl, wave_seconds=round(wave_s, 4),
               level_seconds=round(sum(level_s), 4),
               per_level_seconds=level_s, steps=steps,
               aggregate_teps=traversed / wave_s,
               warm_wave_seconds=round(warm_s, 4),
               warm_level_seconds=round(sum(eng.last_level_seconds), 4),
               warm_aggregate_teps=traversed / warm_s,
               k2_launches=counts["msbfs_propagate_planes_tiled"],
               tile_rows=pull_tile_rows(eng.vl, nw), k2_max_abs_err=err,
               validate_seconds=round(val_s, 4), **stats)
    log(f"(r1) {DIST_CONFIG}: {pg.num_shards} shards on one rank, "
        f"{roots.size} roots: wave {wave_s:.4f}s, levels' seconds "
        f"{out['level_seconds']} ({level_s}), aggregate TEPS "
        f"{out['aggregate_teps']:.4e}, push/pull {stats['push_iters']}/"
        f"{stats['pull_iters']}, steps (kind, K2 launches) {steps}, K2 "
        f"launches {out['k2_launches']}, tile_rows {out['tile_rows']}; "
        f"every plane validated ({val_s:.2f}s), rows equal (d)'s, one K2 "
        f"call equal to its plain version; a warm wave {warm_s:.4f}s "
        f"(levels {out['warm_level_seconds']}), TEPS "
        f"{out['warm_aggregate_teps']:.4e}")
    if profile:
        profile_device(f"(r1) {DIST_CONFIG} warm wave",
                       lambda: eng.run_batch(roots), top=16)
    return out


def dist_fig10(ds, pgs: dict, mesh, keys: np.ndarray, deg: np.ndarray,
               dev) -> dict:
    """(r2) Single-source ``run`` from Graph500 keys at k PEs on one card
    (bitmap, flat), every root against the numpy BFS; then one queue run
    at the most PEs.  Returns the median GTEPS per k."""
    from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
    from repro_torch.core.bfs_local import count_traversed_edges
    t0 = time.perf_counter()
    want = {int(r): numpy_bfs(ds.csr.indptr, ds.csr.indices, int(r))
            for r in keys}
    numpy_s = time.perf_counter() - t0
    out = {}
    for k, pg in pgs.items():
        eng = DistributedBFS(pg, mesh, cfg=DistConfig(dispatch="bitmap",
                                                      crossbar="flat"))
        eng.run(int(keys[0]))                                # warm-up
        gteps, secs = [], []
        for r in keys:
            t0 = time.perf_counter()
            level = eng.run(int(r))
            dt = time.perf_counter() - t0
            if not np.array_equal(level, want[int(r)]):
                raise AssertionError(f"(r2) k={k} root {r}: levels differ "
                                     "from the numpy BFS")
            secs.append(dt)
            gteps.append(count_traversed_edges(deg, level) / dt / 1e9)
        out[k] = dict(median_gteps=float(np.median(gteps)),
                      median_seconds=float(np.median(secs)),
                      iterations=eng.last_stats["iterations"])
        log(f"(r2) k={k} PEs: median GTEPS {out[k]['median_gteps']:.4f} "
            f"(seconds a root {out[k]['median_seconds']:.4f}); "
            f"{len(keys)} roots equal the numpy BFS")
    k = max(pgs)
    eng = DistributedBFS(pgs[k], mesh, cfg=DistConfig(
        dispatch="queue", crossbar="flat",
        queue_capacity=FIG10_QUEUE_CAPACITY))
    t0 = time.perf_counter()
    level = eng.run(int(keys[0]))
    dt = time.perf_counter() - t0
    if not np.array_equal(level, want[int(keys[0])]):
        raise AssertionError(f"(r2) queue dispatch at k={k}: levels differ "
                             "from the numpy BFS")
    log(f"(r2) queue dispatch at k={k} (FIFOs of {FIG10_QUEUE_CAPACITY}): "
        f"root {keys[0]} in {dt:.4f}s equals the numpy BFS; the numpy BFS "
        f"of {len(keys)} roots took {numpy_s:.2f}s")
    return dict(by_pes={str(k): v for k, v in out.items()},
                queue=dict(pes=k, seconds=round(dt, 4)),
                numpy_seconds=round(numpy_s, 4))


def phase_distributed(ds, deg: np.ndarray, roots: np.ndarray,
                      want: np.ndarray, keys: np.ndarray, dev,
                      profile: bool = False) -> dict:
    """(r) The distributed engine in a one-rank NCCL group: (r1) the
    paper's peak configuration's wave, (r2) Fig. 10's PE scaling."""
    from repro_torch.configs import CONFIGS
    from repro_torch.core import partition_graph
    t_phase = time.perf_counter()
    cfg = CONFIGS[DIST_CONFIG]
    q = cfg.num_shards * cfg.pes_per_shard
    t0 = time.perf_counter()
    pgs = {k: partition_graph(ds.csr, ds.csc, k)
           for k in sorted({*FIG10_PES, q})}
    part_s = time.perf_counter() - t0
    pq = pgs[q]
    arrays = (pq.out_indptr, pq.out_indices, pq.in_indptr, pq.in_indices)
    log(f"(r) partitioned {ds.spec.name} into {sorted(pgs)} shards in "
        f"{part_s:.2f}s; at {q}: verts_per_shard {pq.verts_per_shard}, CSR "
        f"{list(pq.out_indices.shape)} + CSC {list(pq.in_indices.shape)} "
        f"int32 lists, {sum(a.nbytes for a in arrays) / 1e6:.1f} MB with "
        "the int64 offsets")
    with nccl_group() as mesh:
        r1 = dist_wave(ds, pgs[q], mesh, roots, want, deg, dev, profile)
        r2 = dist_fig10(ds, {k: pgs[k] for k in FIG10_PES}, mesh,
                        keys[:FIG10_ROOTS], deg, dev)
    phase_s = round(time.perf_counter() - t_phase, 4)
    log(f"(r) took {phase_s:.2f}s")
    return dict(r1=r1, r2=r2, partition_seconds=round(part_s, 4),
                phase_seconds=phase_s)


# -- (s) step analysis, the dry-run and the analytic model -----------------

DRYRUN_TIMEOUT = 600             # seconds (s2)'s eight cells may take in all
# (s2)'s cells at a time: a cell's process spends most of its time
# importing torch and its lazy modules and reaching the card, not on the
# card, so four at a time share the host's cores with (s1)'s CPU wave
DRYRUN_JOBS = 4


def counted(run):
    """``run()`` under a ``StepAnalysis``: (its result, the analysis)."""
    with StepAnalysis() as a:
        out = run()
    return out, a


def same_counts(card, cpu, what: str) -> None:
    if card.result() != cpu.result() or card.kernels != cpu.kernels:
        raise AssertionError(
            f"(s1) {what}: the card counts {card.result()} {card.kernels}, "
            f"the CPU {cpu.result()} {cpu.kernels}")


def counted_calls(a, counts: dict, what: str) -> None:
    """Every kernel the run launched was reported as often as it
    launched, and nothing else was."""
    for name in set(counts) | set(a.kernels):
        n = a.kernels.get(name, {}).get("calls", 0)
        if n != counts.get(name, 0):
            raise AssertionError(f"(s1) {what}: {name} counted {n} calls, "
                                 f"launched {counts.get(name, 0)} times")


def per_step_counts(a) -> tuple[list, object]:
    """A list that gets, for every packed step the engine takes while
    ``a`` counts, (level, push?, the step's bytes), and a restore
    function: wraps ``vertex_program``'s two step functions."""
    from repro_torch.core import vertex_program as vp
    rows, saved = [], (vp.vp_push_step, vp.vp_pull_step)

    def wrap(step, push):
        def spy(*args):
            before = a.bytes
            out = step(*args)
            rows.append((int(args[4]), push, a.bytes - before))
            return out
        return spy

    vp.vp_push_step, vp.vp_pull_step = wrap(saved[0], True), wrap(saved[1],
                                                                  False)

    def restore():
        vp.vp_push_step, vp.vp_pull_step = saved
    return rows, restore


def start_dryrun(out_dir: str) -> subprocess.Popen:
    """(s2) ``python -m repro_torch.launch.dryrun --all`` on the card, in a
    process group of its own, so that stopping it stops every cell."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), "--out", out_dir], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def check_dryrun(proc: subprocess.Popen, out_dir: str) -> list:
    """(s2)'s result: every cell recorded, its shard fields equal to the
    reference's arithmetic (``repro.core.bfs_distributed.abstract``), its
    steps counted; each step's peak bytes logged against the card's
    memory."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"(s2) the dry-run took over {DRYRUN_TIMEOUT} s")
    for line in out.strip().splitlines():
        log(f"(s2) {line}")
    if proc.returncode != 0:
        raise AssertionError(f"(s2) the dry-run failed ({proc.returncode})")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for path, args in dryrun.all_cells(out_dir):
        rec = json.loads(Path(path).read_text())
        spec = DATASETS[args[1]]
        n = 1 << spec.scale
        q = 512 if "--multi-pod" in args else 256
        vl = -(-(-(-n // q)) // 32) * 32
        e = int(vl * spec.edge_factor * (1 if spec.directed else 2))
        want = dict(num_vertices=n, shards=q, verts_per_shard=vl,
                    edge_budget=max(-(-e // 128) * 128, 128), n_devices=q,
                    device=torch.cuda.get_device_name(0))
        got = {k: rec[k] for k in want}
        if got != want:
            raise AssertionError(f"(s2) {Path(path).name}: {got} != {want}")
        for phase in ("push", "pull"):
            p = rec[phase]
            peak = p["memory"]["peak_bytes"]
            if not (peak and p["per_device"]["bytes"] > 0):
                raise AssertionError(f"(s2) {Path(path).name} {phase}: "
                                     f"peak {peak}, {p['per_device']}")
            rows.append(dict(cell=Path(path).stem, phase=phase,
                             step_s=p["step_s"], peak_bytes=peak,
                             bytes=p["per_device"]["bytes"],
                             collective_by_op=p["per_device"][
                                 "collective_by_op"],
                             bound_s=p["roofline"]["bound_s"]))
            log(f"(s2) {Path(path).stem} {phase}: setup_s="
                f"{rec['setup_s']:.2f} shards={q} vl={vl} "
                f"edge_budget={want['edge_budget']} step_s={p['step_s']:.5f}"
                f" peak={peak} bytes ({peak / card_bytes:.5f} of the card's "
                f"{card_bytes}) counted bytes={p['per_device']['bytes']:.0f} "
                f"collectives={p['per_device']['collective_by_op']} bound_s="
                f"{p['roofline']['bound_s']:.3e}")
    return rows


def phase_analysis(ds, g, deg: np.ndarray, d: dict,
                   keys: np.ndarray) -> dict:
    """(s1) (d)'s wave and one (h) root counted on the card and on the
    CPU, (s2) the dry-run's eight cells, (s3) the analytic model."""
    t_phase = time.perf_counter()
    roots, root = d["roots"], int(keys[0])
    k1_calls = []
    orig = ops.msbfs_propagate_planes

    def spy(*args, **kw):
        k1_calls.append((args, kw))
        return orig(*args, **kw)

    # (s1) the card: the wave, each packed step's bytes, its K1 calls
    with StepAnalysis() as wave:
        steps, restore = per_step_counts(wave)
        ops.msbfs_propagate_planes = spy
        reset_launches()
        try:
            res = MultiSourceBFSRunner(g).run(roots)
        finally:
            ops.msbfs_propagate_planes = orig
            restore()
        wave_counts = launches()
    counted_calls(wave, wave_counts, "wave")
    if not np.array_equal(res.levels, d["levels"]):
        raise AssertionError("(s1) the counted wave's levels differ from (d)")
    k1_sum = sum(k1_bytes(a[0], a[2], a[3], kw["valid"], kw["n_edges"])[0]
                 for a, kw in k1_calls)
    if wave.kernels["msbfs_propagate_planes"]["bytes"] != k1_sum:
        raise AssertionError(f"(s1) K1 counted {wave.kernels} bytes, "
                             f"k1_bytes {k1_sum}")
    del k1_calls
    runner = BFSRunner(g)
    runner.run(root)                                    # warm-up
    root_s = runner.run(root).seconds
    reset_launches()
    _, one = counted(lambda: runner.run(root))
    counted_calls(one, launches(), "root")

    # (s2) the dry-run runs on the card while the CPU counts
    with tempfile.TemporaryDirectory() as out_dir:
        proc = start_dryrun(out_dir)
        try:
            t0 = time.perf_counter()
            g_cpu = build_local_graph(ds.csr, ds.csc, device="cpu")
            _, cpu_wave = counted(lambda: MultiSourceBFSRunner(
                g_cpu, use_kernels=True).run(roots))
            cpu_runner = BFSRunner(g_cpu, use_kernels=True)
            _, cpu_one = counted(lambda: cpu_runner.run(root))
            cpu_s = time.perf_counter() - t0
            del g_cpu, cpu_runner
            same_counts(wave, cpu_wave, "the wave")
            same_counts(one, cpu_one, "the root")
            cells = check_dryrun(proc, out_dir)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()

    out = d["out"]
    lv = out["level_seconds"]
    w = roofline_terms(wave.result())
    r = roofline_terms(one.result())
    by_level = {}
    for lvl, push, nbytes in steps:
        row = by_level.setdefault(lvl, dict(push=push, bytes=0.0))
        row["bytes"] += nbytes
    if len(by_level) != len(lv):
        raise AssertionError(f"(s1) {len(by_level)} counted levels, (d) "
                             f"timed {len(lv)}")
    levels = []
    for lvl, row in sorted(by_level.items()):
        b_ms = bound(row["bytes"])[0]
        levels.append(dict(level=lvl, mode="push" if row["push"] else "pull",
                           bytes=row["bytes"], bound_ms=b_ms,
                           measured_ms=lv[lvl] * 1e3,
                           share=b_ms / (lv[lvl] * 1e3)))
        log(f"(s1) level {lvl} ({levels[-1]['mode']}): counted bytes="
            f"{row['bytes']:.0f} bound_ms={b_ms:.4f} (d)'s level ms="
            f"{lv[lvl] * 1e3:.4f} share of bound={levels[-1]['share']:.4f}")
    log(f"(s1) (d)'s wave ({len(roots)} roots, {res.iterations} levels) "
        f"counted on the card: flops={wave.flops:.0f} "
        f"bytes={wave.bytes:.0f} collective_bytes={wave.collective_bytes:.0f}"
        f" kernels={wave.kernels}; bound {w['bound_s'] * 1e3:.4f} ms "
        f"({w['dominant']}); (d) measured wave {out['seconds']:.4f} s, "
        f"levels {sum(lv):.4f} s: the levels reach "
        f"{w['bound_s'] / sum(lv):.4f} of the bound, the wave "
        f"{w['bound_s'] / out['seconds']:.4f}")
    log(f"(s1) one (h) root {root} counted: bytes={one.bytes:.0f} kernels="
        f"{one.kernels}; bound {r['bound_s'] * 1e3:.4f} ms, measured "
        f"{root_s:.5f} s: share {r['bound_s'] / root_s:.4f}")
    log(f"(s1) K1 and K4 counted as launched ({wave_counts}), K1's bytes "
        f"equal k1_bytes ({k1_sum}); the CPU's counts of the same wave and "
        f"root (use_kernels=True, {cpu_s:.2f}s) equal the card's")
    len_nl = ds.csr.indices.size / ds.csr.num_vertices
    model = h100_model_teps(1, len_nl)
    log(f"(s3) h100_model_teps(1, len_nl={len_nl:.4f}) = {model:.4e} TEPS; "
        f"(d) measured {out['aggregate_teps']:.4e} "
        f"({out['aggregate_teps'] / model:.4f} of the model)")
    phase_s = time.perf_counter() - t_phase
    log(f"(s) took {phase_s:.2f}s")
    return dict(
        wave=dict(per_device=wave.result(), kernels=wave.kernels,
                  bound_s=w["bound_s"], seconds=out["seconds"],
                  level_seconds=sum(lv), levels=levels),
        root=dict(root=root, per_device=one.result(), kernels=one.kernels,
                  bound_s=r["bound_s"], seconds=root_s),
        cpu_seconds=cpu_s, dryrun=cells,
        model=dict(len_nl=len_nl, h100_model_teps=model,
                   measured_teps=out["aggregate_teps"]),
        phase_seconds=phase_s)


# -- (l) the paged CSR gather K5 ---------------------------------------------

GATHER_PAGE = 128                # the real size's page (512 bytes)
REASSEMBLE = 1000                # neighbour lists rebuilt from the pages


def time_row(kernel, plain, library, nbytes, flops, err, reps) -> dict:
    """Kernel, plain and library times (``library`` None = no such call)
    beside the roofline bound of the same work."""
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=time_ms(kernel, reps), plain_ms=time_ms(plain, 1),
                library_ms=None if library is None else time_ms(library, reps),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                max_abs_err=err)


def log_row(name: str, r: dict, what: str) -> None:
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    vs = ("" if r["library_ms"] is None else
          f" kernel/library={r['ms'] / r['library_ms']:.3f}")
    log(f"({what}) {name}: kernel_ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} library_ms={lib} bound_ms={r['bound_ms']:.5f} "
        f"(by {r['bound_by']}: bytes={r['bytes']:.0f} flops={r['flops']:.4g})"
        f" share_of_bound={r['bound_ms'] / r['ms']:.3f}{vs}"
        f" max_abs_err={r['max_abs_err']} launches={r.get('launches')}")


def phase_gather(ds, level0: np.ndarray, dev) -> dict:
    """(l) K5 bit-exact on adversarial cases, then on its path at a real
    size: ``read_neighbor_pages`` over the graph's edge array for the
    largest level of one single-source root."""
    cases = 0
    for page in (1, 3, 128, 512):
        for m in (0, 1, 17):
            rng = np.random.default_rng(page * 31 + m)
            n_pages = 7
            edges = torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (n_pages, page)).astype(np.int32)).to(dev)
            ids = torch.from_numpy(rng.integers(
                -3 * n_pages, 3 * n_pages, m).astype(np.int32)).to(dev)
            if m:
                ids[0], ids[-1] = -3 * n_pages, 3 * n_pages   # both ends
            if not torch.equal(kcg.gather_pages(edges, ids),
                               ref.gather_pages_ref(edges, ids)):
                raise AssertionError(f"K5 page={page} m={m} differs")
            cases += 1
    for page in (4, 128):          # 4 bytes off 16-byte alignment
        flat = torch.arange(9 * page + 1, dtype=torch.int32, device=dev)
        edges = flat[1:].view(9, page)
        ids = torch.tensor([0, 8, 3, -1, 12, 5], dtype=torch.int32,
                           device=dev)
        if edges.data_ptr() % 16 != 4 or not torch.equal(
                kcg.gather_pages(edges, ids),
                ref.gather_pages_ref(edges, ids)):
            raise AssertionError(f"K5 misaligned page={page} differs")
        cases += 1
    torch.cuda.synchronize()
    log(f"(l) K5 small cases: {cases} (page 1/3/128/512 x m 0/1/17, ids "
        "out of range both sides, misaligned edge arrays), bit-exact")

    # the largest level of the root, its vertices' page table
    reached = level0[level0 < INF]
    lvl = int(np.bincount(reached).argmax())
    vs = np.flatnonzero(level0 == lvl)
    indptr = ds.csr.indptr.astype(np.int64)
    starts, deg = indptr[vs], indptr[vs + 1] - indptr[vs]
    page = GATHER_PAGE
    live = deg > 0
    need = int(((starts + deg - 1) // page - starts // page + 1)[live].sum())
    t0 = time.perf_counter()
    pids, owner, offs = ops.build_page_table(starts, deg, page, need)
    t_table = time.perf_counter() - t0
    flat = ds.csr.indices.astype(np.int32)
    flat = np.concatenate([flat, np.zeros((-flat.size) % page, np.int32)])
    edges = torch.from_numpy(flat).to(dev)
    pids_d = torch.from_numpy(pids).to(dev)
    reset_launches()
    out = ops.read_neighbor_pages(edges, pids_d, page)
    torch.cuda.synchronize()
    count = launches()["gather_pages"]
    paged = edges.view(-1, page)
    if not torch.equal(out, ref.gather_pages_ref(paged, pids_d)):
        raise AssertionError("K5 at the real size differs from plain")
    # rebuild sampled neighbour lists from the fetched pages
    rng = np.random.default_rng(13)
    sample = rng.choice(np.flatnonzero(live), min(REASSEMBLE, int(live.sum())),
                        replace=False)
    lo = np.searchsorted(owner[:need], sample)
    hi = np.searchsorted(owner[:need], sample, side="right")
    items = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    rows = out[torch.from_numpy(items).to(dev)].cpu().numpy()
    at = 0
    for j, a, b in zip(sample, lo, hi):
        got = np.concatenate([rows[at + i] for i in range(b - a)])
        at += b - a
        first = offs[a]
        want = ds.csr.indices[starts[j]: starts[j] + deg[j]]
        if not np.array_equal(got[first: first + deg[j]], want):
            raise AssertionError(f"K5: vertex {vs[j]}'s neighbour list "
                                 "differs from the CSR")
    # short lists share pages: the bound (kcg.gather_bytes) reads the
    # distinct pages once and writes every item's page once
    m, distinct = need, int(np.unique(pids).size)
    r = time_row(lambda: kcg.gather_pages(paged, pids_d),
                 lambda: ref.gather_pages_ref(paged, pids_d),
                 lambda: paged.index_select(0, pids_d),
                 kcg.gather_bytes(paged, pids_d), 0.0, 0, 10)
    r["launches"] = count
    log(f"(l) level {lvl} of root 0: {vs.size} vertices, {m} pages of "
        f"{page} ({distinct} distinct; build_page_table {t_table:.3f}s), "
        f"{out.numel() * 4} bytes fetched; bit-exact, {sample.size} "
        "neighbour lists reassembled equal to the CSR")
    log_row("gather_pages", r, "l")
    return r


# -- (m) the block-sparse pull SpMV K6 --------------------------------------

HUBS, HUB_BLOCK = 8192, 128      # 64 row blocks of the highest-degree vertices


def spmv_check(blocks, brow, bcol, f, rb: int, what: str) -> None:
    got = kps.pull_spmv_blocks(blocks, brow, bcol, None, f, rb)
    want = ref.pull_spmv_blocks_ref(blocks, brow, bcol, None, f, rb)
    if got.dtype != torch.float32 or not torch.equal(got, want):
        raise AssertionError(f"K6 {what}: accumulator differs")
    if not torch.equal(ops.pull_spmv(blocks, brow, bcol, f, rb), want > 0):
        raise AssertionError(f"K6 {what}: ops.pull_spmv differs")


def phase_spmv_small(dev) -> None:
    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    brow = [0, 0, 2, 2, 2, 3, 5, 5]            # row blocks 1 and 4 empty
    cases = 0
    for b in (16, 128, 256):
        for lanes in (1, 4, 8, 64, 128):
            rng = np.random.default_rng(b + lanes)
            tiles = bf(rng.random((len(brow), b, b)) < 0.2)
            f = bf(rng.random((4, b, lanes)) < 0.3)
            spmv_check(tiles, i32(brow), i32(rng.integers(0, 4, len(brow))),
                       f, 6, f"b={b} L={lanes}")
            cases += 1
    rng = np.random.default_rng(3)
    spmv_check(bf(rng.random((1, 128, 128)) < 0.1), i32([0]), i32([0]),
               bf(rng.random((1, 128, 8)) < 0.5), 1, "single tile")
    ones = torch.ones((5, 256, 256), dtype=torch.bfloat16, device=dev)
    f1 = torch.ones((2, 256, 128), dtype=torch.bfloat16, device=dev)
    spmv_check(ones, i32([0, 0, 0, 0, 1]), i32([0, 1, 0, 1, 1]), f1, 2,
               "all ones")
    torch.cuda.synchronize()
    log(f"(m) K6 small cases: {cases + 2} (b 16/128/256 x L 1/4/8/64/128 "
        "with empty row blocks, a single tile, all-ones tiles and frontier "
        "up to sums of 1024), accumulator bit-exact, ops.pull_spmv equal")


def hub_blocks(ds, dev):
    """The induced adjacency of the HUBS highest out-degree vertices,
    tiled in CSC orientation (rows = children, cols = parents), non-empty
    tiles sorted by (row, col) block, bf16 0/1.  Returns (blocks, brow,
    bcol, hubs, arcs among the hubs)."""
    indptr = ds.csr.indptr.astype(np.int64)
    deg = np.diff(indptr)
    hubs = np.argsort(-deg, kind="stable")[:HUBS]
    pos = np.full(deg.size, -1, np.int64)
    pos[hubs] = np.arange(HUBS)
    d = deg[hubs]
    idx = np.repeat(indptr[hubs] - (np.cumsum(d) - d), d) + np.arange(d.sum())
    parent = np.repeat(np.arange(HUBS), d)
    child = pos[ds.csr.indices[idx]]
    keep = child >= 0
    parent, child = parent[keep], child[keep]
    nblk = HUBS // HUB_BLOCK
    key = (child // HUB_BLOCK) * nblk + parent // HUB_BLOCK
    tiles, tile_of = np.unique(key, return_inverse=True)
    blocks = torch.zeros((tiles.size, HUB_BLOCK, HUB_BLOCK),
                         dtype=torch.bfloat16, device=dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    blocks[t(tile_of), t(child % HUB_BLOCK), t(parent % HUB_BLOCK)] = 1
    return (blocks, t((tiles // nblk).astype(np.int32)),
            t((tiles % nblk).astype(np.int32)), hubs, int(keep.sum()))


def bsr_library(blocks, brow, bcol, f, rb: int):
    """``torch.sparse.mm`` on a BSR tensor of the same tiles, or the reason
    it cannot run here."""
    nb, b, _ = blocks.shape
    ncb, _, lanes = f.shape
    crow = torch.zeros(rb + 1, dtype=torch.int64, device=blocks.device)
    crow[1:] = torch.cumsum(torch.bincount(brow.long(), minlength=rb), 0)
    try:
        with warnings.catch_warnings():       # BSR is "beta" in PyTorch
            warnings.simplefilter("ignore", UserWarning)
            bsr = torch.sparse_bsr_tensor(crow, bcol.long(), blocks,
                                          size=(rb * b, ncb * b))
        dense = f.reshape(ncb * b, lanes)
        fn = lambda: torch.sparse.mm(bsr, dense)         # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn, "torch.sparse.mm(BSR bf16, dense bf16)"
    except Exception as exc:         # a yardstick only; the port never calls it
        return None, f"torch.sparse.mm on BSR bf16 refused: {exc!r}"[:300]


def phase_spmv(ds, d_levels: np.ndarray, dev) -> dict:
    """(m) K6 on adversarial cases, then ``ops.pull_spmv`` over the dense
    hub blocks of the graph with (d)'s level-1 frontier as lanes."""
    phase_spmv_small(dev)
    t0 = time.perf_counter()
    blocks, brow, bcol, hubs, arcs = hub_blocks(ds, dev)
    rb = HUBS // HUB_BLOCK
    lanes = d_levels.shape[0]
    front = (d_levels[:, hubs] == 1).T.astype(np.float32)     # [HUBS, B]
    f = torch.from_numpy(np.ascontiguousarray(front)).to(
        dev, torch.bfloat16).view(rb, HUB_BLOCK, lanes)
    nb = blocks.shape[0]
    log(f"(m) hub blocks: {HUBS} highest-degree vertices, {arcs} arcs among "
        f"them, nb={nb} of {rb * rb} tiles non-empty, b={HUB_BLOCK}, "
        f"L={lanes}, frontier bits={int(front.sum())} "
        f"({time.perf_counter() - t0:.2f}s to build)")
    if not front.any():
        raise AssertionError("(m) the hub vertices hold no level-1 frontier "
                             "bit: the real-size check would prove nothing")
    reset_launches()
    hit = ops.pull_spmv(blocks, brow, bcol, f, rb)
    torch.cuda.synchronize()
    count = launches()["pull_spmv_blocks"]
    want = ref.pull_spmv_blocks_ref(blocks, brow, bcol, None, f, rb)
    got = kps.pull_spmv_blocks(blocks, brow, bcol, None, f, rb)
    if not torch.equal(got, want) or not torch.equal(hit, want > 0):
        raise AssertionError("K6 at the real size differs from plain")
    if not hit.any():
        raise AssertionError("(m) K6 reached no (vertex, lane) pair: the "
                             "bit-exact check compared zeros with zeros")
    log(f"(m) real size: accumulator bit-exact, ops.pull_spmv equal to "
        f"plain > 0; {int(hit.sum())} (vertex, lane) pairs reached, max sum "
        f"{float(want.max()):.0f}")
    lib, what = bsr_library(blocks, brow, bcol, f, rb)
    log(f"(m) library yardstick: {what}")
    r = time_row(lambda: kps.pull_spmv_blocks(blocks, brow, bcol, None, f,
                                              rb),
                 lambda: ref.pull_spmv_blocks_ref(blocks, brow, bcol, None,
                                                  f, rb),
                 lib, *kps.spmv_cost(blocks, f, rb), 0, 10)
    r["launches"] = count
    log_row("pull_spmv_blocks", r, "m")
    return r


# -- (n) flash attention K7 --------------------------------------------------

# |got - want| <= atol + rtol * |want| elementwise.  f32 both ways: only the
# order of the sums differs.  bf16 both ways: each side rounds its f32
# result to bf16 once, so the two differ by at most one bf16 ulp (2^-8 to
# 2^-7 of the value).  The bound follows the values, which shrink as rows
# see more keys: at S = 8192 a causal row's outputs are about 0.02, so a
# flat 2e-2 (the reference test's, set at S <= 512) would prove nothing.
FLASH_TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (1e-3, 8e-3)}
FLASH_RMS = 1e-2    # and rms(got - want) / rms(want) at most this
LLAMA3_8B = (32, 8192, 128)      # heads x flash_threshold x head_dim, batch 1


def flash_err(got, want) -> dict:
    """K7's error against the plain version: the max abs error, its worst
    share of the elementwise bound of ``FLASH_TOL`` (at most 1 to pass),
    and rms(got - want) / rms(want)."""
    atol, rtol = FLASH_TOL[want.dtype]
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return dict(max_abs=float(d.max()),
                share=float((d / (atol + rtol * want.abs())).max()),
                rms_rel=float(d.square().mean().sqrt()
                              / want.square().mean().sqrt()))


def flash_ok(e: dict) -> bool:
    return e["share"] <= 1 and e["rms_rel"] <= FLASH_RMS


def phase_flash(seed: int, dev) -> dict:
    """(n) K7 against the plain version (f32 on the card, TF32 off) on the
    reference test's sweeps, then at llama3-8b's attention."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {dt: dict(max_abs=0.0, share=0.0, rms_rel=0.0)
             for dt in FLASH_TOL}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (32, 64, 128):
            for s, bq, bk in ((128, 64, 128), (256, 128, 64),
                              (512, 64, 256)):
                q, k, v = (torch.randn((2, s, hd), generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(3))
                for causal in (True, False):
                    got = kfa.flash_attention(q, k, v, causal=causal,
                                              block_q=bq, block_k=bk)
                    want = ref.flash_attention_ref(q, k, v, causal=causal)
                    e = flash_err(got, want)
                    if got.dtype != dtype or not flash_ok(e):
                        raise AssertionError(
                            f"K7 {dtype} hd={hd} S={s} bq={bq} bk={bk} "
                            f"causal={causal}: {e} outside {FLASH_TOL[dtype]}"
                            f", rms {FLASH_RMS}")
                    for key in e:
                        worst[dtype][key] = max(worst[dtype][key], e[key])
                    cases += 1
    try:
        kfa.flash_attention(q, k, v, block_q=96, block_k=64)
    except ValueError:
        pass
    else:
        raise AssertionError("K7 took a block that does not divide S")
    torch.cuda.synchronize()
    said = "; ".join(
        f"{str(dt)[6:]}: max abs err {w['max_abs']:.3g}, worst share of "
        f"atol + rtol*|want| {w['share']:.3g} (atol, rtol = "
        f"{FLASH_TOL[dt]}), rms rel {w['rms_rel']:.3g}"
        for dt, w in worst.items())
    log(f"(n) K7 small cases: {cases} (f32/bf16 x hd 32/64/128 x S "
        f"128/256/512 with unequal blocks x causal/full); {said} (rms "
        f"limit {FLASH_RMS}); a block that does not divide S raised")

    bh, s, hd = LLAMA3_8B
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    reset_launches()
    out = kfa.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    torch.cuda.synchronize()
    count = launches()["flash_attention"]
    want = ref.flash_attention_ref(q, k, v, causal=True)
    e = flash_err(out, want)
    finite = bool(torch.isfinite(out).all())
    mean_abs = float(want.float().abs().mean())
    del want
    torch.cuda.empty_cache()
    if not finite or not flash_ok(e):
        raise AssertionError(f"K7 at llama3-8b's attention: finite={finite} "
                             f"{e} outside {FLASH_TOL[torch.bfloat16]}, rms "
                             f"{FLASH_RMS}")
    log(f"(n) llama3-8b attention q/k/v [{bh}, {s}, {hd}] bf16 causal: "
        f"finite; against the plain version max abs err {e['max_abs']:.4g}, "
        f"worst share of atol + rtol*|want| {e['share']:.4g} (atol, rtol = "
        f"{FLASH_TOL[torch.bfloat16]}), rms rel {e['rms_rel']:.4g} (limit "
        f"{FLASH_RMS}); mean |want| {mean_abs:.4g}")
    q4, k4, v4 = (t.view(1, bh, s, hd) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r = time_row(lambda: kfa.flash_attention(q, k, v, causal=True,
                                             block_q=128, block_k=128),
                 lambda: ref.flash_attention_ref(q, k, v, causal=True),
                 lambda: sdpa(q4, k4, v4, is_causal=True),
                 *kfa.attention_cost(q, True), e["max_abs"], 3)
    torch.cuda.empty_cache()
    r["launches"] = count
    r["tol_ok"] = flash_ok(e)
    log_row("flash_attention", r, "n")
    return r


# -- (t) the LM stack ---------------------------------------------------------

LM_RMS = 2e-2            # bf16: rms(card - cpu) / rms(cpu), logits
LM_LOSS = 1e-2           # bf16: |card - cpu| of the loss
LM_STEPS = 4             # serve_step positions a reduced config runs
CONSISTENCY_RMS = 3e-2   # (t2): tokenwise decode against prefill_step
CONSISTENCY_RMS_F32 = 1e-3   # the same on float32 weights
LLAMA_RUN = dict(batch=4, prompt_len=64, gen_tokens=32)
QWEN_LAYERS = 4          # qwen3-moe-30b-a3b's depth cut from 48
QWEN_PROMPT = (2, 2048)  # (t3)'s prefill: batch x tokens
QWEN_DECODE = 8          # (t3)'s decode steps


def rms_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt().clamp(min=1e-30))


def lm_batch(cfg, seed: int, b: int = 2, s: int = 16, enc: int = 8) -> dict:
    """A reduced config's inputs on the CPU (seeded numpy, bf16 floats)."""
    rng = np.random.default_rng(seed)
    batch = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32))}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32))
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, enc, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    return batch


def lm_reduced(name: str, seed: int, dev) -> dict:
    """(t1) one reduced config: bf16 weights from a seeded CPU generator
    copied to the card; ``loss_fn`` and its backward on the card (loss and
    every grad finite), then ``LM_STEPS`` ``serve_step`` positions; the
    card's loss, logits and step logits against the CPU port's."""
    cfg = get_reduced_config(name)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(seed))
    card = tt.init_params(cfg, torch.Generator().manual_seed(seed)).to(dev)
    batch = lm_batch(cfg, seed)
    loss, _ = tt.loss_fn(card, cfg, {k: v.to(dev) for k, v in batch.items()})
    loss.backward()
    bad = [n for n, p in card.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not bool(torch.isfinite(loss)) or bad:
        raise AssertionError(f"(t1) {name}: loss {loss.item()}, grads not "
                             f"finite: {bad[:4]}")
    with torch.no_grad():
        want, _ = tt.loss_fn(cpu, cfg, batch)
        logits_g, _ = tt.forward_train(card, cfg, **{
            k: v.to(dev) for k, v in batch.items() if k != "labels"})
        logits_w, _ = tt.forward_train(cpu, cfg, **{
            k: v for k, v in batch.items() if k != "labels"})
        caches = [tt.init_decode_state(cfg, 2, 8, enc_len=8, device=d)
                  for d in ("cpu", dev)]
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (LM_STEPS, 2), dtype=np.int32))
        step_err = 0.0
        for pos in range(LM_STEPS):
            lw, caches[0] = tt.serve_step(cpu, cfg, caches[0], tokens[pos],
                                          pos)
            lg, caches[1] = tt.serve_step(card, cfg, caches[1],
                                          tokens[pos].to(dev), pos)
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"(t1) {name}: step {pos} not finite")
            step_err = max(step_err, rms_ratio(lg, lw))
    r = dict(loss=loss.item(), loss_err=abs(loss.item() - want.item()),
             logits_rms=rms_ratio(logits_g, logits_w), step_rms=step_err)
    if (r["loss_err"] > LM_LOSS or r["logits_rms"] > LM_RMS
            or r["step_rms"] > LM_RMS):
        raise AssertionError(f"(t1) {name}: {r} outside loss {LM_LOSS}, "
                             f"rms {LM_RMS}")
    return r


def lm_llama(seed: int, dev) -> dict:
    """(t2) the slice's main path: ``greedy_decode`` of llama3-8b at its
    full size on the card, then ``prefill_step`` over the same prompt
    against the tokenwise decode's last prompt position."""
    cfg = get_config("llama3-8b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = greedy_decode("llama3-8b", False, seed=seed, keep_state=True,
                        **LLAMA_RUN)
    decode_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    params = out.pop("params")
    n_layers = sum(len(s) for s in params.segments)
    n_weights = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    norms = (2 * cfg.num_layers + 1) * cfg.d_model   # param_count omits
    if n_layers != cfg.num_layers or n_weights != cfg.param_count() + norms:
        raise AssertionError(f"(t2) llama3-8b has {n_layers} layers and "
                             f"{n_weights} weights")
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = tt.prefill_step(params, cfg, {
            "tokens": torch.from_numpy(out["prompt"]).to(dev)})
        torch.cuda.synchronize()
        prefill_step_s = time.perf_counter() - t0
    got = out.pop("prompt_logits")
    last = out.pop("logits")
    err = rms_ratio(got, want[:, :cfg.vocab_size])
    finite = bool(torch.isfinite(last).all()) and bool(
        torch.isfinite(got).all()) and out["finite"]
    del params, want, got, last
    torch.cuda.empty_cache()
    # the same check on float32 weights (the bf16 ones before rounding):
    # what bf16 leaves of the difference is its rounding
    prompt = out.pop("prompt")
    with torch.inference_mode():
        params = tt.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                                torch.float32)
        caches = tt.init_decode_state(cfg, prompt.shape[0], prompt.shape[1],
                                      torch.float32, device=dev)
        got = decode_loop(params, cfg, caches, prompt, 1)["prompt_logits"]
        want = tt.prefill_step(params, cfg, {
            "tokens": torch.from_numpy(prompt).to(dev)})
        err32 = rms_ratio(got, want[:, :cfg.vocab_size])
    del params, caches, got, want
    torch.cuda.empty_cache()
    r = dict(out, layers=n_layers, param_count=cfg.param_count(),
             weights=n_weights, weight_bytes=weight_bytes, peak_bytes=peak,
             consistency_rms=err, consistency_rms_f32=err32,
             prefill_step_s=prefill_step_s, wall_s=decode_wall)
    if not finite or err > CONSISTENCY_RMS or err32 > CONSISTENCY_RMS_F32:
        raise AssertionError(f"(t2) llama3-8b: finite {finite}, tokenwise "
                             f"against prefill_step rms {err} (limit "
                             f"{CONSISTENCY_RMS}), in float32 {err32} "
                             f"(limit {CONSISTENCY_RMS_F32})")
    return r


@contextlib.contextmanager
def counted_drops(calls: list):
    """Record every ``moe_forward`` call: its input, its module, and the
    (token, slot) pairs it routes and drops (``moe.routing`` on the
    call's own input)."""
    orig = moe.moe_forward

    def counting(x, p, **kw):
        _, kept = moe.routing(x, p, top_k=kw["top_k"], chunk=kw["chunk"],
                              capacity_factor=kw["capacity_factor"])
        calls.append(dict(x=x, p=p, dropped=int((~kept).sum()),
                          pairs=kept.numel()))
        return orig(x, p, **kw)

    moe.moe_forward = counting
    try:
        yield calls
    finally:
        moe.moe_forward = orig


def lm_moe(seed: int, dev) -> dict:
    """(t3) qwen3-moe-30b-a3b at its full width, its depth cut from 48 to
    ``QWEN_LAYERS``: a prefill over ``QWEN_PROMPT`` tokens (once with the
    capacity drops counted layer by layer, once timed) and
    ``QWEN_DECODE`` decode steps on the card (``ep`` falls back to
    ``gather`` on one rank); then the first layer's ``moe_forward`` on
    its prefill input, in float32, on the card against the CPU port."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              num_layers=QWEN_LAYERS)
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    b, s = QWEN_PROMPT
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(prompt).to(dev)}
    calls: list = []
    with torch.inference_mode():
        with counted_drops(calls):
            tt.prefill_step(params, cfg, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = tt.prefill_step(params, cfg, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches = tt.init_decode_state(cfg, b, QWEN_DECODE, device=dev)
        with counted_drops(calls):
            run = decode_loop(params, cfg, caches, prompt[:, :1],
                              QWEN_DECODE)
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(run["logits"]).all())
    pre, dec = calls[:QWEN_LAYERS], calls[QWEN_LAYERS:]
    dropped = sum(c["dropped"] for c in pre)
    pairs = sum(c["pairs"] for c in pre)
    # one layer in float32: the card against the CPU, on the same input
    x32, p = pre[0]["x"].float(), pre[0]["p"]
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              chunk=cfg.moe_chunk)
    with torch.no_grad():
        p_card = moe.MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                         torch.float32, dev)
        p_card.load_state_dict({k: v.float() for k, v in
                                p.state_dict().items()})
        p_cpu = moe.MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                        torch.float32)
        p_cpu.load_state_dict(p_card.state_dict())
        idx_g, kept_g = moe.routing(x32, p_card, **kw)
        y_g, _ = moe.moe_forward(x32, p_card, **kw)
        x_cpu = x32.cpu()
        idx_w, kept_w = moe.routing(x_cpu, p_cpu, **kw)
        y_w, _ = moe.moe_forward(x_cpu, p_cpu, **kw)
        probs = torch.softmax(x_cpu.reshape(-1, cfg.d_model) @ p_cpu.router,
                              -1)
        top = torch.sort(probs, -1, descending=True).values
        gap = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
    same_idx = bool(torch.equal(idx_g.cpu(), idx_w))
    same_drops = bool(torch.equal(kept_g.cpu(), kept_w))
    y_g = y_g.cpu()
    excess = float(((y_g - y_w).abs() - (1e-4 + 1e-4 * y_w.abs())).max())
    r = dict(layers=QWEN_LAYERS, of_layers=48, d_model=cfg.d_model,
             experts=cfg.num_experts, top_k=cfg.top_k, d_ff=cfg.d_ff,
             moe_chunk=cfg.moe_chunk, dispatch=cfg.moe_dispatch,
             param_count=cfg.param_count(), prefill_tokens=b * s,
             prefill_s=prefill_s, prefill_tok_s=b * s / prefill_s,
             decode_steps=QWEN_DECODE,
             decode_s=run["prefill_s"] + run["decode_s"],
             dropped=dropped, pairs=pairs, drop_share=dropped / pairs,
             layer_drop_shares=[c["dropped"] / c["pairs"] for c in pre],
             decode_dropped=sum(c["dropped"] for c in dec),
             decode_pairs=sum(c["pairs"] for c in dec),
             f32_same_top_k=same_idx, f32_same_drops=same_drops,
             f32_max_abs_err=float((y_g - y_w).abs().max()),
             f32_kth_gap_min=gap, finite=finite)
    del params, caches, run, logits, calls, pre, dec, p, p_card, x32, y_g
    torch.cuda.empty_cache()
    if not (finite and same_idx and same_drops and excess <= 0):
        raise AssertionError(f"(t3) qwen3-moe: {r}, excess over 1e-4 + "
                             f"1e-4*|want| {excess}")
    return r


def phase_lm(seed: int, dev, card: str) -> dict:
    """(t) the LM stack on the card: (t1) the ten reduced configs, (t2)
    llama3-8b's greedy decoding at full size, (t3) qwen3-moe-30b-a3b at
    full width and cut depth."""
    t_phase = time.perf_counter()
    t1 = {}
    for name in ARCH_NAMES:
        t1[name] = r = lm_reduced(name, seed, dev)
        log(f"(t1) {name}: loss {r['loss']:.5f}, card against the CPU port: "
            f"loss err {r['loss_err']:.3g} (limit {LM_LOSS}), logits rms "
            f"{r['logits_rms']:.3g}, {LM_STEPS} serve steps rms "
            f"{r['step_rms']:.3g} (limit {LM_RMS}); grads finite")
    t2 = lm_llama(seed, dev)
    log(f"(t2) greedy_decode llama3-8b full size ({t2['layers']} layers, "
        f"param_count {t2['param_count']:.4g}, {t2['weights']} weights, "
        f"{t2['weight_bytes'] / 1e9:.2f} GB bf16) batch {t2['batch']} "
        f"prompt {t2['prompt_len']} gen {t2['gen_tokens']}: prefill "
        f"{t2['prefill_tok_s']} tok/s, decode {t2['decode_tok_s']} tok/s, "
        f"peak {t2['peak_bytes'] / 1e9:.3f} GB allocated; tokenwise against "
        f"prefill_step rms {t2['consistency_rms']:.4g} (limit "
        f"{CONSISTENCY_RMS}), on float32 weights "
        f"{t2['consistency_rms_f32']:.4g} (limit {CONSISTENCY_RMS_F32}); "
        f"finite; {card}")
    t3 = lm_moe(seed, dev)
    log(f"(t3) qwen3-moe-30b-a3b at full width, {t3['layers']} of "
        f"{t3['of_layers']} layers: prefill {t3['prefill_tokens']} tokens "
        f"{t3['prefill_s']:.4f} s, {t3['decode_steps']} decode steps "
        f"{t3['decode_s']:.4f} s; dropped {t3['dropped']} of {t3['pairs']} "
        f"(token, slot) pairs ({t3['drop_share']:.4%}; by layer "
        f"{', '.join(f'{x:.4%}' for x in t3['layer_drop_shares'])}); "
        f"f32 layer card against CPU: same "
        f"top-k {t3['f32_same_top_k']}, same drops {t3['f32_same_drops']}, "
        f"max abs err {t3['f32_max_abs_err']:.3g} (least k-th gap "
        f"{t3['f32_kth_gap_min']:.3g}); {card}")
    phase_s = time.perf_counter() - t_phase
    log(f"(t) {phase_s:.2f}s")
    return dict(card=card, phase_s=phase_s, t1=t1, t2=t2, t3=t3)


def profile_device(label: str, run, top: int = 12,
                   keep: tuple = ("propagate_", "whole_")) -> None:
    """Device time by kernel name over one call of ``run`` (warm, ending in
    a device sync; torch.profiler), and the share of its host wall time
    the device was idle.  Kernels past the ``top`` whose name holds one
    of ``keep`` are listed too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels, copies): a CPU op's device total
    # would count its own kernels a second time
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            r = by_name.setdefault(ev.name, [0.0, 0])
            r[0] += ev.time_range.elapsed_us() / 1e3
            r[1] += 1
    rows = sorted(((ms, c, k) for k, (ms, c) in by_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"(g) profile {label}: wall {wall_ms:.2f} ms (profiled), device "
        f"busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}")
    shown = rows[:top] + [r for r in rows[top:]
                          if any(k in r[2] for k in keep)]
    for ms, count, key in shown:
        log(f"(g)   {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<5d} "
            f"{key[:90]}")


def phase_profile(graph: str, batch: int, seed: int, dev, tile_rows) -> None:
    """(g) One warm wave of ``batch`` roots with ``tile_rows``."""
    from repro_torch.launch.serve import build_engine
    engine, deg = build_engine(graph, device=dev, tile_rows=tile_rows)
    roots = np.random.default_rng(seed).choice(np.flatnonzero(deg > 0),
                                               batch, replace=False)
    engine.run(roots)                                  # warm-up
    profile_device(f"{graph} B={batch} tile_rows={tile_rows} wave",
                   lambda: engine.run(roots))


def phase_profile_sbfs(g, keys: np.ndarray) -> None:
    """(g) One warm single-source root of (h): its median-time key among
    the first five."""
    runner = BFSRunner(g)
    secs = [runner.run(int(r)).seconds for r in keys[:5]]
    root = int(keys[int(np.argsort(secs)[2])])
    runner.run(root)                                   # warm-up
    profile_device(f"(h) single-source root {root} (BFSRunner.run)",
                   lambda: runner.run(root), keep=("p3_update",))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke test of the "
                                 "PyTorch/CUDA port")
    ap.add_argument("--graph", default="rmat20-16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one wave of each kernel plan "
                         "(device time by kernel, idle share)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # (a) card
    card = card_line()
    log(card)
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # (b) build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    log(f"(b) built {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for name in SOURCES:
        for line in ptxas_report(_build.build_logs.get(name, "")):
            log(f"(b) ptxas {name}: {line}")
    log_smem()

    # the graph, its device copy and the roots every phase shares
    ds = get_dataset(args.graph)
    g = build_local_graph(ds.csr, ds.csc, device=dev)
    deg = np.diff(ds.csr.indptr)
    keys = np.random.default_rng(args.seed).choice(
        np.flatnonzero(deg > 0), SEARCH_KEYS, replace=False)
    wave_roots = np.random.default_rng(args.seed).choice(
        np.flatnonzero(deg > 0), args.batch, replace=False)

    # (c) kernels against plain versions; K1 is reported at --batch, K2 at
    # WIDE_BATCH, where the planes outgrow L2 (both are logged at both)
    small_err = phase_small(dev)
    real = phase_real(g, deg, args.graph, args.batch, args.seed)
    wide = phase_real(g, deg, args.graph, WIDE_BATCH, args.seed)
    for name in ("msbfs_propagate_planes", "msbfs_propagate_planes_tiled"):
        real[name]["max_abs_err"] = max(real[name]["max_abs_err"],
                                        wide[name]["max_abs_err"])
    real["msbfs_propagate_planes_tiled"] = wide["msbfs_propagate_planes_tiled"]
    p3_err = phase_p3_small(g.n_pad, args.batch, dev)
    real.update(phase_p3_real(g, keys, wave_roots))

    # (d) serving path, auto plan; (e) whole-array kernel
    d = phase_serve(args.graph, args.batch, args.seed, dev, None, "d")
    e = phase_serve(args.graph, args.batch, args.seed, dev, 0, "e")
    if not np.array_equal(d["levels"], e["levels"]):
        raise AssertionError("whole-array wave levels differ from the auto "
                             "plan's")
    if not np.array_equal(d["roots"], wave_roots):
        raise AssertionError("serve_bfs drew other roots than expected")

    # (o) WIDE_BATCH served with both plans; both plans' waves in turns
    o = phase_wide(args.graph, args.seed, dev)
    for batch in (args.batch, WIDE_BATCH):
        plan_turns(g, deg, batch, args.seed)

    # (h) single-source BFS; (i) bool-plane; (j) CC, SSSP; (k) integrity
    h = phase_sbfs(ds, g, keys, dev)
    i = phase_boolplane(g, wave_roots, d["levels"], deg,
                        d["out"]["aggregate_teps"])
    phase_programs(args.graph, args.batch, args.seed, dev, d)
    phase_integrity(g, wave_roots, d["levels"])

    # (p) supervised async serving; (q) chaos on the card
    serving = dict(p=phase_serve_async(ds, g, args.graph, args.seed, dev),
                   q=phase_chaos(ds, g, deg, args.seed, dev))

    # (r) the distributed engine in a one-rank NCCL group
    distributed = phase_distributed(ds, deg, wave_roots, d["levels"], keys,
                                    dev, args.profile)
    # (s) the step analysis, the dry-run and the analytic model
    analysis = phase_analysis(ds, g, deg, d, keys)
    for name in KERNELS:             # K1-K4: integer work, no library call
        if name in real:
            real[name].update(bound_by="bytes", library_ms=None)

    # (l) K5, (m) K6, (n) K7, each at its real size on its own path
    real["gather_pages"] = phase_gather(ds, h["level0"], dev)
    real["pull_spmv_blocks"] = phase_spmv(ds, d["levels"], dev)
    real["flash_attention"] = phase_flash(args.seed, dev)
    # (t) the LM stack (it launches none of the seven kernels)
    lm = phase_lm(args.seed, dev, card)

    # each kernel's launches on its own path
    counts = {
        "msbfs_propagate_planes": e["launches"]["msbfs_propagate_planes"],
        "msbfs_propagate_planes_tiled":
            o["tiled"]["launches"]["msbfs_propagate_planes_tiled"]
            + distributed["r1"]["k2_launches"],
        "bitmap_update_batch": i["launches"]["bitmap_update_batch"],
        "bitmap_update": h["launches"]["bitmap_update"],
        **{k: real[k]["launches"] for k in ("gather_pages",
                                             "pull_spmv_blocks",
                                             "flash_attention")},
    }
    for name, count in counts.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on its path")

    if args.profile:
        for tr in (ops._auto_tile_rows(-(-args.batch // 32)), 0):
            phase_profile(args.graph, args.batch, args.seed, dev, tr)
        phase_profile_sbfs(g, keys)

    # (f) summary
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = real[name]
        err = r["max_abs_err"]
        if name.startswith("bitmap"):
            err = max(err, p3_err)
        elif name.startswith("msbfs"):
            err = max(err, small_err)
        if not (r["tol_ok"] if name == "flash_attention" else err == 0):
            raise AssertionError(f"{name}: max_abs_err {err}")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=err, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    log(f"(f) total {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps({"serving": serving}))
    log(json.dumps({"distributed": distributed}))
    log(json.dumps({"analysis": analysis}))
    log(json.dumps({"lm": lm}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
