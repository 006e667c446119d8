"""Batched serving on one GPU: LM decode and batched graph queries (port
of ``repro.launch.serve``).

LM path: random weights from a seed, a batch of random prompts fed token
by token through ``serve_step`` (the decode path's cache updates), then
greedy decoding; prints one JSON line with tokens/s:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --reduced --batch 2 --prompt-len 8 --gen-tokens 8 [--device cpu]

Graph path: answer a batch of queries over a device-resident graph with one
multi-source traversal (``bfs_batch``) — the serving analogue of the
paper's "keep every memory channel busy" aggregate-TEPS metric.  The
vertex program is BFS, connected components (``--algo cc``, over the
symmetrized graph) or unit-weight SSSP (``--algo sssp``):

  PYTHONPATH=src python -m repro_torch.launch.serve --bfs-graph rmat20-16 \
      --bfs-batch 64 [--algo bfs|cc|sssp] [--bfs-sparse-pull] [--device cpu]

prints one JSON line.

Async path: stream SINGLE-root queries through the dynamic batcher
(``repro_torch.launch.dynbatch``), which coalesces everything arriving
within a window into one MS-BFS wave and reports latency percentiles and
aggregate TEPS; ``--ft-*`` put the fault-tolerance supervisor
(``repro_torch.ft``) in front of the engine, ``--bfs-workers`` a worker
pool (``repro_torch.launch.pool``):

  PYTHONPATH=src python -m repro_torch.launch.serve --bfs-graph rmat20-16 \
      --bfs-serve-async --bfs-requests 256 --bfs-max-batch 64 \
      --bfs-pipeline --ft-integrity audit [--bfs-rate 200] [--device cpu]

In a process group of more than one rank (``torch.distributed``, started
by the caller), :func:`build_engine` serves from the distributed engine
``core.bfs_distributed.DistributedBFS`` instead, every rank making the
same calls; the rows and what is counted from them come back on rank 0
(the engine's leader) alone.  To serve from one process instead, start
the other ranks from it with ``launch.leader.start_group``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.bfs_local import (INF, build_local_graph,
                                        count_traversed_edges)
from repro_torch.core.vertex_program import (ConnectedComponentsRunner,
                                             MultiSourceBFSRunner,
                                             SSSPRunner, get_program)
from repro_torch.device import resolve_device
from repro_torch.graph import get_dataset, symmetrize_csr
from repro_torch.models.transformer import (init_decode_state, init_params,
                                            serve_step)

RUNNERS = {"bfs": MultiSourceBFSRunner, "cc": ConnectedComponentsRunner,
           "sssp": SSSPRunner}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def decode_loop(params, cfg, caches: list, prompt: np.ndarray,
                gen_tokens: int) -> dict:
    """Feed ``prompt`` (int[B, P]) token by token through ``serve_step``
    from position 0, then decode ``gen_tokens - 1`` more tokens greedily.
    Returns the ``gen_tokens`` tokens (int64[B, gen_tokens], the first
    chosen by the last prompt position), the last prompt position's
    logits, the last step's logits, and the seconds of each phase (to a
    device sync)."""
    dev = params.embed.device
    prompt_t = torch.from_numpy(np.asarray(prompt)).to(dev).long()
    prompt_len = prompt_t.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    tok = prompt_t[:, 0]
    logits = None
    for pos in range(prompt_len):
        logits, caches = serve_step(params, cfg, caches, tok, pos)
        tok = (prompt_t[:, pos + 1] if pos + 1 < prompt_len
               else torch.argmax(logits, -1))
    prompt_logits = logits
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out_tokens = [tok]
    t0 = time.perf_counter()
    for pos in range(prompt_len, prompt_len + gen_tokens - 1):
        logits, caches = serve_step(params, cfg, caches, tok, pos)
        tok = torch.argmax(logits, -1)
        out_tokens.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(tokens=torch.stack(out_tokens, 1), prompt_logits=prompt_logits,
                logits=logits, prefill_s=prefill_s, decode_s=decode_s)


def greedy_decode(arch: str, reduced: bool, batch: int, prompt_len: int,
                  gen_tokens: int, cache_len: int = 0, seed: int = 0, *,
                  device=None, keep_state: bool = False) -> dict:
    """Serve one batch of ``arch`` (its reduced config when ``reduced``)
    on ``device`` (None = the CUDA card): bf16 weights drawn from
    ``seed`` on the device, ``batch`` random prompts of ``prompt_len``
    tokens (numpy, ``seed``) fed through the decode path
    (:func:`decode_loop`), then ``gen_tokens`` greedy tokens.  Returns
    the reference's keys; ``keep_state=True`` also returns the
    ``params``, the ``prompt`` and the last prompt position's logits
    (``prompt_logits``) and the last step's (``logits``)."""
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed))
    cache_len = cache_len or (prompt_len + gen_tokens)
    enc_len = max(prompt_len // 2, 8) if cfg.encoder_layers else 0
    caches = init_decode_state(cfg, batch, cache_len, enc_len=enc_len,
                               device=dev)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                          dtype=np.int32)
    run = decode_loop(params, cfg, caches, prompt, gen_tokens)
    gen = run["tokens"].cpu().numpy()
    out = {
        "arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
        "gen_tokens": gen_tokens,
        "prefill_tok_s": round(batch * prompt_len
                               / max(run["prefill_s"], 1e-9), 1),
        "decode_tok_s": round(batch * (gen_tokens - 1)
                              / max(run["decode_s"], 1e-9), 1),
        "sample_output": gen[0][:12].tolist(),
        "finite": bool(torch.isfinite(run["logits"].float()).all()),
    }
    if keep_state:
        out.update(params=params, prompt=prompt,
                   prompt_logits=run["prompt_logits"], logits=run["logits"])
    return out


def build_engine(graph: str, *, algo: str = "bfs", device=None,
                 distributed: bool | None = None, pes_per_device: int = 2,
                 tile_rows: int | None = None, sparse_pull: bool = False):
    """Build a vertex-program query engine with the graph resident on
    ``device`` (None = the CUDA card).

    ``algo``: "bfs" | "cc" | "sssp"; an unknown name raises ValueError.
    CC symmetrizes the graph first (components are an undirected notion).
    ``distributed``: None means a process group of more than one rank is
    initialised; then the engine is ``DistributedBFS`` carrying the
    program over a ``("data",)`` mesh of every rank, the graph partitioned
    into ``world * pes_per_device`` shards (2 PEs per PC by default, the
    paper's Table II shape), every rank calling this with the same
    arguments.  Otherwise the local runner for the program, where
    ``sparse_pull=True`` takes the budgeted pull on tail levels of the
    plain path and ``tile_rows`` picks the propagate kernel; the
    distributed engine ignores both.  Returns (engine, out_degrees of the
    graph traversed).  Build once, reuse across ``bfs_batch`` calls."""
    program = get_program(algo)
    ds = get_dataset(graph)
    csr, csc = ds.csr, ds.csc
    if program.undirected:
        csr = symmetrize_csr(csr)
        csc = csr            # a symmetrized graph is its own transpose
    deg = np.diff(csr.indptr)
    if distributed is None:
        distributed = dist.is_initialized() and dist.get_world_size() > 1
    if distributed:
        from repro_torch.core.bfs_distributed import DistributedBFS
        from repro_torch.core.partition import partition_graph
        from repro_torch.launch.mesh import make_mesh
        # make_mesh raises, saying how to start one, without a group
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh((world,), ("data",), device=device)
        pg = partition_graph(csr, csc, world * pes_per_device)
        return DistributedBFS(pg, mesh, program=program), deg
    g = build_local_graph(csr, csc, device=device)
    engine = RUNNERS[algo](g, tile_rows=tile_rows, sparse_pull=sparse_pull)
    return engine, deg


def build_bfs_engine(graph: str, *, distributed: bool | None = None,
                     pes_per_device: int = 2, device=None):
    """BFS-only wrapper around :func:`build_engine`."""
    return build_engine(graph, algo="bfs", device=device,
                        distributed=distributed,
                        pes_per_device=pes_per_device)


def bfs_batch(roots, *, graph: str = "rmat16-16", engine=None, out_deg=None,
              algo: str = "bfs", device=None) -> dict:
    """Serve a batch of BFS queries in one batched traversal.

    Duplicate roots are allowed; negative or >= |V| roots raise
    ``ValueError``.  Pass a prebuilt ``engine`` (from :func:`build_engine`)
    to keep the graph resident across calls; otherwise one is built for
    ``graph`` on ``device``.  Returns value rows [B, |V|] plus aggregate
    serving stats; on a distributed engine's other ranks the rows are
    None and nothing is counted from them."""
    if engine is None:
        engine, out_deg = build_engine(graph, algo=algo, device=device)
    roots = np.asarray(roots)        # the engine validates (no cast here)
    t0 = time.perf_counter()
    levels = engine.run_batch(roots)
    seconds = time.perf_counter() - t0      # traversal only, not stats
    stats = dict(getattr(engine, "last_stats", {}))
    traversed = stats.pop("traversed_edges", None)
    if out_deg is not None and levels is not None:
        traversed = count_traversed_edges(out_deg, levels)
    stats.pop("seconds", None)
    stats["batch"] = int(roots.size)
    out = dict(levels=levels, seconds=round(seconds, 4), **stats)
    if traversed is not None:
        out["traversed_edges"] = traversed
        out["aggregate_teps"] = round(traversed / max(seconds, 1e-12), 1)
    return out


def serve_bfs(graph: str, batch: int, seed: int = 0, algo: str = "bfs", *,
              device=None, tile_rows: int | None = None,
              sparse_pull: bool = False, keep_levels: bool = False) -> dict:
    """Build the engine, then serve one warm-up wave and one timed wave of
    ``batch`` distinct non-isolated roots drawn from ``seed``.  Returns the
    timed wave's stats; ``keep_levels=True`` also returns its ``roots``
    and ``levels`` (for validation)."""
    engine, deg = build_engine(graph, algo=algo, device=device,
                               tile_rows=tile_rows, sparse_pull=sparse_pull)
    rng = np.random.default_rng(seed)
    roots = rng.choice(np.flatnonzero(deg > 0), batch, replace=False)
    bfs_batch(roots, engine=engine, out_deg=deg)        # warm-up
    out = bfs_batch(roots, engine=engine, out_deg=deg)
    levels = out.pop("levels")
    out.update(graph=graph, algo=algo,
               reached_mean=(None if levels is None
                             else float((levels < INF).sum(1).mean())))
    if keep_levels:
        out.update(roots=roots, levels=levels,
                   level_seconds=list(engine.last_level_seconds))
    return out


def serve_bfs_async(graph: str, requests: int = 64, window: float = 0.05,
                    max_batch: int = 32, rate: float | None = None,
                    seed: int = 0, algo: str = "bfs",
                    workers: int = 1, pipeline: bool = False,
                    slo: float | None = None, sparse_pull: bool = False,
                    ft_max_retries: int | None = None,
                    ft_wave_deadline: float | None = None,
                    ft_chaos: float | None = None,
                    ft_integrity: str | None = None,
                    ft_audit_rate: float = 0.05,
                    pool_evict_after: int | None = None,
                    shed: bool = False, *, device=None,
                    keep_levels: bool = False) -> dict:
    """Serve a stream of single-root queries through the dynamic batcher.

    ``rate`` (req/s) spaces submissions as an open-loop Poisson stream;
    ``rate=None`` submits as fast as possible.  ``algo`` picks the vertex
    program — the batcher itself is engine-agnostic (the ``BFSEngine``
    protocol), so CC and SSSP waves coalesce exactly like BFS waves.  The
    graph lives on ``device`` (None = the CUDA card).

    Serving knobs: ``max_batch`` may span several plane words (e.g. 96 =
    three words per wave); ``pipeline=True`` cuts/pads wave N+1 while
    wave N traverses; ``slo`` attaches that relative deadline (seconds)
    to every request so waves cut urgency-first and ``stats()`` reports
    the miss rate; ``workers > 1`` runs a
    :class:`~repro_torch.launch.pool.WorkerPool` of engines (sharing one
    device-resident graph) behind one submit surface, each worker
    supervised independently when fault tolerance is on.

    Fault tolerance: ``ft_max_retries`` / ``ft_wave_deadline`` wrap the
    engine in an ``EngineSupervisor`` (typed retries, quarantine
    bisection, watchdog, degradation ladder); ``ft_chaos`` additionally
    interposes a ``FaultyEngine`` injecting faults at that per-wave rate.
    With a supervisor, the returned stats carry a ``fault_tolerance``
    block and failed requests resolve with typed errors instead of
    raising here.

    Integrity & resilience: ``ft_integrity`` picks the answer-validation
    tier (``off`` | ``invariants`` | ``witness`` | ``audit``, see
    ``repro_torch.ft.integrity``; implies supervision), ``ft_audit_rate``
    the sampled fraction of clean waves the ``audit`` tier re-runs
    through the reference rung.  ``pool_evict_after`` sets the worker
    pool's consecutive-failure eviction threshold (``workers > 1``);
    ``shed`` turns on admission control.  The returned stats then carry
    an ``integrity`` block (checks / violations / audits / sheds /
    evictions) summed across workers.

    Returns the batcher's aggregate stats (waves, mean batch, latency
    p50/p99, aggregate TEPS over busy time) as a JSON-friendly dict.
    ``keep_levels=True`` also returns the stream's wall time
    (``stream_seconds``, submit of the first request to the drain) and,
    in submission order, the ``roots`` and value rows (``levels``) of
    every request served with a row (for validation).
    """
    from repro_torch.launch.dynbatch import (DynamicBatcher, drive_open_loop,
                                             plane_wave_sizes)

    if workers < 1:
        raise ValueError(f"need workers >= 1, got {workers}")
    engine, deg = build_engine(graph, algo=algo, device=device,
                               sparse_pull=sparse_pull)
    rng = np.random.default_rng(seed)
    roots = rng.choice(np.flatnonzero(deg > 0), requests, replace=True)
    for m in plane_wave_sizes(max_batch):      # warm-up: builds, launches
        bfs_batch(np.resize(roots, m), engine=engine, out_deg=deg)
    # extra workers share the device-resident graph; the kernels are
    # built once per process, so the warm-up above covers every worker
    if workers > 1 and not hasattr(engine, "g"):
        raise ValueError("workers > 1 needs local runner engines "
                         "(a pool of distributed engines is not ported)")
    engines = [engine] + [type(engine)(engine.g, sparse_pull=sparse_pull)
                          for _ in range(workers - 1)]
    supervised = (ft_max_retries is not None or ft_wave_deadline is not None
                  or ft_chaos is not None or ft_integrity is not None)
    if supervised:
        from repro_torch.ft import (EngineSupervisor, FaultPlan,
                                    FaultyEngine, IntegrityConfig)
        integrity = (None if ft_integrity is None else
                     IntegrityConfig(mode=ft_integrity,
                                     audit_rate=ft_audit_rate))
        wrapped = []
        for i, e in enumerate(engines):
            if ft_chaos:
                # rough horizon: every request could end up a singleton
                # wave; each worker draws an independent fault schedule
                plan = FaultPlan.random(max(2 * requests, 16), ft_chaos,
                                        seed=seed + i)
                e = FaultyEngine(e, plan)
            wrapped.append(EngineSupervisor(
                e,
                max_retries=2 if ft_max_retries is None else ft_max_retries,
                wave_deadline=ft_wave_deadline,
                integrity=integrity))
        engines = wrapped
    kw = dict(out_deg=deg, window=window, max_batch=max_batch,
              pipeline=pipeline, shed=shed)
    if len(engines) > 1:
        from repro_torch.launch.pool import WorkerPool
        if pool_evict_after is not None:
            kw["evict_after"] = pool_evict_after
        batcher = WorkerPool(engines, **kw)
    else:
        batcher = DynamicBatcher(engines[0], **kw)
    futures = []
    t0 = time.perf_counter()
    try:
        futures = drive_open_loop(batcher, roots, rate=rate, rng=rng,
                                  raise_errors=not supervised,
                                  deadline=slo, allow_shed=shed)
    finally:
        stream_seconds = time.perf_counter() - t0
        out = batcher.stats()
    out.update(graph=graph, algo=algo, requests=requests, window=window,
               max_batch=max_batch, rate=rate)
    if slo is not None:
        out["slo"] = slo
    if supervised or shed:
        out["integrity"] = _integrity_summary(out)
    if keep_levels:
        served = [f for f in futures if f.exception() is None]
        out.update(stream_seconds=stream_seconds,
                   roots=np.asarray([f.root for f in served], np.int64),
                   levels=(np.stack([f.result(timeout=0) for f in served])
                           if served else None))
    return out


def _integrity_summary(stats: dict) -> dict:
    """One JSON-friendly resilience rollup: integrity detector counters
    summed across workers plus the pool's shedding/eviction totals."""
    ft = stats.get("fault_tolerance")
    blocks = (ft if isinstance(ft, list) else [ft]) if ft else []
    acc = dict(checks=0, violations=0, audits=0, audit_failures=0)
    mode = "off"
    for b in blocks:
        ig = (b or {}).get("integrity")
        if not ig:
            continue
        mode = ig.get("mode", mode)
        for k in acc:
            acc[k] += int(ig.get(k, 0))
    acc["mode"] = mode
    acc["sheds"] = int(stats.get("shed", 0))
    acc["evictions"] = int(stats.get("evictions", 0))
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="serve greedy LM decoding of this "
                    "architecture (configs.ARCH_NAMES)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--bfs-graph",
                    help="serve batched BFS queries over this graph "
                         "instead of LM")
    ap.add_argument("--bfs-batch", type=int, default=32,
                    help="number of concurrent BFS queries")
    ap.add_argument("--algo", choices=tuple(RUNNERS), default="bfs",
                    help="vertex program to serve")
    ap.add_argument("--bfs-sparse-pull", action="store_true",
                    help="budgeted sparse pull on tail levels (reads "
                         "only unvisited vertices' in-lists)")
    ap.add_argument("--bfs-serve-async", action="store_true",
                    help="serve single-root queries through the dynamic "
                         "batcher (launch.dynbatch) instead of one "
                         "pre-batched call")
    ap.add_argument("--bfs-window", type=float, default=0.05,
                    help="coalescing window in seconds (async serving)")
    ap.add_argument("--bfs-max-batch", type=int, default=32,
                    help="wave size cap = plane slots per MS-BFS wave")
    ap.add_argument("--bfs-requests", type=int, default=64,
                    help="number of single-root queries to stream (async)")
    ap.add_argument("--bfs-rate", type=float,
                    help="open-loop Poisson arrival rate in req/s "
                         "(default: submit as fast as possible)")
    ap.add_argument("--bfs-workers", type=int, default=1,
                    help="engine worker pool size (async serving; "
                         "engines share the device-resident graph)")
    ap.add_argument("--bfs-pipeline", action="store_true",
                    help="pipeline wave cutting against the engine "
                         "(cutter/dispatcher/finisher stages)")
    ap.add_argument("--bfs-slo", type=float,
                    help="attach this relative deadline (seconds) to "
                         "every request; waves cut urgency-first and "
                         "stats report the SLO miss rate")
    ap.add_argument("--ft-max-retries", type=int,
                    help="wrap the engine in an EngineSupervisor with this "
                         "transient-retry cap (async serving only)")
    ap.add_argument("--ft-wave-deadline", type=float,
                    help="fixed wave-watchdog deadline in seconds "
                         "(default: auto-calibrated from the running "
                         "median wave time); implies supervision")
    ap.add_argument("--ft-chaos", type=float,
                    help="inject faults at this per-wave rate through the "
                         "deterministic chaos engine (implies supervision)")
    ap.add_argument("--ft-integrity",
                    choices=("off", "invariants", "witness", "audit"),
                    help="traversal-integrity detector tier (implies "
                         "supervision): statvec invariants, sampled "
                         "witness audit, or rate-sampled differential "
                         "audit vs the reference rung")
    ap.add_argument("--ft-audit-rate", type=float, default=0.05,
                    help="fraction of clean waves the audit tier re-runs "
                         "through the reference rung (default 0.05)")
    ap.add_argument("--pool-evict-after", type=int,
                    help="evict a pool worker after this many consecutive "
                         "engine-failure waves (workers > 1; queued and "
                         "failing futures redispatch to survivors)")
    ap.add_argument("--shed", action="store_true",
                    help="admission control: refuse deadline requests "
                         "whose estimated queue delay already exceeds "
                         "their SLO (typed Overloaded, fails fast)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.bfs_graph:
        if not args.arch:
            ap.error("one of --arch or --bfs-graph is required")
        out = greedy_decode(args.arch, args.reduced, args.batch,
                            args.prompt_len, args.gen_tokens,
                            device=args.device)
    elif args.bfs_serve_async:
        out = serve_bfs_async(args.bfs_graph, requests=args.bfs_requests,
                              window=args.bfs_window,
                              max_batch=args.bfs_max_batch,
                              rate=args.bfs_rate, algo=args.algo,
                              workers=args.bfs_workers,
                              pipeline=args.bfs_pipeline,
                              slo=args.bfs_slo,
                              sparse_pull=args.bfs_sparse_pull,
                              ft_max_retries=args.ft_max_retries,
                              ft_wave_deadline=args.ft_wave_deadline,
                              ft_chaos=args.ft_chaos,
                              ft_integrity=args.ft_integrity,
                              ft_audit_rate=args.ft_audit_rate,
                              pool_evict_after=args.pool_evict_after,
                              shed=args.shed, device=args.device)
    else:
        out = serve_bfs(args.bfs_graph, args.bfs_batch, algo=args.algo,
                        device=args.device, sparse_pull=args.bfs_sparse_pull)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
