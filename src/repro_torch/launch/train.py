"""End-to-end training driver: data -> step -> checkpoint/restart (port
of ``repro.launch.train``).

Runs on the CUDA card, or on the CPU when asked (``--device cpu``): the
mesh, shardings, data pipeline, optimizer, async checkpointing, failure
injection/retry and straggler flagging are the reference's code paths.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --reduced --steps 40 --global-batch 8 --seq-len 128 --ckpt-every 10 \
      --inject-failures 17 --ckpt-dir /tmp/repro_ckpt [--device cpu]

Across ranks it runs one process a rank, as the reference runs on every
device of its mesh: inside a started process group :func:`train` builds
``make_test_mesh`` over the group's ranks, every rank draws the whole
state from ``seed`` and keeps its blocks (``distribute_params``,
``place_tree``), makes the global batch of each step and keeps its rows,
runs the sharded step, and saves and restores through ``ckpt`` (one
file, gathered to rank 0; restored on any mesh).  Every rank takes the
same path: the failures fall on the same steps, the step to restore is
rank 0's, and the logged loss and grad_norm are replicated values; only
rank 0 prints.  :func:`main` starts the group itself when torchrun's
variables name a world (gloo for ``--device cpu``, NCCL otherwise) and
destroys it at the end; a group the caller started is used as it is.
Four CPU ranks:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch llama3.2-3b --reduced --steps 8 \
      --global-batch 4 --seq-len 16 --microbatches 2 --device cpu

The weights are drawn from ``seed`` by a generator on the device, in
bf16.  The stub frontends' float inputs (``embeds``, ``frames``) enter
the model in the weights' dtype: ``torch.einsum`` does not promote a
float32 input against bf16 weights as JAX does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.ft.failures import (FailureInjector, InjectedFailure,
                                     StepTimer)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (TORCHRUN_VARS, make_test_mesh,
                                     mesh_device)
from repro_torch.models.config import ArchConfig
from repro_torch.train.step import (TrainConfig, abstract_train_state,
                                    build_train_step, init_train_state,
                                    state_shardings)


@dataclasses.dataclass
class RunConfig:
    arch: str
    reduced: bool = True
    steps: int = 40
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 0
    inject_failures: tuple[int, ...] = ()
    seed: int = 0
    log_every: int = 1
    device: str | None = None        # None = the CUDA card


def data_config(cfg: ArchConfig, run: RunConfig) -> DataConfig:
    kind = {"vision_stub": "embeds", "audio_stub": "frames"}.get(
        cfg.frontend, "tokens")
    return DataConfig(vocab_size=cfg.vocab_size,
                      global_batch=run.global_batch, seq_len=run.seq_len,
                      seed=run.seed, kind=kind, d_model=cfg.d_model,
                      enc_len=max(run.seq_len // 2, 8))


def _init_state(cfg: ArchConfig, run: RunConfig, dev: torch.device) -> dict:
    """The state drawn from ``run.seed`` by a fresh generator on ``dev``:
    a restart from scratch draws the same weights."""
    return init_train_state(cfg, torch.Generator(dev).manual_seed(run.seed))


def _place_state(state: dict, mesh, st_sh: dict) -> dict:
    """``state`` placed by ``st_sh``: on a mesh of more than one rank each
    rank keeps its blocks of the whole state it drew."""
    sh.distribute_params(state["params"], mesh)
    state["opt"] = sh.place_tree(state["opt"], st_sh["opt"])
    return state


def _value(t) -> float:
    """A replicated scalar's value (the same on every rank)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def train(run: RunConfig) -> dict:
    """Run ``run``; returns the losses' summary and the log.  Inside a
    started process group every rank calls it and gets the same dict,
    but for ``sec`` and ``straggler_flags``: each rank times its own
    steps."""
    cfg = (get_reduced_config(run.arch) if run.reduced
           else get_config(run.arch))
    dev = resolve_device(run.device)
    mesh = make_test_mesh(device=dev)
    if sh.is_multi(mesh):
        dev = mesh_device(mesh)
    printing = _is_rank0()
    tcfg = TrainConfig(microbatches=run.microbatches)
    state = _init_state(cfg, run, dev)
    wdtype = state["params"].embed.dtype
    abstract = abstract_train_state(cfg, wdtype)
    st_sh = state_shardings(abstract, mesh)
    state = _place_state(state, mesh, st_sh)
    dcfg = data_config(cfg, run)
    step_fn = None     # built lazily so batch specs come from real batch

    saver = ckpt.AsyncCheckpointer(run.ckpt_dir) if run.ckpt_dir else None
    injector = FailureInjector(run.inject_failures)
    timer = StepTimer()
    log: list[dict] = []
    restarts = 0

    def build(batch):
        fn, _, b_sh = build_train_step(cfg, mesh, tcfg=tcfg,
                                       abstract_state=abstract,
                                       abstract_batch=batch)
        return fn, b_sh

    step = 0
    while step < run.steps:
        try:
            injector.check(step)
            # the global batch on every rank; placing keeps this rank's rows
            batch = {k: torch.from_numpy(v).to(
                         wdtype if v.dtype.kind == "f" else torch.int32)
                     for k, v in make_batch(dcfg, step).items()}
            if step_fn is None:
                step_fn, b_sh = build(batch)
            batch = {k: sh.place(v, b_sh[k]) for k, v in batch.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = _value(metrics["total_loss"])
            dt = time.perf_counter() - t0
            straggler = timer.record(step, dt)
            if step % run.log_every == 0:
                rec = dict(step=step, loss=round(loss, 4),
                           grad_norm=round(_value(metrics["grad_norm"]), 3),
                           sec=round(dt, 3), straggler=bool(straggler))
                log.append(rec)
                if printing:
                    print(json.dumps(rec), flush=True)
            if saver and run.ckpt_every and (step + 1) % run.ckpt_every == 0:
                saver.save(step + 1, state)
            step += 1
        except InjectedFailure:
            restarts += 1
            if printing:
                print(f"[ft] injected failure at step {step}; restoring",
                      flush=True)
            if saver:
                saver.wait()
            state = None                    # free the lost state first
            last = ckpt.latest_step(run.ckpt_dir) if run.ckpt_dir else None
            if last is None:
                # no checkpoint yet: restart from scratch (deterministic data)
                state = _place_state(_init_state(cfg, run, dev), mesh,
                                     st_sh)
                step = 0
            else:
                state, _ = ckpt.restore(run.ckpt_dir, last, abstract, st_sh)
                step = last
    if saver:
        saver.wait()
    losses = [r["loss"] for r in log]
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "restarts": restarts, "straggler_flags": timer.flags,
            "steps": step, "log": log}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated step numbers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default the CUDA card")
    args = ap.parse_args(argv)
    fails = tuple(int(x) for x in args.inject_failures.split(",") if x)
    run = RunConfig(arch=args.arch, reduced=args.reduced, steps=args.steps,
                    global_batch=args.global_batch, seq_len=args.seq_len,
                    microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, inject_failures=fails,
                    seed=args.seed, device=args.device)
    own_group = (not dist.is_initialized()
                 and all(v in os.environ for v in TORCHRUN_VARS))
    if own_group:
        cpu = resolve_device(args.device).type == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
    try:
        out = train(run)
        if _is_rank0():
            print(json.dumps({k: v for k, v in out.items() if k != "log"}))
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
