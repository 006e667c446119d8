"""End-to-end training example on the PyTorch port: a ~100M-param
llama-family model with checkpoint/restart and an injected failure (the
counterpart of ``examples/train_lm.py``, with the same assertions).

Uses the port's ``launch.train`` driver; it runs on the CUDA card, or on
the CPU with ``--device cpu`` (slowly at the full sizes):

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 60] [--device cpu]

It trains on one rank.  The same driver trains across ranks from its
own entry point, which starts the process group under torchrun (one
process a rank; gloo on the CPU, NCCL on cards):

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch llama3.2-3b --reduced --device cpu
"""
import argparse
import json
import os
import tempfile

import repro_torch.configs as C
import repro_torch.launch.train as T
from repro_torch.models.config import ArchConfig

# ~100M params: 12L x 768d (GPT-2-small class), llama3-style blocks
EXAMPLE_100M = ArchConfig(
    name="example-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000, window=0)


def register() -> None:
    """Register the example config so the stock driver resolves it."""
    module = type("M", (), {"CONFIG": EXAMPLE_100M, "REDUCED": EXAMPLE_100M})
    C._MODULES["example-100m"] = module


def run(steps: int, ckpt_dir: str, global_batch: int = 8, seq_len: int = 256,
        ckpt_every: int = 20, inject_failures=None, log_every: int = 5,
        device=None) -> dict:
    """Train example-100m for ``steps`` steps (2 microbatches), saving
    every ``ckpt_every`` steps and failing at ``inject_failures`` (default:
    half way); the driver's result dict."""
    register()
    run_cfg = T.RunConfig(
        arch="example-100m", reduced=False, steps=steps,
        global_batch=global_batch, seq_len=seq_len, microbatches=2,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        inject_failures=tuple(inject_failures or (steps // 2,)),
        log_every=log_every, device=device)
    return T.train(run_cfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_100m"))
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default the CUDA card")
    args = ap.parse_args()

    n = EXAMPLE_100M.param_count()
    print(f"example-100m: {n/1e6:.1f}M params, steps={args.steps}")
    out = run(args.steps, args.ckpt_dir, args.global_batch, args.seq_len,
              device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "log"}))
    assert out["restarts"] >= 1, "failure injection did not trigger"
    assert out["final_loss"] < out["first_loss"], "loss did not fall"
    print("OK: loss fell and training survived an injected failure")


if __name__ == "__main__":
    main()
