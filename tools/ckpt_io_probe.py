#!/usr/bin/env python3
"""Time the host side of a checkpoint on the machine it runs on, before
a large one is written: the free disk in the temporary directory, the
host memory, and the rates of the three steps ``repro_torch.ckpt`` takes for
each leaf (a device-to-host copy into pageable memory, ``np.savez`` and
``np.load`` of the same bytes).

    python3 tools/ckpt_io_probe.py [--gb 4]

Needs a CUDA card; prints one line a measurement.
"""
import argparse
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.0,
                    help="size of the bf16 tensor copied, written and read")
    args = ap.parse_args()
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    print(f"temp dir {tmp_root}: {free / 1e9:.1f} GB free")
    print(subprocess.run(["free", "-g"], capture_output=True,
                         text=True).stdout.strip())
    n = int(args.gb * 1e9) // 2 // 1024 * 1024
    x = torch.randn(n // 1024, 1024, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = x.to("cpu", copy=True)
    t = time.perf_counter() - t0
    print(f"device to host {h.nbytes / 1e9:.3f} GB {t:.3f} s "
          f"{h.nbytes / 1e9 / t:.2f} GB/s")
    a = h.view(torch.int16).numpy().view(np.uint16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "arrays.npz")
        t0 = time.perf_counter()
        np.savez(path, a=a)
        t = time.perf_counter() - t0
        print(f"np.savez {a.nbytes / 1e9:.3f} GB {t:.3f} s "
              f"{a.nbytes / 1e9 / t:.2f} GB/s")
        t0 = time.perf_counter()
        with np.load(path) as z:
            b = z["a"]
        t = time.perf_counter() - t0
        print(f"np.load {b.nbytes / 1e9:.3f} GB {t:.3f} s "
              f"{b.nbytes / 1e9 / t:.2f} GB/s; equal {np.array_equal(a, b)}")


if __name__ == "__main__":
    main()
