"""Run one cell of the port's benchmark on the CUDA card and print its
result as the last line of standard output:

    python3 -m bfsbench.run --workload kron22-16.wave64 --seed 7 \
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Without a card (or with fewer
cards than the cell asks for) it prints no result and exits with 2; it
never falls back to the CPU.  The numbers that decide ``correct`` are
printed beside their limits as the last lines of standard error and
under ``checks``, the last key of the result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Packages the timed process may never hold: JAX and the JAX package
# (``repro``), by whole top-level name (``repro_torch`` is the port).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def program_path() -> None:
    """Make the port (``src/repro_torch``) importable from the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def check_lines(checks: dict) -> list[str]:
    lines = []
    for name, c in checks.items():
        if "limit" in c:
            lines.append(f"check {name} {c['value']} limit {c['limit']}")
        else:
            lines.append(f"check {name} {c['value']} "
                         f"at least {c['at_least']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    program_path()
    import repro_torch  # noqa: F401  (the program: fail here without it)
    import torch

    from bfsbench import harness
    cell = harness.cell_entry(harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        out["device"]["power"] = card
        print(f"card {card}", file=sys.stderr)
    print("\n".join(check_lines(out["checks"])), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
