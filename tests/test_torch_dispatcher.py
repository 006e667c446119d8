"""The port's crossbar (``repro_torch.core.dispatcher``) against the
reference's (``repro.core.dispatcher``) on a 2 x 2 mesh.

The port runs in four gloo ranks (one process each, a file store in the
test's temporary directory); the reference runs under ``shard_map`` on
four host devices in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.  Both read the
same seeded numpy inputs; every rank's outputs must equal the
reference's block for that device, word for word.  ``run_ranks`` is the
multi-rank launcher the distributed engine's tests share.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANK_TIMEOUT = 300          # seconds a group of ranks may take in all

_RANK_MAIN = """
import faulthandler
import os
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
faulthandler.enable()
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        world_size=world, rank=rank)
try:
{body}
finally:
    dist.destroy_process_group()
# the rank's work is done and written; leave without the interpreter's
# teardown, where gloo's threads at times abort the process
# ("terminate called without an active exception", no Python frame)
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _rank_env() -> dict:
    """One intra-op thread a rank: the ranks share the host's cores."""
    return dict(_env(), OMP_NUM_THREADS="1")


def run_ranks(body: str, world: int, tmp_path: Path,
              timeout: float = RANK_TIMEOUT) -> None:
    """Run ``body`` (Python source; ``rank``, ``world``, ``tmp`` the rank's
    index, the world size and the directory as a str) in ``world`` gloo
    ranks, one process each, joined by a file store in ``tmp_path``.
    Fails if a rank fails, or if the group outlives ``timeout`` (every
    rank is then killed)."""
    code = _RANK_MAIN.replace(
        "{body}", textwrap.indent(textwrap.dedent(body), "    "))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(tmp_path)],
        env=_rank_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{world} ranks did not finish within {timeout} s")
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"


def run_reference(code: str, devices: int, *args: str,
                  timeout: float = RANK_TIMEOUT) -> None:
    """Run the reference's ``code`` in a subprocess that sees ``devices``
    host devices."""
    env = _env()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]


SHARDS = 4
WORDS = 64                  # candidate words a rank holds (16 a shard)
IDS = 96                    # vertex-ID slots a rank sends
VPS = 48                    # vertices a shard owns (queue mode)
CAPACITIES = (8, 64)        # 8 overflows the FIFOs (about 24 IDs a peer)


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(19)
    cand = rng.integers(0, 2**32, (SHARDS, WORDS), dtype=np.uint32)
    cand[:, ::5] = 0                            # empty words travel too
    ids = rng.integers(-1, SHARDS * VPS, (SHARDS, IDS)).astype(np.int32)
    ids[:, :12] = 7                             # one hot owner
    np.savez(path, cand=cand, ids=ids)


_REFERENCE = """
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core.bfs_distributed import _flat_axis_index
from repro.core.dispatcher import (or_reduce_scatter_flat,
                                   or_reduce_scatter_staged, queue_dispatch,
                                   received_to_local_bits)

inp = np.load(sys.argv[1])
vps, caps = int(sys.argv[3]), [int(c) for c in sys.argv[4].split(",")]
mesh = make_mesh((2, 2), ("data", "model"))
axes = ("data", "model")
sp = P(axes)


def sm(f, n_out=1):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=sp,
                             out_specs=(sp,) * n_out if n_out > 1 else sp))


out = {}
out["flat"] = sm(lambda c: or_reduce_scatter_flat(c[0], axes, 4)[None])(
    inp["cand"])
out["staged"] = sm(lambda c: or_reduce_scatter_staged(
    c[0], axes, (2, 2))[None])(inp["cand"])
for cap in caps:
    def q(ids, cap=cap):
        recv, left = queue_dispatch(ids[0], axes, 4, vps, cap)
        bits = received_to_local_bits(recv, _flat_axis_index(axes), vps)
        return recv[None], left[None], bits[None]
    recv, left, bits = sm(q, 3)(inp["ids"])
    out[f"recv{cap}"], out[f"left{cap}"], out[f"bits{cap}"] = recv, left, bits
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""

_PORT = """
import torch
from repro_torch.core.dispatcher import (or_reduce_scatter_flat,
                                         or_reduce_scatter_staged,
                                         queue_dispatch,
                                         received_to_local_bits)
from repro_torch.launch.mesh import axes_group, flat_axis_index, make_mesh

inp = np.load(f"{tmp}/inputs.npz")
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
axes = ("data", "model")
flat = axes_group(mesh, axes)
staged = [mesh.get_group(a) for a in axes]
sidx = flat_axis_index(mesh, axes)
assert sidx == rank
cand = torch.from_numpy(inp["cand"].view(np.int32)[rank].copy())
ids = torch.from_numpy(inp["ids"][rank].copy())
out = dict(flat=or_reduce_scatter_flat(cand, flat, 4),
           staged=or_reduce_scatter_staged(cand, staged, (2, 2)))
for cap in CAPS:
    recv, left = queue_dispatch(ids, flat, 4, VPS, cap)
    out[f"recv{cap}"], out[f"left{cap}"] = recv, left
    out[f"bits{cap}"] = received_to_local_bits(recv, sidx, VPS)
np.savez(f"{tmp}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
"""


def test_dispatcher_matches_reference_on_four_ranks(tmp_path):
    _inputs(tmp_path / "inputs.npz")
    caps = ",".join(str(c) for c in CAPACITIES)
    run_reference(_REFERENCE, SHARDS, str(tmp_path / "inputs.npz"),
                  str(tmp_path / "ref.npz"), str(VPS), caps)
    run_ranks(f"CAPS, VPS = {CAPACITIES!r}, {VPS}\n" + _PORT, SHARDS,
              tmp_path)
    want = np.load(tmp_path / "ref.npz")
    overflowed = 0
    for r in range(SHARDS):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            w = want[name][r]
            g = got[name]
            if w.dtype == np.uint32:
                g = g.view(np.uint32)
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {name}")
        overflowed += int((got[f"left{CAPACITIES[0]}"] >= 0).sum())
        assert (got[f"left{CAPACITIES[1]}"] < 0).all()
    assert overflowed > 0          # the small FIFOs really overflowed
