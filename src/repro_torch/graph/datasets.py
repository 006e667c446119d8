"""Named dataset registry mirroring the paper's Table I (copy of
``repro.graph.datasets``; same generator, same arrays for a name and seed).

Every entry is generated deterministically and cached on disk under the
port's own directory: ``$REPRO_TORCH_GRAPH_CACHE``, else
``<tempdir>/repro_torch_graphs``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.graph.csr import (CSRGraph, csr_from_edges, symmetrize_edges,
                                   transpose_csr)
from repro_torch.graph.generators import rmat_edges


def cache_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_GRAPH_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_graphs"))


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    scale: int
    edge_factor: int
    directed: bool
    note: str = ""


DATASETS = {
    # paper's synthetic suite
    "rmat18-8": DatasetSpec("rmat18-8", 18, 8, False),
    "rmat18-16": DatasetSpec("rmat18-16", 18, 16, False),
    "rmat18-32": DatasetSpec("rmat18-32", 18, 32, False),
    "rmat18-64": DatasetSpec("rmat18-64", 18, 64, False),
    "rmat20-16": DatasetSpec("rmat20-16", 20, 16, False),
    "rmat22-16": DatasetSpec("rmat22-16", 22, 16, False),
    "rmat22-32": DatasetSpec("rmat22-32", 22, 32, False),
    "rmat22-64": DatasetSpec("rmat22-64", 22, 64, False),
    "rmat23-16": DatasetSpec("rmat23-16", 23, 16, False),
    "rmat23-32": DatasetSpec("rmat23-32", 23, 32, False),
    "rmat23-64": DatasetSpec("rmat23-64", 23, 64, False),
    # real-world stand-ins (same avg-degree class)
    "pk-like": DatasetSpec("pk-like", 17, 19, True,
                           "soc-Pokec stand-in: directed, avg deg ~18.75"),
    "lj-like": DatasetSpec("lj-like", 18, 14, True,
                           "soc-LiveJournal stand-in: directed, avg deg ~14.23"),
    "or-like": DatasetSpec("or-like", 16, 76, False,
                           "com-Orkut stand-in: undirected, avg deg ~76.28"),
    "ho-like": DatasetSpec("ho-like", 15, 100, False,
                           "hollywood-2009 stand-in: undirected, avg deg ~99.91"),
    # mid-size graphs
    "rmat14-8": DatasetSpec("rmat14-8", 14, 8, False),
    "rmat16-16": DatasetSpec("rmat16-16", 16, 16, False),
    # tiny graphs for unit tests
    "tiny-16-4": DatasetSpec("tiny-16-4", 4, 4, False),
    "small-12-8": DatasetSpec("small-12-8", 12, 8, False),
}


@dataclasses.dataclass(frozen=True)
class Dataset:
    spec: DatasetSpec
    csr: CSRGraph   # outgoing neighbor lists (push)
    csc: CSRGraph   # incoming neighbor lists (pull)


def get_dataset(name: str, seed: int = 1, cache: bool = True) -> Dataset:
    spec = DATASETS[name]
    path = os.path.join(cache_dir(), f"{name}-s{seed}.npz")
    if cache and os.path.exists(path):
        with np.load(path) as z:
            csr = CSRGraph(int(z["n"]), z["indptr"], z["indices"])
            csc = CSRGraph(int(z["n"]), z["t_indptr"], z["t_indices"])
        return Dataset(spec, csr, csc)
    src, dst = rmat_edges(spec.scale, spec.edge_factor, seed=seed)
    if not spec.directed:
        src, dst = symmetrize_edges(src, dst)
    n = 1 << spec.scale
    csr = csr_from_edges(src, dst, n)
    csc = transpose_csr(csr)
    if cache:
        os.makedirs(cache_dir(), exist_ok=True)
        # write-then-rename: a concurrent reader never sees a partial file
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, n=n, indptr=csr.indptr, indices=csr.indices,
                 t_indptr=csc.indptr, t_indices=csc.indices)
        os.replace(tmp, path)
    return Dataset(spec, csr, csc)
