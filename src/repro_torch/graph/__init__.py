from repro_torch.graph.csr import (CSRGraph, csr_from_edges, edge_sources,
                                   symmetrize_csr, symmetrize_edges,
                                   transpose_csr)
from repro_torch.graph.generators import rmat_edges, uniform_edges
from repro_torch.graph.datasets import DATASETS, get_dataset

__all__ = [
    "CSRGraph", "csr_from_edges", "edge_sources", "transpose_csr",
    "symmetrize_edges", "symmetrize_csr", "rmat_edges", "uniform_edges",
    "get_dataset", "DATASETS",
]
