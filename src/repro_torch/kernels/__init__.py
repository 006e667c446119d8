"""Hand-written CUDA kernels of the port, their launch wrappers, the glue
that connects them to the engine (``ops``) and their plain versions
(``ref``).  Nothing is compiled at import: a kernel is built by nvcc on
its first launch (``_build``).

The flash-attention kernel is ``flash_attention.flash_attention`` (the
module keeps its name, as in the reference)."""
from repro_torch.kernels import (csr_gather, flash_attention, ops,
                                 pull_spmv, ref)
from repro_torch.kernels.csr_gather import gather_pages
from repro_torch.kernels.ops import build_page_table, read_neighbor_pages
from repro_torch.kernels.pull_spmv import pull_spmv_blocks

__all__ = ["build_page_table", "csr_gather", "flash_attention",
           "gather_pages", "ops", "pull_spmv", "pull_spmv_blocks",
           "read_neighbor_pages", "ref"]
