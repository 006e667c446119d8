"""Hand-written CUDA kernels of the port, their launch wrappers, the glue
that connects them to the engine (``ops``) and their plain versions
(``ref``).  Nothing is compiled at import: a kernel is built by nvcc on
its first launch (``_build``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
