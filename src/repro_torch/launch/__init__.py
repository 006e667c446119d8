"""Entry points of the port: BFS serving and greedy LM decoding
(``serve``; async BFS serving through the dynamic batcher ``dynbatch``
and the worker pool ``pool``) and the H100 roofline (``roofline``)."""
from repro_torch.launch.roofline import (H100, Hardware, analyze_cell,
                                         format_row, model_flops,
                                         roofline_terms)

__all__ = ["H100", "Hardware", "analyze_cell", "format_row", "model_flops",
           "roofline_terms"]
