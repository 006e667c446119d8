"""The LM stack's models (port of ``repro.models``): ten architectures
from one segment-structured transformer."""
from repro_torch.models.config import (ArchConfig, layer_plan_kinds,
                                       layer_segments)
from repro_torch.models.transformer import (LM, abstract_params,
                                            forward_train, init_decode_state,
                                            init_params, loss_fn,
                                            prefill_step, serve_step)

__all__ = [
    "ArchConfig", "LM", "layer_plan_kinds", "layer_segments",
    "abstract_params", "forward_train", "init_decode_state", "init_params",
    "loss_fn", "prefill_step", "serve_step",
]
