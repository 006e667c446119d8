"""The paper's ScalaBFS configurations (Table II).  The LM configurations
of ``repro.configs`` come with the LM stack."""
from repro_torch.configs.scalabfs import CONFIGS, ScalaBFSConfig

__all__ = ["CONFIGS", "ScalaBFSConfig"]
