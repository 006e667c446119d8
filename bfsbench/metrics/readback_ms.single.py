"""readback_ms.single: ``readback_ms`` (``readback_ms.py``, time per root of the level array's readback) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("readback_ms", Path(__file__).resolve().parents[1]).read
