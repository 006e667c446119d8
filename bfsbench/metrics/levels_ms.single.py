"""levels_ms.single: ``levels_ms`` (``levels_ms.py``, time per root to the last level's sync) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("levels_ms", Path(__file__).resolve().parents[1]).read
