"""teps.single: ``teps`` (``teps.py``, traversed edges a second) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("teps", Path(__file__).resolve().parents[1]).read
