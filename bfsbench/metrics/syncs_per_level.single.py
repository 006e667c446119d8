"""syncs_per_level.single: ``syncs_per_level`` (``syncs_per_level.py``,
blocking runtime calls per program ``level`` span) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("syncs_per_level",
                   Path(__file__).resolve().parents[1]).read
