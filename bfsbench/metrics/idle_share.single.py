"""idle_share.single: ``idle_share`` (``idle_share.py``, the device's idle share of the window) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("idle_share", Path(__file__).resolve().parents[1]).read
