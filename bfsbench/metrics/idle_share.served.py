"""idle_share.served: ``idle_share`` (``idle_share.py``, the device's idle
share of the window) in the served cell, where it moves
``served_p95_ms``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("idle_share", Path(__file__).resolve().parents[1]).read
