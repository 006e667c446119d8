"""glue_device_ms.single: ``glue_device_ms`` (``glue_device_ms.py``, the glue's device time per root) in the single-root
cell, where it moves ``teps.single``."""
from pathlib import Path

from bfsbench.harness import load_metric

read = load_metric("glue_device_ms", Path(__file__).resolve().parents[1]).read
