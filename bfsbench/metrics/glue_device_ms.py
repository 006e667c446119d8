"""glue_device_ms: device time per wave or root, in milliseconds, of every
kernel in the trace that is neither one of the port's own K1-K7 (by the
symbols frozen in ``yardstick.PORT_SYMBOLS``) nor a copy: the step glue,
the eager PyTorch ops and any kernel the port adds later, which the
traced run's ``breakdown`` names (device trace)."""
import re

from bfsbench import yardstick

_IDENT = re.compile(r"[A-Za-z_]\w*")


def is_glue(name: str) -> bool:
    return not set(_IDENT.findall(name)) & yardstick.PORT_SYMBOLS


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not run.units:
        return None
    return tr.kernel_ns(is_glue) / 1e6 / len(run.units)
