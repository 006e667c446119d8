"""What the traced run hooks into the program, and nothing else: the
kernel entries K1 (``msbfs_propagate_planes``) and K4 (``bitmap_update``),
to count the bytes each call's inputs make it move, and the runners'
one blocking fetch (``_fetch``), to label the host's time as a statvec
fetch or a readback.

Each hook replaces the function wherever a module of the program holds
it, and ``remove`` puts the originals back.  A hook whose target the
program no longer has is left out, and the metric that reads it stays
silent.  The untraced runs hook nothing.
"""
from __future__ import annotations

import inspect
import sys
import time

import torch

from bfsbench import yardstick

# A fetched tensor larger than this is a readback, not a statvec.
_STATVEC_MAX = 64


class Probe:
    def __init__(self, tracer, device: torch.device):
        self.tracer, self.device = tracer, device
        self.k1_bytes: list[int] = []
        self.k4_bytes: list[int] = []
        self.count_s = 0.0           # host time spent counting K1's bytes
        self._undo: list = []

    # -- installing -------------------------------------------------------
    def install(self) -> "Probe":
        from repro_torch.kernels import bitmap_update, msbfs_propagate
        k1 = getattr(msbfs_propagate, "msbfs_propagate_planes", None)
        k4 = getattr(bitmap_update, "bitmap_update", None)
        if k1 is not None:
            self._replace(k1, self._k1_hook(k1))
        if k4 is not None:
            self._replace(k4, self._k4_hook(k4))
        from repro_torch.core import bfs_local, vertex_program
        for cls in (getattr(bfs_local, "BFSRunner", None),
                    getattr(vertex_program, "VertexProgramRunner", None)):
            fetch = getattr(cls, "_fetch", None) if cls else None
            if fetch is not None:
                setattr(cls, "_fetch", self._fetch_hook(fetch))
                self._undo.append((cls, "_fetch", fetch))
        return self

    def remove(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def _replace(self, orig, hook) -> None:
        """Put ``hook`` wherever a module of the program holds ``orig``."""
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or mod_name.split(".")[0] != "repro_torch":
                continue
            for attr, value in list(vars(mod).items()):
                if value is orig:
                    setattr(mod, attr, hook)
                    self._undo.append((mod, attr, orig))

    # -- hooks ------------------------------------------------------------
    def _k1_hook(self, orig):
        sig = inspect.signature(orig)

        def hook(*args, **kw):
            out = orig(*args, **kw)
            try:
                a = sig.bind(*args, **kw).arguments
                inputs = (a["frontier"], a["src"], a["tgt"], a.get("valid"),
                          a.get("n_edges"))
            except (TypeError, KeyError):
                return out
            self._sync()
            with self.tracer.span("count"):
                t0 = time.perf_counter()
                self.k1_bytes.append(yardstick.k1_bytes(*inputs))
                self._sync()
                self.count_s += time.perf_counter() - t0
            return out
        return hook

    def _k4_hook(self, orig):
        sig = inspect.signature(orig)

        def hook(*args, **kw):
            try:
                cand = sig.bind(*args, **kw).arguments["cand"]
                self.k4_bytes.append(yardstick.k4_bytes(cand))
            except (TypeError, KeyError):
                pass
            return orig(*args, **kw)
        return hook

    def _fetch_hook(self, orig):
        tracer = self.tracer

        def hook(runner, t, *args, **kw):
            label = ("readback" if t.numel() > _STATVEC_MAX
                     else "statvec_fetch")
            with tracer.span(label):
                return orig(runner, t, *args, **kw)
        return hook

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
