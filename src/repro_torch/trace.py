"""Named spans at the program's phase boundaries, on the profiler's clock.

``span(name, args)`` opens ``torch.profiler.record_function("repro_torch."
+ name, str(args))`` while a torch profiler runs, and returns one shared
no-op context otherwise.  The off path reads one process-global flag and
nothing else (no string formatting, no allocation), so the spans stay in
the engines' per-level loops: a bare ``record_function`` costs some
microseconds even with no profiler on.

The flag is the profiler's process-global one, true on every thread while
a profiler runs (``torch.autograd._profiler_enabled()`` is thread-local
and reads False on the batcher's worker threads).  A profiler started with
``experimental_config=_ExperimentalConfig(profile_all_threads=True)``
records the workers' spans too.

The names, without the prefix:

* engines (``core.bfs_local.BFSRunner.run``, ``core.vertex_program.
  VertexProgramRunner``'s packed loop): ``init`` (the first statvec and
  its fetch); per level ``level`` (args: the level index), holding
  ``step`` (the enqueue of the level's device work: ``expand``,
  ``propagate``, ``commit``, ``statvec`` inside it where the step has
  such a phase), ``statvec_fetch`` (the level's one blocking fetch) and
  ``retry`` (a re-run step and its fetch after an overflow); after the
  loop ``readback`` (the final fetch; args on a CUDA graph: the page-
  locked pool's ``stats()`` with this readback counted: ``readbacks``,
  ``grown``, the readbacks that had to add a block, ``blocks``,
  ``pinned_bytes`` and ``reuse_share``) and ``count`` (host work on the
  fetched rows);
* the batcher (``launch.dynbatch``): ``batcher.cut``,
  ``batcher.execute``, ``batcher.finish`` (args: the wave's cut sequence
  number), on the cutter, dispatcher and finisher threads.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """True on every thread while a torch profiler runs."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def span(name: str, args=None):
    """A ``record_function`` range ``repro_torch.<name>`` while a profiler
    runs (``args``, when given, as its string argument); else a no-op."""
    if not profiling():
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name, None if args is None else str(args))
