"""run_batch: waves of ``batch`` distinct roots, back to back, through
``MultiSourceBFSRunner.run_batch``: the value rows [B, n] on the host and
the program's time to its last level (``last_stats["seconds"]``)."""
from bfsbench import drive


class Entry:
    def __init__(self, g, runner_kw: dict):
        from repro_torch.core.vertex_program import MultiSourceBFSRunner
        self.runner = MultiSourceBFSRunner(g, **runner_kw)

    def __call__(self, roots):
        rows = self.runner.run_batch(roots)
        return rows, self.runner.last_stats.get("seconds")


def make(g, mix, keys, rng, tracer, entry=None):
    if entry is None:
        entry = Entry(g, mix.get("runner", {}))
    return drive.ClosedLoop(entry, int(mix.get("batch", 1)), keys, rng,
                            tracer)
