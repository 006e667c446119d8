"""bfs_runner: one root a call through ``BFSRunner.run`` (Graph500 kernel
2): the level array as a row [1, n] on the host and
``BFSResult.seconds``."""
from bfsbench import drive


class Entry:
    def __init__(self, g, runner_kw: dict):
        from repro_torch.core.bfs_local import BFSRunner
        self.runner = BFSRunner(g, **runner_kw)

    def __call__(self, roots):
        res = self.runner.run(int(roots[0]))
        return res.level[None], res.seconds


def make(g, mix, keys, rng, tracer, entry=None):
    if entry is None:
        entry = Entry(g, mix.get("runner", {}))
    return drive.ClosedLoop(entry, int(mix.get("batch", 1)), keys, rng,
                            tracer)
