"""batcher: single-root requests on the mix's open-loop schedule into a
``DynamicBatcher`` (keyword arguments ``batcher``) in front of a
``MultiSourceBFSRunner`` (``runner``); each future's row is the answer."""
from bfsbench import drive


def make(g, mix, keys, rng, tracer, entry=None):
    if entry is None:
        from repro_torch.core.vertex_program import MultiSourceBFSRunner
        entry = MultiSourceBFSRunner(g, **mix.get("runner", {}))
    kw = dict(mix.get("batcher", {}))

    def make_server(engine):
        from repro_torch.launch.dynbatch import DynamicBatcher
        return DynamicBatcher(engine, **kw)
    return drive.OpenLoop(entry, make_server, mix, keys, rng, tracer,
                          max_batch=int(kw.get("max_batch", 32)))
