"""batch_mean.served: requests over waves in the window, from the
batcher's own counts (``DynamicBatcher.stats()``: requests served in
error-free waves over those waves) (program counter)."""


def read(run):
    st = run.batcher
    if not st:
        return None
    waves = st.get("waves", 0) - st.get("errors", 0)
    return st["requests"] / waves if waves > 0 else None
