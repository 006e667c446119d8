"""teps: traversed edges a second over the window (paper §VI-A), in the
closed-loop cells.

A query's traversed edges are the out-degrees of the vertices it reaches:
on these undirected graphs, the arcs of the root's connected component,
which the benchmark works out from its own graph (``run.trav``).  Every
query the window completed counts, over the window's seconds from the
first call to the last answer on the host (host clock)."""


def read(run):
    ok = run.ok_units
    if not ok or run.window_s <= 0:
        return None
    edges = sum(int(run.trav[u.roots].sum()) for u in ok)
    return edges / run.window_s
