"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the graph generated and built on the card, the program's
``LocalGraph``, the kernels' build in a fresh checkout, and one warm call
of each shape the cell's traffic uses (host clock)."""


def read(run):
    return run.setup_s
