"""readback_ms: mean time per wave or root of the entry call on the
benchmark's clock less the program's time to its last level: the value
rows' readback to the host and what the entry does around it
(host clock)."""


def read(run):
    vals = [u.t1 - u.t0 - u.program_s for u in run.ok_units
            if u.program_s is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
