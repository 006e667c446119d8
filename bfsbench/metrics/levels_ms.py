"""levels_ms: mean time per wave or root to the program's last level's
sync (``last_stats["seconds"]`` of ``run_batch``, ``BFSResult.seconds``
of ``BFSRunner.run``), in milliseconds, less the time the traced run
spent counting kernel bytes inside it (program span)."""


def read(run):
    vals = [u.program_s - u.count_s for u in run.ok_units
            if u.program_s is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
