"""idle_share: 100 - the profiled batch's device busy time over the wall of
the same clips sent in the window, where the profiler's host cost is not
(the mean over the window's batches of the profiled batch's pool entry)."""


def read(run):
    p = run.profile
    if p is None:
        return None
    pool = run.traffic["pool_batches"]
    walls = [w for b, w in enumerate(run.walls) if b % pool == run.batches % pool]
    if not walls:
        return None
    from benchmark.trace import busy_us

    return 100.0 * (1.0 - busy_us(p) / 1e6 / (sum(walls) / len(walls)))
