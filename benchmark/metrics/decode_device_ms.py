"""decode_device_ms: device ms a decode step: the kernels in the decode
chunks' ranges of the profiled batch over its decode steps."""


def read(run):
    p = run.profile
    if p is None or not p["steps"]:
        return None
    from benchmark.trace import by_range

    kernels = by_range(p).get(p["decode_range"])
    return sum(kernels.values()) / 1e3 / p["steps"] if kernels else None
