"""encode_ms: device ms of ``_encode`` (wire decode, log-mel, the encoder)
in the profiled batch."""


def read(run):
    p = run.profile
    if p is None:
        return None
    from benchmark.trace import by_range

    kernels = by_range(p).get("_encode")
    return sum(kernels.values()) / 1e3 if kernels else None
