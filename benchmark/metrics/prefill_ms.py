"""prefill_ms: device ms of ``_prefill`` (embedding, the decoder over the
prompt into the cache, the first head) in the profiled batch."""


def read(run):
    p = run.profile
    if p is None:
        return None
    from benchmark.trace import by_range

    kernels = by_range(p).get("_prefill")
    return sum(kernels.values()) / 1e3 if kernels else None
