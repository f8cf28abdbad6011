"""k1_roofline: the bound of the decode's packed products (bytes over the
memory rate or operations over the bf16 peak, the larger, for each
product) over K1's device time in the decode chunks' ranges of the
profiled batch. Nothing is read unless K1's kernels there number the
products and the launch counter rose by the code's count."""

import sys


def read(run):
    p = run.profile
    if p is None or not p["steps"]:
        return None
    from benchmark.costs.qwen3_asr import k1_decode_bound_s, k1_decode_launches
    from benchmark.families.qwen3_asr import expected_launches
    from benchmark.trace import by_range, count_in

    marks = p["marks"]["k1"]
    want = k1_decode_launches(run.cfg, p["steps"])
    seen = count_in(p, p["decode_range"], marks[:1])
    if seen != want or p["launches"]["k1"] != expected_launches(run.cfg, p["steps"])["k1"]:
        print(f"k1_roofline: {seen} kernels in the decode ranges, {p['launches']['k1']} "
              f"launches; the code's counts are {want} and "
              f"{expected_launches(run.cfg, p['steps'])['k1']}", file=sys.stderr)
        return None
    kernels = by_range(p).get(p["decode_range"], {})
    us = sum(v for k, v in kernels.items() if any(m in k for m in marks))
    if us <= 0:
        return None
    return 100.0 * k1_decode_bound_s(run.cfg, p["rows"], p["steps"], run.peaks) / (us / 1e6)
