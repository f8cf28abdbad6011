"""k3_roofline: the bound of K3's calls in the decode (the int8 keys and
values of each row's valid slots, their scales, q, the valid map, out;
bytes over the memory rate or operations over the bf16 peak, the larger)
over K3's split and merge kernels' device time in the decode chunks'
ranges of the profiled batch. Nothing is read where K3 did not run or
its launches are not the code's count."""

import sys


def read(run):
    p = run.profile
    if p is None or not p["steps"]:
        return None
    from benchmark.costs.qwen3_asr import k3_decode_bound_s, prompt_rows
    from benchmark.families.qwen3_asr import expected_launches
    from benchmark.trace import by_range

    want = expected_launches(run.cfg, p["steps"])["k3"]
    if p["launches"]["k3"] != want:
        print(f"k3_roofline: {p['launches']['k3']} launches, the code's count is {want}",
              file=sys.stderr)
        return None
    kernels = by_range(p).get(p["decode_range"], {})
    us = sum(v for k, v in kernels.items() if any(m in k for m in p["marks"]["k3"]))
    if us <= 0:
        return None
    prompt = [prompt_rows(run.cfg, n) for n in p["samples"]]
    cache_len = p["cache_len"]
    return 100.0 * k3_decode_bound_s(run.cfg, prompt, p["steps"], cache_len, run.peaks) / (us / 1e6)
