"""mfu: the model's operations over the traced window's batches (convs,
encoder, prefill, decode products, head and attention, from the
configuration's shapes and the clips' lengths) over the window's wall
times the bf16 dense peak of one H100."""


def read(run):
    from benchmark.costs.qwen3_asr import batch_flops

    if not run.batches or run.window_s <= 0:
        return None
    tokens = run.traffic["max_tokens"]
    flops = sum(batch_flops(run.cfg, run.batch_samples(b), tokens) for b in range(run.batches))
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops_s"]
