"""decode_step_ms: host ms a decode step, from the start of a batch's first
``_gen_chunk`` (once prefill has run) to the end of its last ``_all_done``,
over the traced window's batches and their decode steps."""


def read(run):
    total, steps = 0.0, 0
    for b, n in enumerate(run.steps):
        chunks = [(t0, t1) for bb, name, t0, t1 in run.spans
                  if bb == b and name in ("_gen_chunk", "_all_done")]
        if chunks and n:
            total += max(t1 for _, t1 in chunks) - min(t0 for t0, _ in chunks)
            steps += n
    return 1e3 * total / steps if steps else None
