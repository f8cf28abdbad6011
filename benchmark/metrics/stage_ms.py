"""stage_ms: host ms a batch in ``prestage`` (resample, pad, the wire, the
copy to the device), over the traced window's batches."""


def read(run):
    spans = [t1 - t0 for _, name, t0, t1 in run.spans if name == "prestage"]
    return 1e3 * sum(spans) / run.batches if spans else None
