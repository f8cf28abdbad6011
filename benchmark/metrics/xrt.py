"""xrt: audio-seconds of every batch the window completed over the window's
wall seconds."""


def read(run):
    return run.audio_s / run.window_s if run.window_s > 0 else None
