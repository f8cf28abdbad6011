"""closed_loop: the next batch is sent when the last one returns, whole
batches until ``seconds`` have passed; the window ends with the batch
that crosses it, so its time holds all of its work."""

import time


def run(runner, traffic: dict, seconds: float) -> dict:
    """The window: {"window_s", "audio_s", "attempted", "failed", "batches",
    "walls" (each batch's seconds, in order)}."""
    attempted = failed = 0
    audio_s = 0.0
    walls = []
    t0 = last = time.perf_counter()
    while True:
        got = runner.run_batch()
        now = time.perf_counter()
        walls.append(now - last)
        last = now
        attempted += got["requests"]
        failed += got["failed"]
        audio_s += got["audio_s"]
        if now - t0 >= seconds:
            break
    return {"window_s": now - t0, "audio_s": audio_s, "attempted": attempted, "failed": failed,
            "batches": len(walls), "walls": walls}
