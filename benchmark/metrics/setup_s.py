"""setup_s: seconds from the process's start to the end of set-up (imports,
context, kernel library, weights, clips, the warm-up)."""


def read(run):
    return run.setup_s
