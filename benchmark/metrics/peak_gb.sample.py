"""Peak memory the run's allocator reserved on the card, GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
