"""peak_gib: torch.cuda.max_memory_allocated over the window, reset at its
start (so the resident state counts), in GiB; none off the card."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
