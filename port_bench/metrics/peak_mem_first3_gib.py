"""Peak device memory allocated over the window's first 3 calls
(torch.cuda.max_memory_allocated after a reset at the window's start, read
as the third call ends), with the keys resident, in GiB.

Not the whole window's peak: the program frees some device tensors only
when Python's cyclic collector runs, so a peak over more calls depends on
how many calls the host's speed fits into the window (5.61 or 5.91 GiB on
the trivial cell; PERF.md, Open questions)."""

CALLS = 3


def read(run):
    return run.peak_by_call[CALLS - 1] / 2**30 if len(run.peak_by_call) >= CALLS else None
