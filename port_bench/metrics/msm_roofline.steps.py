"""The commits' share of their roofline in the traced window of a steps
cell: the least time the window's commits could take
(`roofline/commit.py`: every scalar and key point read once, each result
written once, at the card's HBM rate) over the device time of the events
launched inside them (ops/msm.py, csrc/msm.cu, csrc/madd.cu)."""

from port_bench.roofline.commit import least_seconds


def read(run):
    if run.op != "next" or run.trace is None or not run.trace.commits or run.trace.commit_device_s <= 0:
        return None
    least = sum(least_seconds(c.scalars, c.points, c.results) for c in run.trace.commits)
    return 100.0 * least / run.trace.commit_device_s
