"""The commits' share of their roofline in the traced window of a steps
cell, from the program's own `commit` spans (ops/commitment.py: one around
each outermost commit_device, commit_device_many and batched_commit_check,
with the scalars, key points and results it counts): the least time those
commits could take (`roofline/commit.py`) over the device seconds of the
kernels launched inside them (`port_bench/spans.py`).  No synchronize
closes a commit."""

from port_bench import spans
from port_bench.roofline.commit import least_seconds

spans.install()


def read(run):
    found = spans.of(run) if run.op == "next" else None
    if found is None or found.attribution is None:
        return None
    commits = found.in_window("commit")
    device_s = found.attribution.device_s.get("commit", 0.0)
    if not commits or device_s <= 0:
        return None
    least = sum(least_seconds(c.counts["scalars"], c.counts["points"], c.counts["results"]) for c in commits)
    return 100.0 * least / device_s
