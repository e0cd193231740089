"""Kernels launched inside the program's `compute_K` span
(nifs/protogalaxy.py: the K polynomial over the gate-leaf sweep) per traced
CyclefoldIVC.next, its child spans included (`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run) if run.op == "next" else None
    return None if found is None else found.per_op(run.ops, "compute_K")
