"""Device seconds per traced CyclefoldIVC.next of the kernels launched
inside the program's `compute_K` span (nifs/protogalaxy.py), its child
spans included (`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run) if run.op == "next" else None
    return None if found is None else found.per_op(run.ops, "compute_K", "device_s")
