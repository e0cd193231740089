"""Kernels launched inside the program's `support_folds` span
(ivc/support_fold.py: one Sangria fold of the support circuit per W
commitment) per traced CyclefoldIVC.next (`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run) if run.op == "next" else None
    return None if found is None else found.per_op(run.ops, "support_folds")
