"""Host seconds a step in the program's `compute_K` span
(nifs/protogalaxy.py: the K polynomial over the gate-leaf sweep)."""


def read(run):
    return run.span_per_op("compute_K") if run.op == "next" else None
