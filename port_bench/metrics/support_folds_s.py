"""Host seconds a step in the program's `support_folds` span
(ivc/support_fold.py: one Sangria fold of the support circuit per W
commitment)."""


def read(run):
    return run.span_per_op("support_folds") if run.op == "next" else None
