"""Device kernel events in the traced window (copies and fills not
counted) per CyclefoldIVC.next: the field and curve layer's eager
launches (fields/jfield.py, curves/jpoint.py) and the kernels'."""


def read(run):
    if run.op != "next" or run.trace is None or not run.ops:
        return None
    return run.trace.launches / run.ops
