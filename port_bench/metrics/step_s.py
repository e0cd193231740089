"""Window seconds per CyclefoldIVC.next completed in it: a rate over the
whole window, which a device synchronize closes after every step."""


def read(run):
    return run.window_s / run.ops if run.op == "next" and run.ops else None
