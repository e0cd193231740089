"""The share of the traced window of a steps cell in which no device event
ran: 100 x (1 - busy / window), busy the union of the device events'
intervals."""


def read(run):
    if run.op != "next" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
