"""Seconds from process start to the window's start: imports, the kernel
library, the keys, the public parameters, new and the warm-up calls
(host clock; set-up ends in a device synchronize)."""


def read(run):
    return run.setup_s
