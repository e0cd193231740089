"""Kernels launched inside the program's `sps_primary` span (plonk/sps.py,
plonk/lookup.py: the primary trace's rounds and commitments, and on a
lookup circuit `lookup_h_g`) per traced CyclefoldIVC.next
(`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run) if run.op == "next" else None
    return None if found is None else found.per_op(run.ops, "sps_primary")
