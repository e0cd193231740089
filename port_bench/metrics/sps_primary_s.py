"""Host seconds a step in the program's `sps_primary` span (plonk/sps.py,
plonk/lookup.py: the primary trace's rounds, their commitments and, on a
lookup circuit, the log-derivative rounds)."""


def read(run):
    return run.span_per_op("sps_primary") if run.op == "next" else None
