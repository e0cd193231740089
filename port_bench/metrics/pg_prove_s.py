"""Host seconds a step in the program's `pg_prove` span
(nifs/protogalaxy.py: the ProtoGalaxy prover, compute_F, compute_K and the
witness fold)."""


def read(run):
    return run.span_per_op("pg_prove") if run.op == "next" else None
