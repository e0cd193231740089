"""Host seconds a step in the program's `sfc_witness` span (the native
replay of the step-folding circuit's witness tape: frontend/taped.py,
native/witness_tape.cpp)."""


def read(run):
    return run.span_per_op("sfc_witness") if run.op == "next" else None
