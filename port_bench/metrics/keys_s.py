"""Host seconds of the program's `commitment_key` spans
(ops/commitment.py: CommitmentKey.setup, both keys; `ck_load` from the
checkout's key cache, `ck_derive` on a checkout's first run) in the traced
run's set-up (`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run)
    return None if found is None else found.host_s("commitment_key")
