"""Host seconds of the program's `public_params` span
(ivc/cyclefold_ivc.py: CyclefoldPublicParams, the support and primary
structures and the witness tapes), read from inside the program in the
traced run's set-up (`port_bench/spans.py`)."""

from port_bench import spans

spans.install()


def read(run):
    found = spans.of(run)
    return None if found is None else found.host_s("public_params")
