"""Seconds of CyclefoldPublicParams (ivc/cyclefold_ivc.py): the support and
primary structures and the witness tapes, host clock closed by a device
synchronize."""


def read(run):
    return run.pp_s
