"""The port's examples and CLI: the entry points users run.

Each module is the counterpart of the JAX package's `examples/<name>.py`
(the same flags, defaults, key labels and sizes, and printed lines) and is
split into `run(args, keys=None, device=None)`, which drives the IVC and
returns it with its timings, and `main(argv=None)`, which parses the flags
and returns the exit code.  Run one as

    python -m sirius_tpu_torch.examples.<name> [flags]
    python -m sirius_tpu_torch.examples.cli <mode> [flags]

Every example runs on the CUDA device with real Pedersen keys; `--cpu` asks
for the CPU and the non-binding `MockCommitmentKey`.  Nothing is done at
import time.
"""
