"""The benchmark's plain reference: the verifier's half of the port's plain
code, frozen.

A copy of the parts of `sirius_tpu_torch` that the verdict needs, frozen as
they stood when the benchmark was defined: the fields and curves, the
circuit frontend and gadgets that the public parameters' dry syntheses run
(the structures and the pp digest over them), the plonk relation checks,
the relaxed relation checks of both folding schemes, the marker that binds
a step's state, the commitment opening (a plain MSM, every CUDA kernel
replaced by its plain torch twin) and the host hash-to-curve.  Left out:
the prover (witness replay, SPS rounds, folds, cross terms), the
multi-device path, the profiler and the Sangria IVC driver.  Its imports
are relative, so it imports nothing of the program under test, of `jax`
or of `sirius_tpu`.

Its logic is the port's own.  `port_bench/configs/<config>.json` holds
the JAX package's pp digest of each configuration (`pp_digest_jax`), which
the judge holds this copy's digest to, and `port_bench/tests/` holds its
verdicts against the JAX package's at the trivial configuration's size.
"""

__version__ = "0.1.0"
