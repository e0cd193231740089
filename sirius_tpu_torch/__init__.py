"""sirius_tpu_torch — the PyTorch + CUDA port of `sirius_tpu`.

The JAX package `sirius_tpu` stays the reference; this package mirrors its
sub-layout and module names so each counterpart is easy to find:

  fields/   limbed Montgomery field arithmetic over (..., 8) int64 word tensors
  curves/   Jacobian point arithmetic, hash-to-curve
  ops/      MSM (hand-written CUDA kernels + plain torch twins), commitments,
            Poseidon transcript, kernel build
  csrc/     CUDA C++ sources (sm_90a), built with nvcc at first use
  poly/     row-parallel gate-expression evaluator
  plonk/    structure, SPS protocol, evaluation domains, satisfaction checks
  frontend/ circuit runner (synthesis itself is the shared host code)
  nifs/     Sangria folding
  util/     numpy/torch interop, transcript RO, test doubles

It imports `torch` and never `jax`; host-only modules of `sirius_tpu` that do
not import jax (constants, gold model, expression IR, circuit builder,
gadgets, support circuit) are shared as they are.
"""

__version__ = "0.1.0"
