"""The port stands alone: a subprocess with `sys.modules['jax'] = None` and
`sys.modules['sirius_tpu'] = None` imports every module of
`sirius_tpu_torch`, no source line of the port or of `chip_smoke.py`
imports jax or `sirius_tpu`, and an entry point called without a device
asks for the CUDA device (and raises where there is none)."""

import importlib
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.fields.jfield import FR
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.ntt import NTT, ntt_ctx
from sirius_tpu_torch.plonk.structure import PlonkWitness
from sirius_tpu_torch.util.interop import to_torch
from sirius_tpu_torch.util.testing import MockCommitmentKey

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sirius_tpu_torch"
BLOCKED = ("jax", "sirius_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_port_module_imports_without_jax():
    mods = list(_modules())
    assert len(mods) > 30
    code = ("import sys\n" + "".join(f"sys.modules[{b!r}] = None\n" for b in BLOCKED)
            + "".join(f"import {m}\n" for m in mods)
            + f"loaded = {{k.split('.')[0] for k, v in sys.modules.items() if v is not None}}\n"
            + f"assert not loaded & set({BLOCKED!r}), loaded\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_source_line_imports_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|sirius_tpu)(\s|\.|$)")
    offenders = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if bad.match(line)
    ]
    assert offenders == []


@pytest.mark.parametrize("call", [
    lambda: FR.encode([1, 2]),
    lambda: FR.zeros((2,)),
    lambda: FR.ones((2,)),
    lambda: FR.const(3, (2,)),
    lambda: BN256_G1.identity((2,)),
    lambda: CommitmentKey.setup(BN256_G1, 2, b"no-device", use_cache=False),
    lambda: to_torch([[0] * 16]),
    lambda: MockCommitmentKey(BN256_G1),
    lambda: NTT(FR, 3),
    lambda: ntt_ctx(bn256_fr, 3),
    lambda: PlonkWitness.zeros(FR, [4]).W[0],
], ids=["encode", "zeros", "ones", "const", "identity", "key_setup", "to_torch", "mock_key", "ntt", "ntt_ctx",
        "witness_zeros"])
def test_entry_points_default_to_cuda(call):
    """Without a device the port asks for the card: where there is no CUDA
    it raises instead of running on the CPU; with one it lands there."""
    if torch.cuda.is_available():
        assert torch.device(call().device).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


STEP_CIRCUITS = {
    "power_step_circuit": "PowerStepCircuit",
    "merkle_step_circuit": "MerkleStepCircuit",
    "sha256_step_circuit": "Sha256StepCircuit",
    "spread_sha256": "SpreadSha256StepCircuit",
    "range_step_circuit": "RangeCheckStepCircuit",
    "xor_step_circuit": "XorStepCircuit",
    "xor_lookup_step_circuit": "XorLookupStepCircuit",
}


@pytest.mark.parametrize("module", list(STEP_CIRCUITS))
def test_step_circuit_modules_are_the_ports_own(module):
    """The seven step circuits of the JAX package's `gadgets/` are modules of
    the port (covered by the jax-free import above) with the step-circuit
    API of `ivc/step_circuit.py`."""
    name = f"sirius_tpu_torch.gadgets.{module}"
    assert name in set(_modules())
    cls = getattr(importlib.import_module(name), STEP_CIRCUITS[module])
    for method in ("configure", "synthesize_step", "process_step", "instances"):
        assert callable(getattr(cls, method)), (module, method)


@pytest.mark.parametrize("module", ["sirius_tpu_torch.frontend.tape", "sirius_tpu_torch.frontend.taped",
                                    "sirius_tpu_torch.native"])
def test_tape_modules_are_the_ports_own(module):
    """The witness tape, its synthesis layer and the native interpreter's
    loader are modules of the port (covered by the jax-free import above);
    importing the loader builds nothing, and no source line of the port reads
    a switch that would turn the tape or the native replay off."""
    assert module in set(_modules())
    importlib.import_module(module)
    switches = re.compile(r"SIRIUS_TPU_(TAPE|NATIVE)")
    assert [p for p in PKG.rglob("*.py") if switches.search(p.read_text())] == []
    assert (PKG / "native" / "witness_tape.cpp").exists()


@pytest.mark.parametrize("module", ["sirius_tpu_torch.parallel", "sirius_tpu_torch.parallel.mesh",
                                    "sirius_tpu_torch.parallel.context"])
def test_parallel_modules_are_the_ports_own(module):
    """The multi-device layer is the port's own (covered by the jax-free
    import above): explicit row blocks and an active mesh, and none of the
    JAX package's GSPMD sharding helpers."""
    assert module in set(_modules())
    mod = importlib.import_module(module)
    for gspmd in ("row_sharding", "replicated_sharding", "replicated", "NamedSharding"):
        assert not hasattr(mod, gspmd), (module, gspmd)
