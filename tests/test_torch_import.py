"""The port imports without jax: a subprocess with `sys.modules['jax'] = None`
imports every module of `sirius_tpu_torch`, and no source line imports jax."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sirius_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_port_module_imports_without_jax():
    mods = list(_modules())
    assert len(mods) > 20
    code = "import sys\nsys.modules['jax'] = None\n" + "".join(f"import {m}\n" for m in mods) + \
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\nprint('ok')\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_source_line_imports_jax():
    offenders = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in PKG.rglob("*.py")
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if line.strip().startswith(("import jax", "from jax"))
    ]
    assert offenders == []
