"""Host C++ of the port: the witness-tape interpreter.

The port's copy of the tape half of `sirius_tpu/native/__init__.py`
(`_load_tape`, `tape_replay_native`, with the same ctypes argtypes).
`witness_tape.cpp` is built with g++ at first use into
`sirius_tpu_torch/_build/` (git-ignored) under a name keyed by a hash of the
source and flags; the library is written to a temporary file and moved in
with `os.replace`, so concurrent first users (test workers) each build and
the last move wins.  Nothing happens at import.  A failed build or a
non-zero return of the interpreter raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

TAPE_SRC = Path(__file__).with_name("witness_tape.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


@lru_cache(maxsize=None)
def _load_tape() -> ctypes.CDLL:
    """Build (if needed) and load the tape interpreter."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(TAPE_SRC.read_bytes())
    so = BUILD_DIR / f"witness_tape_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(TAPE_SRC)], capture_output=True, text=True,
                                  timeout=300)
        except OSError as exc:
            raise RuntimeError(f"witness tape build: cannot run {CXX!r}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"witness tape build failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.sirius_tape_replay.restype = ctypes.c_int
    lib.sirius_tape_replay.argtypes = [
        _U8P, _U32P, _U32P, _U32P, ctypes.c_int64, ctypes.c_int64,
        _U8P, _U8P, _U8P, ctypes.c_int64, _U32P, ctypes.c_int64, _U8P,
    ]
    return lib


def tape_replay_native(finalized, inputs, out_slots: np.ndarray) -> np.ndarray:
    """Run the C++ tape interpreter; returns (len(out_slots), 32) uint8
    little-endian values.

    `finalized` = (code u8, a u32, b u32, c u32, const int list) from
    `TapeBuilder._finalize()`.
    """
    lib = _load_tape()
    code, a, b, c, consts = finalized
    inp_buf = b"".join(int(v).to_bytes(32, "little") for v in inputs)
    mag_buf = b"".join(abs(int(v)).to_bytes(128, "little") for v in consts)
    neg_buf = bytes(1 if v < 0 else 0 for v in consts)
    inp_arr = np.frombuffer(inp_buf, dtype=np.uint8) if inp_buf else np.zeros(1, np.uint8)
    mag_arr = np.frombuffer(mag_buf, dtype=np.uint8) if mag_buf else np.zeros(1, np.uint8)
    neg_arr = np.frombuffer(neg_buf, dtype=np.uint8) if neg_buf else np.zeros(1, np.uint8)
    out_slots = np.ascontiguousarray(out_slots, dtype=np.uint32)
    out = np.zeros((len(out_slots), 32), dtype=np.uint8)

    def p8(x):
        return x.ctypes.data_as(_U8P)

    def p32(x):
        return x.ctypes.data_as(_U32P)

    rc = lib.sirius_tape_replay(
        p8(code), p32(a), p32(b), p32(c),
        len(code), len(inputs),
        p8(inp_arr), p8(mag_arr), p8(neg_arr), len(consts),
        p32(out_slots), len(out_slots), p8(out),
    )
    if rc != 0:
        raise RuntimeError(f"native tape replay failed with code {rc}")
    return out
