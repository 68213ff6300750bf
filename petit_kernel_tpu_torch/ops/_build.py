"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

All sources compile in one nvcc call into one shared library with a plain
C interface, for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/libpetit_<hash>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an unchanged
tree loads the library it built before and a changed one rebuilds. The
build directory is petit_kernel_tpu_torch/_build/ (git-ignored). The
library is loaded with ctypes: every pointer and the stream pass as
c_void_p, every size as c_int, and every C entry returns cudaGetLastError()
of its launch, which `check` turns into an exception. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (csrc/*.cu, extern "C")
SIGNATURES = {
    # a, words, scales, gs, out, m, n, k, kp, block_m, block_n, stream
    "pk_fp4_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, ck, cv, pos, out, B, H, Hkv, S, d, window, sm_scale, stream
    "pk_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P),
    # q, ck, cv, pos0, out, B, T, H, Hkv, S, d, window, sm_scale, stream
    "pk_prefill_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P),
    # ck, cv, kn, vn, pos, mask, B, S, row_bytes, stream
    "pk_kv_append": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}
BUILD_DIR = CSRC.parent / "_build"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


@dataclasses.dataclass
class BuildInfo:
    """What `build()` built or found: the library's path, the seconds nvcc
    took (0.0 when an up-to-date library was reused) and nvcc's output."""
    path: Path
    seconds: float
    log: str


def build() -> BuildInfo:
    """Compile csrc/*.cu unless a library for this exact source hash
    exists. The library is written under a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    out = BUILD_DIR / f"libpetit_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.pk_error_string.argtypes = [ctypes.c_int]
    lib.pk_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        text = library().pk_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({text})")
