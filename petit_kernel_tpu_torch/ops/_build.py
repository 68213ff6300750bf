"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

Each source compiles in its own nvcc process, all started together, and
one more nvcc links the objects into one shared library with a plain C
interface, for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <tmp>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libpetit_<hash>.so <tmp>/*.o

The library name carries a hash of the sources and flags (csrc/*.cu and
the headers csrc/*.cuh they include), so an unchanged tree loads the
library it built before and an edit of any source or header rebuilds. The
build directory is petit_kernel_tpu_torch/_build/ (git-ignored). The
library is loaded with ctypes: every pointer and the stream pass as
c_void_p, every size as c_int and every element stride as c_longlong;
every C entry returns cudaGetLastError() of its launch, which `check`
turns into an exception. Nothing here runs at import time.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# the KV appends' arguments (csrc/kv_append.cu)
_KV_APPEND = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L,
              _L, _L, _L, _L, _L, _I, _I, _L, _P)
# C entry points and their argument types (csrc/*.cu, extern "C")
SIGNATURES = {
    # a, words, scales, gs, out, ws, counters, m, n, k, kp, block_m,
    # block_n, splits, stream
    "pk_fp4_gemm": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _P),
    "pk_fp4_gemm_wc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P),
    # the same arguments as pk_fp4_gemm, with f32 a and out
    "pk_fp4_gemm_hp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P),
    "pk_fp4_gemm_hp_wc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _P),
    # a_i8, arow, words, r_t, acol, gs, out, ws, counters, m, n, k, kp,
    # block_m, block_n, splits, stream
    "pk_fp4_gemm_w4a8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    "pk_fp4_gemm_w4a8_wc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _P),
    # xs, words, scales, gs, out, ws, counters, rows, E, cap, n, k, kp,
    # block_m, block_n, splits, stream
    "pk_grouped_fp4_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P),
    # words, scales, out, kp, n, stream
    "pk_fp4_dequant": (_P, _P, _P, _I, _I, _P),
    # a, words, scales, gs, wd, outf, outd, ws, counters, m, nf, nd, k, kp,
    # block_m, block_n, splits_f, splits_d, stream
    "pk_hybrid_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P),
    # q, ck, cv, pos, out, ws, counters, B, H, Hkv, S, d, window, splits,
    # chunk, sm_scale, stream
    "pk_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _P),
    # q, ck, cv, pos0, out, B, T, H, Hkv, S, d, window, sm_scale, stream
    "pk_prefill_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P),
    # ck, cv, kn, vn, pos, mask, B, T, S, Hkv, d, elt, cast, k_sb, k_st,
    # k_sh, v_sb, v_st, v_sh, pos_sb, pos_st, pos_bytes, mask_bytes,
    # mask_sb, stream
    "pk_kv_append": _KV_APPEND,
    "pk_kv_append_headed": _KV_APPEND,
    # kp, vp, table, kn, vn, pos, mask, B, T, P, ps, max_pages, table_sb,
    # Hkv, d, elt, cast, then pk_kv_append's strides, flags and stream
    "pk_kv_append_paged": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, *_KV_APPEND[9:]),
    # q, k, v, block_tables, pos, out, ws, counters, B, H, Hkv, d,
    # max_pages, ps, page_stride, head_stride, window, kv_fp8, splits, chunk,
    # sm_scale, stream
    "pk_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _L, _L, _I, _I, _I, _I, _F, _P),
    # q, k, v, block_tables, pos0, out, B, T, H, Hkv, d, max_pages, ps,
    # page_stride, head_stride, window, kv_fp8, sm_scale, stream
    "pk_paged_prefill_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _L, _L, _I, _I, _F, _P),
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}/{src.stem}.o",
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in jobs:          # wait for every job, then report
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{logs[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = f"{tmp}/lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
               *sorted(str(p) for p in Path(tmp).glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return BuildInfo(out, time.perf_counter() - t0, "".join(logs))


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
