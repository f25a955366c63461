"""Build and load the hand-written CUDA kernels under `jpgenc_tpu_torch/csrc/`.

At first use every `csrc/*.cu` is compiled to an object file, one `nvcc`
process per source and all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <tmp>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libjpgenc_kernels_<hash>.so <tmp>/*.o

The library is named by a hash of the sources and the flags, so a library
built from other sources is never loaded under a changed C interface (the
stale-`.so` ABI hazard of the reference's `native` loader). The build goes to
`jpgenc_tpu_torch/_build/` (git-ignored); a failed build raises with nvcc's
stderr. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, ints as c_int). Each returns cudaGetLastError() as an int.
SIGNATURES = {
    "k1a_fused_launch": [_P, _I, _I, _I, _I, _I,      # img, B, H, W, hs, vs
                         _I, _I,                      # mps, n_slots
                         _P, _P,                      # kdct, q
                         _P, _P, _P,                  # ac_rows, dc_rows, misc
                         _I, _P, _P, _P, _P],         # w_blk, buf, bits, zz, stream
    "k1a_gray_launch": [_P, _I, _I, _I,               # img, B, H, W
                        _I, _I,                       # mps, n_slots
                        _P, _P,                       # kdct, q
                        _P, _P, _P,                   # ac_rows, dc_rows, misc
                        _I, _P, _P, _P, _P],          # w_blk, buf, bits, zz, stream
    "k1_dct_launch": [_I, _P, _I, _I, _I, _I, _I,     # variant, src, B, H, W, hs, vs
                      _I,                             # n_slots
                      _P, _P, _P, _P],                # op, q, zz, stream
    "k1_gray_launch": [_P, _I, _I, _I, _I,            # img, B, H, W, n_slots
                       _P, _P, _P, _P],               # kdct, q, zz, stream
    "block_pack_launch": [_P, _P, _P, _P, _P,         # zz, dcdiff, actab, dctab, valid
                          _I, _I,                     # B, n_slots
                          _P, _P, _P, _I,             # ac_rows, dc_rows, misc, n_tables
                          _I, _P, _P, _P],            # w_blk, buf, bits, stream
    "symbol_hist_launch": [_P, _P, _P, _P, _P,       # zz, dcdiff, actab, dctab, valid
                           _I, _I, _P, _P],           # B, n_slots, out, stream
    "seg_merge_launch": [_P, _P, _I, _I, _I, _I,       # buf, bits, B, n_seg, spb, w_blk
                         _I, _I, _P,                  # cap_w, walign, scratch
                         _P, _P, _P, _P],             # wstream, nbits, ovf, stream
    "recon_launch": [_P, _P, _P, _P,                  # x, q, kidct, out
                     _I, _I, _I, _I, _I, _I, _I, _P], # B, my, mx, h, w, hs, vs
    "recon_gray_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_LIB = None
_LOADED = {}        # library path -> loaded library
#: wall seconds the last build (or cache hit) took, and nvcc's stderr
build_seconds = None
build_log = ""


def _sources(pattern: str = "*.cu") -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, pattern)))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels can only be built on a machine with the "
                       "CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _sources("*.cuh"):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libjpgenc_kernels_{h.hexdigest()[:16]}.so")


def _build(so: str) -> str:
    """Compile every source in parallel, link to `so`; returns nvcc's stderr.
    Objects and the library are written under temporary names and the
    library renamed last: a concurrent loader never sees a half-written one."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
        logs = [(p.communicate()[1], p.returncode) for _, p in procs]
        log = "".join(err for err, _ in logs)
        if any(rc != 0 for _, rc in logs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        out = os.path.join(tmp, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", out,
                            *(obj for obj, _ in procs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(out, so)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        build_log = _build(so)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.seg_merge_scratch.argtypes = [_I, _I, _I]
    lib.seg_merge_scratch.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _LIB = _LOADED[so] = lib
    return lib


def select(*defines: str) -> ctypes.CDLL:
    """Make `library()` the kernels compiled with these extra nvcc flags
    (`select("-DJPGENC_BPT=8")`; none: the default build) and return it. For
    measuring a compile-time choice against another in one process
    (kernels/tile_sweep.py); the package itself never calls it."""
    global _LIB, NVCC_FLAGS
    NVCC_FLAGS = [f for f in NVCC_FLAGS if not f.startswith("-D")]
    NVCC_FLAGS += list(defines)
    _LIB = _LOADED.get(library_path())
    return library()


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg}) at launch")
