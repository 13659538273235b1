"""Build the port's CUDA kernels and bind them with ``ctypes``.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process (all
started together) into an object file; one more ``nvcc`` links the objects
into a shared library with a plain C interface.  The build goes into
``build/repro_torch_kernels/`` at the root of the checkout, under a name
that carries a hash of the sources and flags, so an edited source never
loads a stale library.  Nothing here runs when a module is imported: the
first kernel launch calls ``load()``.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and FMA contraction off
(``-fmad=false``), so the kernels' elementwise results equal the plain
PyTorch versions bit for bit and ``log2f`` bins the histograms exactly as
``torch.log2`` does on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fairk_update.cu", "sign_mv.cu", "aou_merge.cu",
           "block_topk.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
# what the last build did: seconds, the library path and each source's
# ``-Xptxas -v`` report (registers, shared memory, spills)
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    # g, fresh, g_prev, age, res, theta_m, theta_a, g_t, age_out, res_out,
    # stats, d, stride, slot, sanitize, stream
    "repro_fairk_update": [_P] * 11 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, _P],
    # votes, noise, signs, energy, n, k, stream
    "repro_sign_mv": [_P] * 4 + [ctypes.c_int, ctypes.c_longlong, _P],
    # x, ld, idx, row, acc, n, k, stream
    "repro_vote_fold": [_P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                        ctypes.c_longlong, _P],
    # energy_in, noise, scaled, noise_std, signs, energy_out, score, k,
    # stream
    "repro_sign_from_energy": [_P, _P, ctypes.c_int, ctypes.c_float,
                               _P, _P, _P, ctypes.c_longlong, _P],
    # g_new, g_old, age, mask, g_out, age_out, d, stream
    "repro_aou_merge": [_P] * 6 + [ctypes.c_longlong, _P],
    # idx, row, noise, g_prev, age, sel_count, aux, g_out, age_out,
    # mask_out, count_out, res_out, d, k, noise_mul, n, superposed, arith,
    # stream
    "repro_aou_merge_by_indices": [_P] * 12 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    # x, vals, idxs, scratch, nb, block_size, m, stream
    "repro_block_topk": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, _P],
    # q, k, v, o, o32, lse, dims, stream
    "repro_flash_attn_fwd": [_P] * 8,
    # dout, q, k, v, o32, lse, delta, dq, dk, dv, dims, stream
    "repro_flash_attn_bwd": [_P] * 12,
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the sources (in parallel) and link one ``.so``; returns its
    path.  Raises with the compiler's output if any step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists() and not force:
        BUILD_INFO.setdefault("library", str(lib_path))
        return lib_path
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas, failed = {}, []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        ptxas[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"kernel link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      library=str(lib_path), ptxas=ptxas)
    return lib_path


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ptr(t) -> Optional[int]:
    """A tensor's device address for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
