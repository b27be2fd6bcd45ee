"""Build and load the port's CUDA kernels.

The sources under ``pna_tpu_torch/csrc/`` have a plain C interface.  Each
``.cu`` file is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a``, the objects are linked into one shared library, and the
library is loaded with ``ctypes``.  The library lives in
``pna_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed on a
hash of every file under ``csrc/`` (headers included) and the flags, so a
stale build is never loaded; it is built at first use on the machine with the
card, where the CUDA toolkit is (``$CUDA_HOME``, default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


def sources():
    """The translation units: every ``.cu`` file under ``csrc/``."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    """The library's path, keyed on the flags and on every file under
    ``csrc/``: an edit to a shared header rebuilds as an edit to a source
    does."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        if not os.path.isfile(src):
            continue
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpna_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH;"
                           " the CUDA kernels are built on the GPU machine")
    return found


def build() -> str:
    """Compile every source in parallel and link them into the library;
    returns its path.  The ptxas report (registers, spills) of each source is
    kept beside it as ``<library>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            name = os.path.basename(src)
            log.append(f"== {name} (rc {p.returncode})\n{out}")
            objs.append(obj)
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o",
                               tmp_so], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed:\n{link.stdout}{link.stderr}")
        with open(so + ".log", "w") as f:
            f.write("\n".join(log))
            f.write(f"\nbuilt in {time.perf_counter() - t0:.1f} s\n")
        os.replace(tmp_so, so)
    return so


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library (built at first use), with every entry point's
    argument and return types declared."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    # msg and 5 table pointers, 6 sizes (n_seg .. n_feat), 6 outputs and the
    # partials, the ties flag, the stream
    lib.pna_csr_moment_sketch.argtypes = [p] * 6 + [i] * 6 + [p] * 7 + [i, p]
    lib.pna_csr_moment_sketch.restype = i
    lib.pna_csr_moment_sketch_max_feat.argtypes = []
    lib.pna_csr_moment_sketch_max_feat.restype = i
    lib.pna_csr_dmsg.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p, p]
    lib.pna_csr_dmsg.restype = i
    # 10 pointers (u .. ke), the bfloat16 flag, 8 sizes (n_seg .. fe)
    fused_head = [p] * 10 + [i]
    fused_sizes = [i] * 8
    lib.pna_csr_pretrans_sketch.argtypes = (fused_head + fused_sizes
                                            + [p] * 7 + [i, p])
    lib.pna_csr_pretrans_sketch.restype = i
    lib.pna_csr_pretrans_dmsg.argtypes = (fused_head + [p] * 6 + fused_sizes
                                          + [p] * 4)
    lib.pna_csr_pretrans_dmsg.restype = i
    lib.pna_pretrans_shared_bytes.argtypes = [i, i]
    lib.pna_pretrans_shared_bytes.restype = ctypes.c_longlong
    lib.pna_pretrans_shared_limit.argtypes = []
    lib.pna_pretrans_shared_limit.restype = ctypes.c_longlong
    # src, the bfloat16 flag, perm, the keys and their int64 flag, ptr, 3
    # sizes (E, N, F), out, its bfloat16 flag, the partials, the stream
    lib.pna_sorted_row_sum.argtypes = [p, i, p, p, i, p, i, i, i, p, i, p,
                                       p]
    lib.pna_sorted_row_sum.restype = i
    lib.pna_sorted_row_sum_tile.argtypes = []
    lib.pna_sorted_row_sum_tile.restype = i
    lib.pna_cuda_error_string.argtypes = [i]
    lib.pna_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.pna_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
