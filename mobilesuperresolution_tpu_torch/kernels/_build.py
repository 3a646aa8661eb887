"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``: a few seconds
per source, where a build against PyTorch's headers takes minutes. Sources
build in parallel, at first use, into ``_build/`` beside ``csrc/`` (listed in
.gitignore); a library newer than its source is reused. Nothing here runs at
import time, so the CPU-only test suite imports every kernel module.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("conv5x5", "fused_tail", "fused_wdsr_block")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def _paths(name):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name):
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build(names=SOURCES):
    """Compile every stale source of ``names``, one ``nvcc`` each, all
    started together. Returns the wall seconds spent. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``_build/<name>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=log, stderr=subprocess.STDOUT
        )
        procs.append((name, proc, tmp, lib, log))
    failed = []
    for name, proc, tmp, lib, log in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        logs = []
        for n in failed:
            with open(os.path.join(BUILD_DIR, f"{n}.log")) as f:
                logs.append(f.read()[-4000:])
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    return time.perf_counter() - t0


def load(name, signatures):
    """Build (if stale) and load ``lib<name>.so``; ``signatures`` maps each C
    function to its ctypes ``argtypes`` (every function returns an int CUDA
    error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_paths(name)[1])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(lib, fn, *args):
    """Call a C launcher and raise on the CUDA error code it returns (the
    ``cudaGetLastError()`` right after the launch)."""
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
