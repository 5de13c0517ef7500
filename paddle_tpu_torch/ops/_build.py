"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/lib<name>-<hash>.so``), loaded
with ``ctypes``. The build runs at first use, from the sources in the
checkout only; the file name carries a hash of the source, so an edited
kernel rebuilds and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from paddle_tpu_torch.utils.error import enforce

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}     # name -> ctypes.CDLL
build_logs = {}  # name -> nvcc/ptxas output of the build this process ran


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the port's CUDA kernels build from source at first use")


def source_path(name):
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name):
    with open(source_path(name), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                    digest.hexdigest()[:12]))


def build(name):
    """Compile the kernel library ``name`` unless it is built already.
    Returns its path; raises with the compiler's output when the build
    fails."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                           source_path(name)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    enforce(proc.returncode == 0,
            "kernel build failed: %s (nvcc exit %d):\n%s", name,
            proc.returncode, proc.stdout)
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return out


def build_all(names):
    """Build several kernel libraries at once, one nvcc process each (the
    builds run in parallel). Returns their paths in order."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name):
    """The loaded ``ctypes`` library of one kernel, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
