"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/lib<name>-<hash>.so``), loaded
with ``ctypes``. The build runs at first use, from the sources in the
checkout only; the file name carries a hash of the source and of the
shared headers ``csrc/*.cuh``, so an edited kernel rebuilds and a stale
library is never loaded.

``check_args``, ``aligned`` and ``launch`` are what every kernel wrapper
shares: the argument checks against the kernel's contract, 16-byte
aligned contiguous inputs, and the ctypes call of a
C entry with the common signature (dtype code, pointers, the shape's ints
-- (T, B, H) for the recurrent kernels, (N, H, W, C, F, k, ...) for the
convolutions -- device, stream, info array).

Each library compiled and each library loaded at first use is reported,
with its seconds, as an ``event`` record of the open step logs
(observe/steplog.py ``emit_event``).

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.utils.error import enforce

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the planners size their grids by the card's SM count (``sm_count``); this
# is their default, an H100 SXM's, which the CPU tests plan for
H100_SMS = 132

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
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256()
    for path in [source_path(name)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
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
    t0 = time.perf_counter()
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
    steplog.emit_event("/paddle_tpu_torch/kernel_build/" + name,
                       time.perf_counter() - t0)
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
            t0 = time.perf_counter()
            path = build(name)
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
            steplog.emit_event("/paddle_tpu_torch/kernel_load/" + name,
                               time.perf_counter() - t0)
        return lib


def check_args(what, lead, named):
    """Shapes, dtypes and devices against the leading tensor ``lead``
    (float32 or bfloat16); ``named`` holds (name, tensor, shape, dtype)
    with dtype None for ``lead``'s dtype."""
    dt = lead.dtype
    enforce(dt in DTYPE_CODES, "%s takes float32 or bfloat16 inputs, got %s",
            what, dt)
    enforce(lead.shape[0] >= 1 and lead.shape[1] >= 1,
            "empty sequence batch %s", tuple(lead.shape))
    for name, x, shape, want in named:
        want = dt if want is None else want
        enforce(tuple(x.shape) == shape, "%s must be %s, got %s", name,
                shape, tuple(x.shape))
        enforce(x.dtype == want, "%s must be %s, got %s", name, want,
                x.dtype)
        enforce(x.device == lead.device, "%s is on %s, expected %s", name,
                x.device, lead.device)


def sm_count(dev):
    """The SM count of the card ``dev``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels load it (a
    copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name, dev, tensors, outputs, shape, count):
    """Call the C entry ``name`` of library ``name`` with the dtype code,
    the pointers of ``tensors`` and ``outputs``, the ints of ``shape`` (a
    tuple of any length), the device, the stream and an info array;
    ``count`` gets the launches made (also when the call then fails).
    Returns the info array."""
    enforce(all(x.is_contiguous() for x in tensors),
            "%s needs contiguous inputs", name)
    shape = tuple(int(d) for d in shape)
    lib = load(name)
    fn = getattr(lib, name)
    npt = len(tensors) + len(outputs)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * npt
                   + [ctypes.c_int] * (len(shape) + 1)
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    info = (ctypes.c_int * 6)()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = fn(DTYPE_CODES[tensors[0].dtype],
            *(x.data_ptr() for x in tuple(tensors) + tuple(outputs)), *shape,
            index, stream, info)
    count(info[5])
    if rc != 0:
        raise RuntimeError("%s kernel launch failed (code %d: %s; shape %s)"
                           % (name, rc, err(rc).decode(), shape))
    return info
