"""Dataset cache helpers (paddle_tpu/dataset/common.py; reference
python/paddle/v2/dataset/common.py).

``DATA_HOME`` is ``PADDLE_TPU_TORCH_DATA_HOME`` when set, else the JAX
package's directory (``PADDLE_TPU_DATA_HOME``, default
``~/.cache/paddle_tpu/dataset``), so both packages read the same archives.
``download`` implements the reference's contract: fetch into
``DATA_HOME/<module>``, verify MD5, retry, serve from the cache on later
calls. Without network access the fetch fails with an error that points
at each dataset's synthetic readers, which give the dataset's exact
schema.
"""

import hashlib
import os
import shutil

import numpy as np

DATA_HOME = os.path.expanduser(os.environ.get(
    "PADDLE_TPU_TORCH_DATA_HOME",
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset")))

DOWNLOAD_RETRIES = 3


def data_path(module_name, filename):
    return os.path.join(DATA_HOME, module_name, filename)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    """Fetch ``url`` into the dataset cache with MD5 verification and
    retries (reference semantics). Cached files that pass the checksum are
    served without refetching; checksum failures refetch up to
    DOWNLOAD_RETRIES times. Supports any urllib scheme (file:// included —
    used by tests and air-gapped mirrors)."""
    filename = data_path(module_name, save_name or url.split("/")[-1])
    if os.path.exists(filename) and (
            md5sum is None or md5file(filename) == md5sum):
        return filename
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    last_error = None
    for attempt in range(DOWNLOAD_RETRIES):
        tmp = filename + ".part"
        try:
            import urllib.request

            with urllib.request.urlopen(url, timeout=60) as src, \
                    open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst)
        except Exception as exc:  # no egress / transient failure
            last_error = exc
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        if md5sum is not None and md5file(tmp) != md5sum:
            last_error = IOError("md5 mismatch for %s (attempt %d)"
                                 % (url, attempt + 1))
            os.remove(tmp)
            continue
        os.replace(tmp, filename)
        return filename
    raise IOError(
        "cannot fetch %s into %s (%s); if this environment has no network "
        "access, place the file there manually or use the dataset's "
        "synthetic_* readers (same schema, hermetic)"
        % (url, filename, last_error))


def synthetic_rng(name, seed=0):
    """Deterministic per-dataset RNG so synthetic data is stable across runs."""
    mix = int(hashlib.md5(("%s-%d" % (name, seed)).encode()).hexdigest()[:8], 16)
    return np.random.RandomState(mix)
