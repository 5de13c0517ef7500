"""Device choice for the port's entry points.

An entry point runs on the default device unless its caller passes
``device=``: ``resolve_device(None)`` is the card (``cuda``), or the CPU
after ``paddle_tpu_torch.init(use_tpu=False)`` (``set_default_device``).
With the card as the default, a machine without one raises instead of
moving to the CPU on its own.
"""

import torch

_default = "cuda"


def set_default_device(device):
    """Make ``device`` ("cuda" or "cpu") what ``resolve_device(None)``
    returns."""
    global _default
    _default = torch.device(device).type


def default_device():
    return _default


def resolve_device(device=None):
    """``torch.device`` for ``device`` (None = the default device)."""
    dev = torch.device(_default if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or call "
            "paddle_tpu_torch.init(use_tpu=False)) to run on the CPU "
            "explicitly")
    return dev
