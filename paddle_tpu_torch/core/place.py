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


class Place:
    """A device place (paddle_tpu/core/place.py; platform::Place):
    value-semantic and hashable. ``torch_device()`` is the torch device it
    names."""

    device_id = 0

    def torch_device(self):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CPUPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = device_id

    def torch_device(self):
        return torch.device("cpu")


class TPUPlace(Place):
    """The accelerator place, here the card: ``cuda:<device_id>``, the
    device ``init(use_tpu=True)`` makes the default."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def torch_device(self):
        dev = resolve_device("cuda")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("TPUPlace(%d) out of range: %d CUDA devices"
                               % (self.device_id, torch.cuda.device_count()))
        return torch.device(dev.type, self.device_id)


def default_place():
    """The place of the default device (``resolve_device(None)``)."""
    return TPUPlace() if _default == "cuda" else CPUPlace()


def set_default_place(place):
    """Make ``place``'s device the default of every entry point."""
    if not isinstance(place, Place):
        raise TypeError("expected a Place, got %r" % (place,))
    set_default_device("cuda" if isinstance(place, TPUPlace) else "cpu")


def device_count(place_type=None):
    """The number of CUDA devices (``CPUPlace``: the one CPU)."""
    if place_type is CPUPlace:
        return 1
    return torch.cuda.device_count()


def device_put(tree, place=None):
    """Stage a pytree of tensors (dicts, lists and tuples of them) onto a
    place (paddle_tpu/core/place.py device_put; the default place when
    ``place`` is None)."""
    device = (place or default_place()).torch_device()

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return torch.as_tensor(x, device=device)

    return put(tree)
