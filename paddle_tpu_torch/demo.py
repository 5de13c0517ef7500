"""Run a script written against the JAX package on the port, unchanged:

    python -m paddle_tpu_torch.demo demos/mnist/train.py --model vgg [--cpu]

Inside :class:`PortBinding`, ``import paddle_tpu`` and every ``import
paddle_tpu.X`` give the port's module objects (``paddle_tpu_torch`` and
``paddle_tpu_torch.X``), so ``isinstance`` holds across both names. A meta
path finder placed first answers every such name, so a script's own
``sys.path.insert`` of the repository root cannot let a file of the JAX
package through; a module the port lacks fails with "not ported yet". The
``paddle_tpu`` entries of ``sys.modules`` (and ``sys.path``) are set
aside on entry and exactly those are put back on exit, as
``cli.ConfigScope`` scopes ``paddle`` for v1 configs. Inside it
``np.asarray`` of any tensor (on the card, or one that requires grad)
gives a host copy, as it does of any JAX array (a script reads
``Topology.apply``'s values so); outside it torch refuses those, as it
always does.

:func:`run` executes the file with ``runpy`` as ``__main__`` with its own
arguments. The card is the default; ``--cpu`` (``device="cpu"``) calls
``init(use_tpu=False)`` first, which makes the CPU the default of every
entry point. The runner never moves to the CPU on its own.
"""

import importlib
import importlib.abc
import importlib.util
import runpy
import sys

ALIAS = "paddle_tpu"
PORT = "paddle_tpu_torch"


def port_name(name):
    """The port's module name for ``paddle_tpu`` or ``paddle_tpu.X``, or
    None for any other name."""
    if name == ALIAS or name.startswith(ALIAS + "."):
        return PORT + name[len(ALIAS):]
    return None


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, target):
        self.target = target

    def create_module(self, spec):
        return importlib.import_module(self.target)

    def exec_module(self, module):
        pass


class _PortFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        name = port_name(fullname)
        if name is None:
            return None
        if importlib.util.find_spec(name) is None:
            raise ModuleNotFoundError("%s is not ported yet (no %s)"
                                      % (fullname, name), name=fullname)
        return importlib.util.spec_from_loader(fullname, _AliasLoader(name))


class PortBinding:
    """The scope in which ``paddle_tpu`` names the port (module
    docstring). Re-entrant only by nesting distinct instances."""

    def __init__(self):
        self._finder = _PortFinder()
        self._saved = None
        self._path = None
        self._array = None

    def __enter__(self):
        import torch

        self._array = torch.Tensor.__array__

        def host_array(tensor, *args, **kwargs):
            return self._array(tensor.detach().cpu(), *args, **kwargs)

        torch.Tensor.__array__ = host_array
        self._saved = {n: m for n, m in sys.modules.items()
                       if port_name(n) is not None}
        for name in self._saved:
            del sys.modules[name]
        self._path = list(sys.path)
        sys.meta_path.insert(0, self._finder)
        return self

    def __exit__(self, *exc):
        import torch

        torch.Tensor.__array__ = self._array
        sys.meta_path.remove(self._finder)
        sys.path[:] = self._path
        for name in [n for n in sys.modules if port_name(n) is not None]:
            del sys.modules[name]
        sys.modules.update(self._saved)
        self._saved = self._path = self._array = None


def _with_device(device, fn):
    """``fn()`` after ``init(use_tpu=device != "cpu")`` (None keeps the
    current default device), the previous default put back after."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core import place

    before = place.default_device()
    if device is not None:
        paddle_tpu_torch.init(use_tpu=device != "cpu")
    try:
        return fn()
    finally:
        place.set_default_device(before)


def run(path, argv=(), device=None):
    """Execute the script at ``path`` as ``__main__`` with arguments
    ``argv`` on the port; returns its globals."""
    def main():
        saved_argv = sys.argv
        sys.argv = [path] + list(argv)
        try:
            with PortBinding():
                return runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = saved_argv

    return _with_device(device, main)


def load(path, name="paddle_tpu_torch_demo"):
    """Import the script at ``path`` as a module (its ``__main__`` block
    not run) with ``paddle_tpu`` bound to the port, so its functions
    (a demo's ``build``) build the port's layers."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    with PortBinding():
        spec.loader.exec_module(module)
    return module


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--cpu" in args:
        args.remove("--cpu")
        device = "cpu"
    if not args:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    run(args[0], args[1:], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
