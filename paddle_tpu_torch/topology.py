"""Topology: the evaluated view of a layer DAG (paddle_tpu/topology.py).

``apply`` walks the topologically sorted nodes eagerly on torch tensors.
Parameters are a plain ``{name: tensor}`` dict keyed by the JAX package's
parameter names (``lstm0.w0``, ``lstm0.wbias``, ...): those names contain
``.``, which ``nn.ParameterDict`` refuses, and they must stay as they are
so that parameters copy across between the two packages by name.
"""

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data_type import DENSE, INDEX, SEQ_NONE, SEQ_SINGLE
from paddle_tpu_torch.graph import Context, LayerNode, topo_sort
from paddle_tpu_torch.layer.base import ImageValue
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce


class Topology:
    def __init__(self, outputs):
        if isinstance(outputs, LayerNode):
            outputs = [outputs]
        self.outputs = list(outputs)
        self.nodes = topo_sort(self.outputs)
        self.by_name = {}
        for node in self.nodes:
            enforce(node.name not in self.by_name, "duplicate layer name %r",
                    node.name)
            self.by_name[node.name] = node
        self.data_layers = {n.name: n for n in self.nodes
                            if n.layer_type == "data"}
        # declaration-ordered (name, InputType) pairs
        self._data_types = [
            (n.name, n.input_type)
            for n in sorted(self.data_layers.values(),
                            key=lambda n: n.creation_index)
            if getattr(n, "input_type", None) is not None]
        # running-state parameters (batch norm's moving statistics) stay
        # float32 under the mixed-precision policy; their updates bypass
        # the optimizer
        self._state_param_names = {
            name for name, spec in self.param_specs().items()
            if spec.is_state}

    # -- parameters ---------------------------------------------------------
    def param_specs(self):
        """Merged specs keyed by parameter name; shared params must agree."""
        merged = {}
        for node in self.nodes:
            for spec in node.param_specs:
                prev = merged.get(spec.name)
                if prev is None:
                    merged[spec.name] = spec
                else:
                    enforce(prev.shape == spec.shape,
                            "shared parameter %r shape mismatch: %s vs %s",
                            spec.name, prev.shape, spec.shape)
        return merged

    def init_params(self, seed=None, device=None, dtype=None):
        """Materialize all parameters from a ``torch.Generator`` seeded with
        ``seed`` (default: the ``seed`` flag), in sorted-name order."""
        device = resolve_device(device)
        dtype = dtype_mod.canonical(dtype)
        gen = torch.Generator().manual_seed(
            int(flags.get_flag("seed") if seed is None else seed))
        return {name: spec.materialize(gen, dtype, device)
                for name, spec in sorted(self.param_specs().items())}

    # -- evaluation ---------------------------------------------------------
    def apply(self, params, feed, mode="test", outputs=None,
              state_updates=None):
        """Evaluate the DAG. Returns ``{layer_name: value}`` for the output
        nodes (or ``outputs``); an image value crosses the boundary as its
        flat NCHW rows. ``mode="test"`` runs under
        ``torch.inference_mode()`` (serving) and never updates running
        state; ``mode="train"`` records the autograd graph, so a cost from
        it can be differentiated back to the parameters (under the
        mixed-precision policy, through their casts to the compute dtype),
        and puts the new values of the running-state parameters into the
        dict ``state_updates`` when one is given."""
        enforce(mode in ("test", "train"), "Topology.apply: mode must be "
                "'test' or 'train', got %r", mode)
        ctx = Context(mode=mode)
        cd = dtype_mod.compute_dtype()
        values = {}
        grad_mode = (torch.inference_mode() if mode == "test"
                     else contextlib.nullcontext())
        with grad_mode:
            if cd is not None:
                params = {k: (v if k in self._state_param_names
                              else dtype_mod.to_compute(v))
                          for k, v in params.items()}
            for node in self.nodes:
                try:
                    if node.layer_type == "data":
                        enforce(node.name in feed,
                                "missing feed for data layer %r", node.name)
                        value = feed[node.name]
                        if cd is not None:
                            value = _map_data(dtype_mod.to_compute, value)
                        values[node.name] = node.forward(params, [value], ctx)
                    else:
                        inputs = [values[p.name] for p in node.inputs]
                        values[node.name] = node.forward(params, inputs, ctx)
                except Exception as exc:
                    exc.add_note("  in layer %r (type %s), inputs: %s" % (
                        node.name, node.layer_type,
                        [p.name for p in node.inputs]))
                    raise
            wanted = outputs or [o.name for o in self.outputs]
            out = {name: _external(values[name]) for name in wanted}
        if state_updates is not None:
            state_updates.update(ctx.state_updates)
        return out

    def data_types(self):
        """[(name, InputType)] in declaration order (the default feeding
        maps reader tuple columns to data layers in that order)."""
        return self._data_types


def _external(value):
    """Values crossing the topology boundary keep the flat NCHW contract:
    an NHWC image value gives its flat rows."""
    return value.flat() if isinstance(value, ImageValue) else value


def _map_data(fn, value):
    if isinstance(value, SequenceBatch):
        return value.map_data(fn)
    return fn(value)


def convert_feed(topology, data_batch, device, feeding=None, max_len=None):
    """Convert a host minibatch (list of tuples, v2 reader convention) into
    feed values on ``device``: dense slots become [B, dim] tensors, index
    slots int32 [B], sequence slots SequenceBatch (padded to ``max_len``,
    default the length bucket of the batch's longest sequence)."""
    names = [name for name, _ in topology.data_types()]
    if feeding is None:
        feeding = {name: i for i, name in enumerate(names)}
    feed = {}
    for name, itype in topology.data_types():
        idx = feeding[name]
        col = [row[idx] for row in data_batch]
        feed[name] = convert_column(col, itype, device, max_len)
    return feed


def convert_column(col, itype, device, max_len=None):
    np_dtype = {DENSE: np.float32, INDEX: np.int32}.get(itype.value_type)
    enforce(np_dtype is not None, "input type %r is not ported yet", itype)
    if itype.seq_type == SEQ_NONE:
        return torch.as_tensor(np.asarray(col, dtype=np_dtype), device=device)
    enforce(itype.seq_type == SEQ_SINGLE,
            "nested sequence inputs are not ported yet (%r)", itype)
    seqs = [np.asarray(s, dtype=np_dtype) for s in col]
    return SequenceBatch.from_sequences(seqs, device=device, max_len=max_len)
