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
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.data_type import (DENSE, INDEX, SEQ_NONE, SEQ_SINGLE,
                                        SPARSE_BINARY, SPARSE_FLOAT)
from paddle_tpu_torch.graph import Context, LayerNode, topo_sort
from paddle_tpu_torch.layer.base import ImageValue
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import enforce

# sparse slots at/above this dim feed as SparseRows (padded id lists);
# below it they densify at the boundary (paddle_tpu/topology.py:25)
flags.define_flag("sparse_feed_threshold", 4096,
                  "sparse_binary/float_vector slots with dim >= this use "
                  "the gather/weighted-sum sparse path instead of dense "
                  "[B, dim] conversion")


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
        # {producer name: [(consumer node, input position)]}; a data
        # layer read only by cost layers at position >= 1 (a label, score
        # or weight) is a label feed, which the mixed-precision policy
        # leaves in float32 so the cost sees the exact target
        # (paddle_tpu/topology.py:91-111)
        from paddle_tpu_torch.layer.cost import COST_LAYER_TYPES

        consumers = {}
        for node in self.nodes:
            for pos, parent in enumerate(node.inputs):
                consumers.setdefault(parent.name, []).append((node, pos))
        self._label_feed_names = {
            name for name in self.data_layers
            if consumers.get(name)
            and all(n.layer_type in COST_LAYER_TYPES and pos >= 1
                    for n, pos in consumers[name])}

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
              state_updates=None, generator=None):
        """Evaluate the DAG. Returns ``{layer_name: value}`` for the output
        nodes (or ``outputs``); an image value crosses the boundary as its
        flat NCHW rows. ``mode="test"`` runs under
        ``torch.inference_mode()`` (serving) and never updates running
        state; ``mode="train"`` records the autograd graph, so a cost from
        it can be differentiated back to the parameters (under the
        mixed-precision policy, through their casts to the compute dtype),
        and puts the new values of the running-state parameters into the
        dict ``state_updates`` when one is given. ``generator`` (a
        ``torch.Generator`` on the feed's device) draws the dropout masks
        of a train-mode evaluation; one that needs a mask raises without
        it."""
        enforce(mode in ("test", "train"), "Topology.apply: mode must be "
                "'test' or 'train', got %r", mode)
        ctx = Context(mode=mode, generator=generator)
        out = self._evaluate(params, feed, ctx, outputs)
        if state_updates is not None:
            state_updates.update(ctx.state_updates)
        return out

    def apply_decode(self, params, feed, decode_state, outputs=None):
        """Evaluate the DAG as ONE streaming window of a longer sequence
        (paddle_tpu/topology.py apply_decode): the recurrent layers boot
        from ``decode_state`` (``{layer_name: [carry leaf, ...]}``; a
        missing layer boots from zeros) and their final carries come back,
        so the caller can thread them into the next window. Test mode.

        Returns ``({layer_name: value}, {layer_name: [carry leaf, ...]})``;
        the continuous-batching decode step (serve/export.py) is built on
        it. Reverse recurrent layers refuse (layer/recurrent.py), and
        layers that mix time positions are refused at export
        (serve/export.py ``_check_streamable``)."""
        ctx = Context(mode="test")
        ctx.decode_state = {} if decode_state is None else decode_state
        ctx.decode_state_out = {}
        out = self._evaluate(params, feed, ctx, outputs)
        return out, ctx.decode_state_out

    def _evaluate(self, params, feed, ctx, outputs):
        cd = dtype_mod.compute_dtype()
        values = {}
        grad_mode = (torch.inference_mode() if ctx.mode == "test"
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
                        if cd is not None and \
                                node.name not in self._label_feed_names:
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
            return {name: _external(values[name]) for name in wanted}

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
    if isinstance(value, SparseRows):
        return value.map_vals(fn)
    return fn(value)


def convert_feed(topology, data_batch, device, feeding=None, max_len=None):
    """Convert a host minibatch (list of tuples, v2 reader convention) into
    feed values on ``device``: dense slots become [B, dim] tensors, index
    slots int32 [B], sequence slots SequenceBatch (padded to ``max_len``,
    default the length bucket of the batch's longest sequence), sparse
    slots SparseRows at or above the ``sparse_feed_threshold`` flag and
    dense [B, dim] rows below it."""
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
    sparse = itype.value_type in (SPARSE_BINARY, SPARSE_FLOAT)
    np_dtype = {DENSE: np.float32, INDEX: np.int32}.get(itype.value_type)
    enforce(sparse or np_dtype is not None,
            "input type %r is not ported yet", itype)
    if itype.seq_type == SEQ_NONE:
        if not sparse:
            return torch.as_tensor(np.asarray(col, dtype=np_dtype),
                                   device=device)
        if itype.dim >= flags.get_flag("sparse_feed_threshold"):
            # padded id lists + the gather/weighted-sum matmul instead of
            # [B, dim] rows (paddle_tpu/topology.py:298-308)
            return SparseRows.from_rows(
                col, itype.dim, with_values=itype.value_type == SPARSE_FLOAT,
                device=device)
        return torch.as_tensor(_densify(col, itype), device=device)
    enforce(itype.seq_type == SEQ_SINGLE,
            "nested sequence inputs are not ported yet (%r)", itype)
    if sparse:
        # a sparse sequence slot densifies per step at any dim
        seqs = [_densify(s, itype) for s in col]
    else:
        seqs = [np.asarray(s, dtype=np_dtype) for s in col]
    return SequenceBatch.from_sequences(seqs, device=device, max_len=max_len)


def _densify(rows, itype):
    """Sparse ids / (id, value) pairs -> dense float32 rows (the JAX
    package's paddle_tpu/topology.py:327-345). Duplicate ids sum, as the
    SparseRows gather/weighted-sum path does, so results agree on both
    sides of sparse_feed_threshold."""
    if isinstance(rows, np.ndarray) and rows.ndim == 2:
        return rows.astype(np.float32)
    first = rows[0] if len(rows) else None
    is_batch = isinstance(first, (list, tuple, np.ndarray))
    batch = rows if is_batch else [rows]
    out = np.zeros((len(batch), itype.dim), dtype=np.float32)
    for i, row in enumerate(batch):
        for item in row:
            if isinstance(item, (tuple, list)):
                idx, val = item
                out[i, int(idx)] += float(val)
            else:
                out[i, int(item)] += 1.0
    return out if is_batch else out[0]
