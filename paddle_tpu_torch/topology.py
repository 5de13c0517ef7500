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
from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                            PackedSequenceBatch,
                                            SequenceBatch)
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.data_type import (DENSE, INDEX, SEQ_NESTED, SEQ_NONE,
                                        SEQ_SINGLE, SPARSE_BINARY,
                                        SPARSE_FLOAT)
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
        self.consumers = consumers
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
    def apply(self, params, feed, mode="train", rng=None, outputs=None):
        """Evaluate the DAG; the JAX package's signature and return value
        (paddle_tpu/topology.py apply). Returns ``({layer_name: value},
        state_updates)`` for the output nodes (or ``outputs``); an image
        value crosses the boundary as its flat NCHW rows.

        ``mode="train"`` (the default) records the autograd graph, so a
        cost from it can be differentiated back to the parameters (under
        the mixed-precision policy, through their casts to the compute
        dtype), and ``state_updates`` holds the new values of the
        running-state parameters (batch norm's moving statistics).
        ``mode="test"`` runs under ``torch.inference_mode()`` (serving)
        and updates no running state. ``rng`` (a ``torch.Generator`` on
        the parameters' device; the counterpart of the JAX PRNG key)
        draws the dropout masks of a train-mode evaluation; one that
        needs a mask raises without it. ``feed`` values may be tensors or
        numpy arrays (and sequence batches of them), which are moved
        onto the parameters' device."""
        enforce(mode in ("test", "train"), "Topology.apply: mode must be "
                "'test' or 'train', got %r", mode)
        ctx = Context(mode=mode, generator=rng)
        out = self._evaluate(params, _feed_on(feed, params), ctx, outputs)
        return out, ctx.state_updates

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

    def apply_all(self, params, feed, mode="test", rng=None):
        """Like ``apply``, but every layer's value (paddle_tpu/topology.py
        apply_all; the trainer's ``show_layer_stat``): ``({layer_name:
        value}, state_updates)``, test mode by default."""
        enforce(mode in ("test", "train"), "Topology.apply_all: mode must "
                "be 'test' or 'train', got %r", mode)
        ctx = Context(mode=mode, generator=rng)
        out = self._evaluate(params, _feed_on(feed, params), ctx,
                             [node.name for node in self.nodes])
        return out, ctx.state_updates

    def _evaluate(self, params, feed, ctx, outputs, record=False):
        """Run the nodes; a test-mode evaluation runs under
        ``torch.inference_mode()`` unless ``record`` (the gradient check's
        test-mode evaluations, which autograd differentiates)."""
        cd = dtype_mod.compute_dtype()
        values = {}
        grad_mode = (torch.inference_mode()
                     if ctx.mode == "test" and not record
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

    # -- proto interchange --------------------------------------------------
    def to_proto(self):
        """Serialize to a ModelConfig message (proto/wire.py): the
        self-contained deployment artifact (reference: python/paddle/v2/
        topology.py:64 Topology.proto(); consumed by ``cli merge_model``
        and the C API without user Python). Its ``SerializeToString()``
        is the JAX package's bytes for the same graph."""
        from paddle_tpu_torch.proto.interchange import topology_to_proto

        return topology_to_proto(self)

    @classmethod
    def from_proto(cls, msg, opaque_builders=None):
        """Rebuild a Topology from a ModelConfig (bytes or message, of
        either package) without executing any user config code. Opaque
        layers (closure-built, e.g. recurrent_group steps) need
        ``opaque_builders``: see proto/interchange.py."""
        from paddle_tpu_torch.proto.interchange import topology_from_proto

        return cls(topology_from_proto(msg, opaque_builders))

    def data_types(self):
        """[(name, InputType)] in declaration order (the default feeding
        maps reader tuple columns to data layers in that order)."""
        return self._data_types


def _external(value):
    """Values crossing the topology boundary keep the flat NCHW contract:
    an NHWC image value gives its flat rows."""
    return value.flat() if isinstance(value, ImageValue) else value


def _map_data(fn, value):
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        return value.map_data(fn)
    if isinstance(value, SparseRows):
        return value.map_vals(fn)
    return fn(value)


def _feed_on(feed, params):
    """``feed`` with its numpy arrays (also those inside sequence batches)
    as tensors on the parameters' device (the first tensor's of the feed
    when there are no parameters), float64 and int64 narrowed to float32
    and int32 as the JAX package's default precision does."""
    device = next((v.device for v in params.values()
                   if isinstance(v, torch.Tensor)), None)
    if device is None:  # a tensor's .data is the tensor itself
        device = next((t.device for t in (getattr(v, "data", v)
                                          for v in feed.values())
                       if isinstance(t, torch.Tensor)), None)
    narrow = {np.dtype(np.float64): torch.float32,
              np.dtype(np.int64): torch.int32}

    def to_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        x = np.array(x, copy=not np.asarray(x).flags.writeable)
        return torch.as_tensor(x, dtype=narrow.get(x.dtype), device=device)

    def convert(value):
        if isinstance(value, PackedSequenceBatch):
            return PackedSequenceBatch(to_tensor(value.data),
                                       to_tensor(value.lengths),
                                       to_tensor(value.segments))
        if isinstance(value, SequenceBatch):
            return SequenceBatch(to_tensor(value.data),
                                 to_tensor(value.lengths))
        if isinstance(value, NestedSequenceBatch):
            return NestedSequenceBatch(to_tensor(value.data),
                                       to_tensor(value.outer_lengths),
                                       to_tensor(value.inner_lengths))
        if isinstance(value, (np.ndarray, np.generic)):
            return to_tensor(value)
        return value

    return {k: convert(v) for k, v in feed.items()}


def convert_feed(topology, data_batch, feeding=None, max_len=None, *,
                 device=None):
    """Convert a host minibatch (list of tuples, v2 reader convention) into
    feed values on ``device`` (the JAX package's signature, with ``device``
    keyword-only; None is the default device, ``resolve_device``): dense
    slots become [B, dim] tensors, index
    slots int32 [B], sequence slots SequenceBatch (padded to ``max_len``,
    default the length bucket of the batch's longest sequence), sparse
    slots SparseRows at or above the ``sparse_feed_threshold`` flag and
    dense [B, dim] rows below it, nested sequence slots
    NestedSequenceBatch."""
    device = resolve_device(device)
    names = [name for name, _ in topology.data_types()]
    if feeding is None:
        feeding = {name: i for i, name in enumerate(names)}
    feed = {}
    for name, itype in topology.data_types():
        idx = feeding[name]
        for row in data_batch:
            enforce(idx < len(row), "sample tuple of length %d has no "
                    "column %d for data layer %r (feeding=%r)", len(row),
                    idx, name, feeding)
        col = [row[idx] for row in data_batch]
        feed[name] = convert_column(col, itype, max_len, device=device)
    return feed


def convert_column(col, itype, max_len=None, *, device=None):
    """One data layer's column of a minibatch as its feed value on
    ``device`` (None: the default device)."""
    device = resolve_device(device)
    sparse = itype.value_type in (SPARSE_BINARY, SPARSE_FLOAT)
    np_dtype = {DENSE: np.float32, INDEX: np.int32}.get(itype.value_type)
    enforce(sparse or np_dtype is not None,
            "unsupported input type %r", itype)
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
    # a sparse sequence slot densifies per step at any dim
    if sparse:
        def steps(s):
            return _densify(s, itype)
    else:
        def steps(s):
            return np.asarray(s, dtype=np_dtype)
    if itype.seq_type == SEQ_NESTED:
        return NestedSequenceBatch.from_nested(
            [[steps(s) for s in subs] for subs in col], device=device)
    enforce(itype.seq_type == SEQ_SINGLE, "unsupported input type %r",
            itype)
    return SequenceBatch.from_sequences([steps(s) for s in col],
                                        device=device, max_len=max_len)


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
