"""Lazy layer graph evaluated eagerly by :class:`Topology`.

Each ``paddle_tpu_torch.layer.*`` call creates a :class:`LayerNode` — a
named DAG node carrying parameter specs and a ``forward(params, inputs,
ctx)`` on torch tensors — exactly as in paddle_tpu/graph.py, so a config
builds the same graph, with the same layer and parameter names, in both
packages. Parameters are keyed by *parameter name* (not layer name).
"""

import itertools
import threading

from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.utils.error import enforce, layer_scope

_name_lock = threading.Lock()
_name_counters = {}
_creation_counter = itertools.count()

# Auto-name tags aligned with paddle_tpu/graph.py _REF_NAME_TAGS for the
# layer types this package has (e.g. pooling -> "__seq_pooling_0__").
_REF_NAME_TAGS = {
    "conv_layer": "conv",
    "img_pool": "pool",
    "batch_norm_layer": "batch_norm",
    "embedding_layer": "embedding",
    "grumemory": "gru",
    "addto_layer": "addto",
    "pooling": "seq_pooling",
}


def auto_name(layer_type):
    tag = _REF_NAME_TAGS.get(layer_type, layer_type)
    with _name_lock:
        idx = _name_counters.get(tag, 0)
        _name_counters[tag] = idx + 1
    return "__%s_%d__" % (tag, idx)


def reset_name_counters():
    with _name_lock:
        _name_counters.clear()


class ParamSpec:
    """Declaration of one named parameter buffer (cf. ParameterConfig)."""

    __slots__ = ("name", "shape", "initializer", "attr", "is_state")

    def __init__(self, name, shape, initializer, attr=None, is_state=False):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.initializer = initializer
        self.attr = attr or ParamAttr()
        self.is_state = is_state  # non-trainable running state

    def materialize(self, generator, dtype, device):
        return self.initializer(generator, self.shape, dtype, device)

    def __repr__(self):
        return "ParamSpec(%s, shape=%s)" % (self.name, self.shape)


class Context:
    """Per-evaluation context: the train/test mode and a sink for
    running-state updates (batch norm's moving statistics), as in
    paddle_tpu/graph.py."""

    def __init__(self, mode="test"):
        self.mode = mode
        self.state_updates = {}

    @property
    def is_train(self):
        return self.mode == "train"

    def update_state(self, name, value):
        """Record the new value of the running-state parameter ``name``."""
        self.state_updates[name] = value


class LayerNode:
    """One node of the layer DAG. ``size`` is the feature width exposed to
    downstream layers (cf. LayerConfig.size)."""

    def __init__(self, layer_type, forward_fn, inputs=(), name=None, size=0,
                 param_specs=(), extra_attr=None):
        self.layer_type = layer_type
        self.name = name or auto_name(layer_type)
        self.inputs = list(inputs)
        self.size = size
        self.param_specs = list(param_specs)
        self.extra_attr = extra_attr or ExtraAttr()
        self._forward_fn = forward_fn
        # declaration order: the default feeding maps reader tuple columns
        # to data layers in the order the user declared them
        self.creation_index = next(_creation_counter)

    def forward(self, params, input_values, ctx):
        with layer_scope(self.name):
            return self._forward_fn(params, input_values, ctx)

    def __repr__(self):
        return "LayerNode(%s:%s, size=%d)" % (self.name, self.layer_type,
                                              self.size)


LayerOutput = LayerNode


def topo_sort(outputs):
    """Post-order topological sort of the DAG reachable from ``outputs``."""
    order, seen = [], set()
    on_path = set()

    def visit(node):
        if id(node) in seen:
            return
        enforce(id(node) not in on_path, "cycle in layer graph at %r",
                node.name)
        on_path.add(id(node))
        for parent in node.inputs:
            visit(parent)
        on_path.discard(id(node))
        seen.add(id(node))
        order.append(node)

    for out in outputs:
        visit(out)
    return order
