"""Lazy layer graph evaluated eagerly by :class:`Topology`.

Each ``paddle_tpu_torch.layer.*`` call creates a :class:`LayerNode` — a
named DAG node carrying parameter specs and a ``forward(params, inputs,
ctx)`` on torch tensors — exactly as in paddle_tpu/graph.py, so a config
builds the same graph, with the same layer and parameter names, in both
packages. Parameters are keyed by *parameter name* (not layer name).

A ``recurrent_group`` traces its step function once into a step subgraph
(layer/rnn_group.py). While a step is traced its group's frame is on the
group trace stack here, and every node built meanwhile is recorded in the
innermost frame by ``LayerNode.__init__`` itself (the JAX package patches
``LayerNode.__init__`` when its rnn_group module is imported; here the
hook is part of the class).
"""

import itertools
import threading

from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.utils.error import enforce, layer_scope

_name_lock = threading.Lock()
_name_counters = {}
_creation_counter = itertools.count()
_group_state = threading.local()

# Auto-name tags of paddle_tpu/graph.py _REF_NAME_TAGS (the reference's
# wrap_name_default tags) for the layer types this package has, so a node
# built without a name gets the JAX package's name (e.g. pooling ->
# "__seq_pooling_0__", classification_cost -> "__cost_0__"). A type absent
# here keeps its tag verbatim.
_REF_NAME_TAGS = {
    "conv_layer": "conv",
    "img_pool": "pool",
    "batch_norm_layer": "batch_norm",
    "img_cmrnorm": "crmnorm",
    "embedding_layer": "embedding",
    "classification_cost": "cost",
    "square_error_cost": "mse_cost",
    "huber_classification_cost": "huber_cost",
    "grumemory": "gru",
    "trans": "trans_layer",
    "expand": "expand_layer",
    "interpolation": "interpolation_layer",
    "power": "power_layer",
    "scaling": "scaling_layer",
    "sum_to_one_norm": "sum_to_one_norm_layer",
    "linear_comb": "linear_comb_layer",
    "slope_intercept": "slope_intercept_layer",
    "addto_layer": "addto",
    "repeat": "repeat_layer",
    "seq_concat": "seqconcat",
    "seq_reshape": "seqreshape",
    "pooling": "seq_pooling",
    "sampling_id": "sampling_id_layer",
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


def begin_group(group_id):
    """Push a group trace frame (paddle_tpu/layer/rnn_group.py:58-71): its
    ``memories`` take the step's memory placeholders and its ``nodes``
    every node built until ``end_group``. A stack, so groups can nest."""
    stack = getattr(_group_state, "stack", None)
    if stack is None:
        stack = _group_state.stack = []
    frame = {"id": group_id, "memories": [], "nodes": []}
    stack.append(frame)
    return frame


def end_group():
    return _group_state.stack.pop()


def current_group():
    """The innermost group frame being traced, or None."""
    stack = getattr(_group_state, "stack", None)
    return stack[-1] if stack else None


class ParamSpec:
    """Declaration of one named parameter buffer (cf. ParameterConfig)."""

    __slots__ = ("name", "shape", "initializer", "attr", "is_state",
                 "sharding")

    def __init__(self, name, shape, initializer, attr=None, is_state=False):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.initializer = initializer
        self.attr = attr or ParamAttr()
        self.is_state = is_state  # non-trainable running state
        # a parallel.mesh.NamedSharding where each rank holds a block of
        # the parameter (a sharded embedding's table); ``shape`` stays
        # the global shape
        self.sharding = None

    def materialize(self, generator, dtype, device):
        return self.initializer(generator, self.shape, dtype, device)

    def __repr__(self):
        return "ParamSpec(%s, shape=%s)" % (self.name, self.shape)


class Context:
    """Per-evaluation context: the train/test mode, the random generator
    of the stochastic layers (dropout) and a sink for running-state
    updates (batch norm's moving statistics), as in paddle_tpu/graph.py
    (there a JAX key folded per draw; here a ``torch.Generator`` whose
    state advances with every draw)."""

    def __init__(self, mode="test", generator=None):
        self.mode = mode
        self.generator = generator
        self.state_updates = {}
        # a dict in a streaming decode window (Topology.apply_decode): the
        # recurrent layers boot from decode_state[layer_name] ([leaf, ...];
        # zeros where absent) and write their final carry to
        # decode_state_out, which the serving scheduler threads into the
        # next window
        self.decode_state = None
        self.decode_state_out = None
        # {id(step program): [value of each step output]} of the
        # recurrent groups run so far (layer/rnn_group.py get_output)
        self.group_outputs = {}

    @property
    def is_train(self):
        return self.mode == "train"

    def rng_for(self, tensor):
        """The generator to draw a mask for ``tensor`` from; it must be on
        the tensor's device."""
        gen = self.generator
        enforce(gen is not None, "this network uses stochastic layers "
                "(dropout); pass rng= (a torch.Generator) to Topology.apply")
        enforce(gen.device.type == tensor.device.type,
                "the generator is on %s, the tensor on %s", gen.device,
                tensor.device)
        return gen

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
        group = current_group()
        if group is not None:  # built while a step function is traced
            group["nodes"].append(self)

    def forward(self, params, input_values, ctx):
        with layer_scope(self.name):
            return self._forward_fn(params, input_values, ctx)

    # graph sugar (v1 layer_math; paddle_tpu/graph.py LayerNode.__add__):
    # layer + layer builds addto (a width-1 side broadcasts), layer +/-
    # const slope_intercept, layer * const a scale, layer * layer a
    # row-wise scaling when one side has width 1
    def __add__(self, other):
        from paddle_tpu_torch import layer as L

        if isinstance(other, LayerNode):
            a, b = self, other
            if a.size != b.size:
                if a.size == 1:
                    a, b = b, a
                enforce(b.size == 1, "layer + layer needs equal sizes or a "
                        "width-1 side (%s vs %s)", a.size, b.size)
            return L.addto(input=[a, b])
        return L.slope_intercept(input=self, intercept=float(other))

    __radd__ = __add__

    def __sub__(self, other):
        from paddle_tpu_torch import layer as L

        if isinstance(other, LayerNode):
            return L.addto(
                input=[self, L.slope_intercept(input=other, slope=-1.0)])
        return L.slope_intercept(input=self, intercept=-float(other))

    def __rsub__(self, other):
        from paddle_tpu_torch import layer as L

        return L.slope_intercept(input=self, slope=-1.0,
                                 intercept=float(other))

    def __mul__(self, other):
        from paddle_tpu_torch import layer as L

        if isinstance(other, LayerNode):
            if self.size == 1:
                return L.scaling(input=other, weight=self)
            if other.size == 1:
                return L.scaling(input=self, weight=other)
            raise TypeError(
                "layer * layer needs one side of width 1 (reference "
                "layer_math.mul contract); use dotmul for elementwise")
        return L.slope_intercept(input=self, slope=float(other))

    __rmul__ = __mul__

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
