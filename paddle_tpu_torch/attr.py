"""Parameter and layer extra attributes.

Parity with trainer_config_helpers/attrs.py (reference:
python/paddle/trainer_config_helpers/attrs.py — ParameterAttribute,
ExtraLayerAttribute) and ParameterConfig proto fields
(proto/ParameterConfig.proto): per-parameter learning-rate multipliers,
L1/L2 decay, init policy, static (frozen) parameters, sparse update.
"""


class ParamAttr:
    """Per-parameter configuration; ``name`` enables parameter sharing
    between layers (same semantics as the reference's ParamAttr name)."""

    def __init__(
        self,
        name=None,
        is_static=False,
        initial_std=None,
        initial_mean=0.0,
        initial_max=None,
        initial_min=None,
        initializer=None,
        l1_rate=None,
        l2_rate=None,
        learning_rate=1.0,
        momentum=None,
        gradient_clipping_threshold=None,
        sparse_update=False,
        update_hooks=None,
    ):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        # uniform-init bounds (reference ParameterAttribute initial_max/min,
        # trainer_config_helpers/attrs.py — selects uniform over gaussian)
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.initializer = initializer
        self.l1_rate = l1_rate
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.gradient_clipping_threshold = gradient_clipping_threshold
        self.sparse_update = sparse_update
        # post-update hooks, e.g. HookAttribute/StaticPruningHook parity
        # (reference: parameter/ParameterUpdaterHook.cpp) — objects with
        # init_mask(name, param) and apply(name, param) -> param
        self.update_hooks = update_hooks

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, bool):
            return ParamAttr(is_static=not arg)
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))


ParameterAttribute = ParamAttr


class ExtraAttr:
    """Extra layer attributes (cf. ExtraLayerAttribute): dropout, error
    clipping, and per-layer placement.

    ``sharding`` is a PartitionSpec-style tuple of mesh-axis names, one
    per output dim. Under ``parallel.use_mesh(mesh)`` an fc layer whose
    last entry names an axis of the mesh computes only its column block
    on each rank of that axis, and its consumers receive the gathered
    value; any other layer kind, or any other entry, computes whole (the
    value semantics of JAX's ``with_sharding_constraint``). With no
    active mesh it changes nothing, as in the JAX package. ``device`` (an
    int in the reference) is accepted so configs build unchanged and is
    ignored (placement is expressed as sharding).
    """

    def __init__(self, drop_rate=None, error_clipping_threshold=None,
                 device=None, sharding=None):
        self.drop_rate = drop_rate
        self.error_clipping_threshold = error_clipping_threshold
        self.device = device
        self.sharding = tuple(sharding) if sharding is not None else None

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ExtraAttr()
        if isinstance(arg, ExtraAttr):
            return arg
        raise TypeError("cannot convert %r to ExtraAttr" % (arg,))


ExtraLayerAttribute = ExtraAttr

# v2 short aliases (reference: python/paddle/v2/attr.py — Param/Extra)
Param = ParamAttr
Extra = ExtraAttr
