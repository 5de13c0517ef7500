"""Recurrent layers: lstmemory, grumemory and recurrent (reference:
LstmLayer.cpp, GatedRecurrentLayer, RecurrentLayer; paddle_tpu/layer/
recurrent.py). Like the reference, ``lstmemory`` consumes an input
already projected to 4*size, ``grumemory`` one projected to 3*size
(networks.simple_lstm / simple_gru put an fc in front) and ``recurrent``
one of its own size."""

from paddle_tpu_torch.activation import to_activation
from paddle_tpu_torch.core.sequence import PackedSequenceBatch, SequenceBatch
from paddle_tpu_torch.layer.base import (
    bias_spec,
    is_seq,
    make_node,
    register_layer,
    weight_spec,
)
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.utils.error import enforce


def _run_seq_scan(x, inp, reverse, scan_fn, ctx, name):
    """Run a masked recurrent scan over the (possibly packed) sequence
    ``x`` whose bias-adjusted projection is ``inp`` (paddle_tpu/layer/
    recurrent.py ``_run_seq_scan``): ``scan_fn(data, reset_bt, reverse,
    state) -> (h_seq [B, T, H], [final carry leaf, ...])``.

    A plain SequenceBatch takes the scan with its own ``reverse`` (the
    kernels' path). A PackedSequenceBatch resets the carry at its segment
    starts (``reset_bt``), and ``reverse`` reverses each segment before
    and after a forward scan (``PackedSequenceBatch.reverse``), so a
    packed row computes what its sequences compute unpacked.

    In a streaming decode window (``ctx.decode_state`` is a dict,
    ``Topology.apply_decode``) the scan boots from
    ``decode_state[name]`` (zeros when absent) and its final carry goes to
    ``ctx.decode_state_out[name]``, which the serving scheduler threads
    into the next window. The scan is masked, so a slot of length 0 this
    window passes its carry through untouched. A reverse layer reads
    future timesteps and refuses decode mode, and packed rows refuse it
    too: the slot matrix is the packing."""
    dstate = ctx.decode_state
    if dstate is not None:
        enforce(not reverse,
                "reverse recurrent layer %r cannot stream: a right-to-left "
                "scan reads future timesteps the decode window has not seen "
                "yet", name)
        enforce(not isinstance(x, PackedSequenceBatch),
                "streaming decode over packed rows is unsupported (layer "
                "%r): the slot matrix IS the packing", name)
        h_seq, final = scan_fn(inp, None, False, dstate.get(name))
        ctx.decode_state_out[name] = list(final)
        return SequenceBatch(h_seq, x.lengths)
    if not isinstance(x, PackedSequenceBatch):
        h_seq, _ = scan_fn(inp, None, reverse, None)
        return SequenceBatch(h_seq, x.lengths)
    px = PackedSequenceBatch(inp, x.lengths, x.segments)
    data = px.reverse().data if reverse else px.data
    h_seq, _ = scan_fn(data, px.reset_mask(), False, None)
    out = PackedSequenceBatch(h_seq, x.lengths, x.segments)
    return out.reverse() if reverse else out


# The default of ``gate_bias_attr`` (paddle_tpu/layer/recurrent.py): a
# dedicated object, so that any other value (None included) selects the
# split gate-bias parameterization it names.
MERGED_GATE_BIAS = object()


@register_layer("lstmemory")
def lstmemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, state_act=None, bias_attr=None, param_attr=None,
              use_peephole=None, gate_bias_attr=MERGED_GATE_BIAS,
              layer_attr=None):
    """LSTM over a pre-projected sequence (input.size == 4*size).

    act = cell-output activation (default tanh), gate_act sigmoid,
    state_act candidate/cell activation (default tanh).

    Bias layout is the reference's merged 7*size (LstmLayer.cpp:32): 4*size
    gate biases followed by the three peephole check vectors, and the
    peephole connections are ON whenever the layer has a bias.
    ``bias_attr=False`` gives the plain (bias-free, peephole-free) cell;
    ``use_peephole=False`` forces a 4*size bias without peepholes.
    ``reverse=True`` runs each sequence right to left (``ops.rnn.
    lstm_scan``).

    ``gate_bias_attr`` other than its default selects the recurrent-group
    SPLIT parameterization (networks.lstmemory_group): the 4*size gate
    bias is its own parameter ``<name>_proj.wbias`` (False: none) and
    ``bias_attr`` names the 3*size peephole-check parameter.
    """
    size = size or input.size // 4
    enforce(input.size == 4 * size, "lstmemory input.size must be 4*size")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("lstmemory")
    wspec = weight_spec(name, 0, (size, 4 * size), param_attr, fan_in=size)
    # the literal "merged" stays an explicit spelling of the default
    split = (gate_bias_attr is not MERGED_GATE_BIAS
             and gate_bias_attr != "merged")
    peephole = use_peephole is not False  # reference default: on with bias
    gspec = None
    if split:
        gspec = bias_spec(name + "_proj", (4 * size,), gate_bias_attr)
        bspec = bias_spec(name, (3 * size,), bias_attr) if peephole else None
    else:
        bspec = bias_spec(name, ((7 if peephole else 4) * size,), bias_attr)
    if bspec is None:
        enforce(use_peephole is not True,
                "lstmemory: use_peephole=True needs a bias parameter to hold "
                "the check vectors (the reference's 7*size bias, "
                "LstmLayer.cpp:32) — bias_attr=False contradicts it")
        peephole = False  # no bias parameter -> no check vectors
    g_act = to_activation(gate_act or "sigmoid")
    s_act = to_activation(state_act or "tanh")
    o_act = to_activation(act or "tanh")
    standard_acts = (g_act.name == "sigmoid" and s_act.name == "tanh"
                     and o_act.name == "tanh")

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "lstmemory expects a sequence input")
        gates = x.data
        w_peep = None
        if split:
            if gspec is not None:
                gates = gates + params[gspec.name]
            if bspec is not None:
                w_peep = params[bspec.name]
        elif bspec is not None:
            bias = params[bspec.name]
            gates = gates + bias[: 4 * size]
            if peephole:
                w_peep = bias[4 * size:]

        def scan_fn(data, reset, rev, state):
            h_seq, (h_f, c_f) = rnn_ops.lstm_scan(
                data, x.mask(data.dtype), w_in=None, b=None,
                w_rec=params[wspec.name],
                h0=None if state is None else state[0],
                c0=None if state is None else state[1],
                gate_act=g_act.apply, state_act=s_act.apply, reverse=rev,
                use_peephole=peephole, w_peep=w_peep,
                standard_acts=standard_acts, out_act=o_act.apply,
                reset_bt=reset)
            return h_seq, [h_f, c_f]

        return _run_seq_scan(x, gates, reverse, scan_fn, ctx, name)

    specs = [s for s in (wspec, gspec, bspec) if s is not None]
    return make_node("lstmemory", forward, [input], name=name, size=size,
                     param_specs=specs, layer_attr=layer_attr)


@register_layer("grumemory")
def grumemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, bias_attr=None, param_attr=None,
              layer_attr=None):
    """GRU over a pre-projected sequence (input.size == 3*size).

    ONE recurrent weight [size, 3*size] (the reference
    GatedRecurrentLayer's single parameter, so a shared ParamAttr name
    ties whole GRUs together), whose columns are the update gate, the
    reset gate and the candidate in that order (paddle_tpu/ops/rnn.py
    gru_step), and a 3*size bias added to the projection before the scan.
    ``act`` is the candidate activation (default tanh), ``gate_act`` the
    gates' (default sigmoid). ``reverse=True`` runs each sequence right
    to left (``ops.rnn.gru_scan``). In a decode window the scan carries
    its state across windows (``_run_seq_scan``).
    """
    size = size or input.size // 3
    enforce(input.size == 3 * size, "grumemory input.size must be 3*size")
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("grumemory")
    wspec = weight_spec(name, 0, (size, 3 * size), param_attr, fan_in=size)
    bspec = bias_spec(name, (3 * size,), bias_attr)
    g_act = to_activation(gate_act or "sigmoid")
    s_act = to_activation(act or "tanh")
    standard_acts = g_act.name == "sigmoid" and s_act.name == "tanh"

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "grumemory expects a sequence input")
        proj = x.data
        if bspec is not None:
            proj = proj + params[bspec.name]
        w = params[wspec.name]

        def scan_fn(data, reset, rev, state):
            # the final carry is h_seq's last step (masked steps carry h
            # forward), one K5 launch on a CUDA tensor
            h_seq, h_f = rnn_ops.gru_scan(
                data, x.mask(data.dtype), w_in=None, b=None,
                w_rec_rz=w[:, :2 * size], w_rec_c=w[:, 2 * size:],
                h0=None if state is None else state[0],
                gate_act=g_act.apply, state_act=s_act.apply, reverse=rev,
                reset_bt=reset, standard_acts=standard_acts)
            return h_seq, [h_f]

        return _run_seq_scan(x, proj, reverse, scan_fn, ctx, name)

    specs = [s for s in (wspec, bspec) if s is not None]
    return make_node("grumemory", forward, [input], name=name, size=size,
                     param_specs=specs, layer_attr=layer_attr)


@register_layer("recurrent")
def recurrent(input, name=None, act=None, reverse=False, bias_attr=None,
              param_attr=None, layer_attr=None):
    """Vanilla recurrent layer over a pre-projected sequence (reference:
    RecurrentLayer; input.size == size): h_t = act(x_t + b + h_{t-1} W),
    act tanh by default. One weight ``<name>.w0`` [size, size] and a bias
    ``<name>.wbias``; ``reverse=True`` runs each sequence right to left;
    in a decode window the carry threads across windows
    (``_run_seq_scan``). The scan is ``ops.rnn.rnn_scan``, a step loop:
    the JAX package has no Pallas kernel for it."""
    size = input.size
    from paddle_tpu_torch.graph import auto_name

    name = name or auto_name("recurrent_layer")
    wspec = weight_spec(name, 0, (size, size), param_attr, fan_in=size)
    bspec = bias_spec(name, (size,), bias_attr)
    act_fn = to_activation(act or "tanh").apply

    def forward(params, values, ctx):
        x = values[0]
        enforce(is_seq(x), "recurrent expects a sequence input")
        inp = x.data
        if bspec is not None:
            inp = inp + params[bspec.name]

        def scan_fn(data, reset, rev, state):
            h_seq, h_f = rnn_ops.rnn_scan(
                data, x.mask(data.dtype), params[wspec.name],
                h0=None if state is None else state[0], act=act_fn,
                reverse=rev, reset_bt=reset)
            return h_seq, [h_f]

        return _run_seq_scan(x, inp, reverse, scan_fn, ctx, name)

    specs = [s for s in (wspec, bspec) if s is not None]
    return make_node("recurrent", forward, [input], name=name, size=size,
                     param_specs=specs, layer_attr=layer_attr)
