"""Nested sequences in the port against the JAX package on the CPU
(``core/sequence.NestedSequenceBatch``, the nested feed, ``agg_level`` /
``stride`` / ``expand_level``, ``seq_concat`` / ``seq_reshape`` /
``seq_slice`` / ``sub_seq``, ``SubsequenceInput`` and the nested
``recurrent_group``, ``lstm_step`` and ``get_output``), mirroring
tests/test_nested_rnn_group.py and tests/test_sequence.py::test_nested.

Every network is built by both packages from one ``build(pkg)``, given the
same seeded numpy parameters and rows, and held by tests/torch_parity.py:
values within 1e-6 and gradients (parameters and floating feeds) within
1e-5 of max(1, max |JAX|). The rows hold ragged paragraphs: a row with
fewer sub-sequences than the batch's most, sub-sequences of length 1,
and one row with a sub-sequence of length 0, so the outer steps run the
recurrent layers over rows of length 0.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core.sequence import NestedSequenceBatch as JaxNested
from paddle_tpu.topology import convert_column as jax_convert_column

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.topology import Topology, convert_column
from paddle_tpu_torch.utils.error import EnforceError

from tests.torch_parity import assert_match, both, run_both

DIM = 3
VOCAB = 11
# sub-sequence lengths per row: 3, 1 and 4 sub-sequences (one empty)
SHAPE = [[2, 4, 3], [5], [1, 0, 2, 6]]


def _nested(seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(n, DIM).astype(np.float32) for n in subs]
            for subs in SHAPE]


def _nested_ids(seed):
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, VOCAB, n).tolist() for n in subs]
            for subs in SHAPE]


def _rows(seed):
    """Rows as dicts by data layer name: ``nx`` dense nested, ``ids``
    nested ids, ``flat`` one dense step per sub-sequence, ``seq`` a plain
    dense sequence, ``label`` an int."""
    rng = np.random.RandomState(seed + 100)
    nx = _nested(seed)
    out = []
    for i, subs in enumerate(SHAPE):
        row = {"nx": nx[i], "ids": _nested_ids(seed)[i],
               "flat": rng.randn(len(subs), DIM).astype(np.float32),
               "seq": rng.randn(2 + 2 * i, DIM).astype(np.float32),
               "label": int(rng.randint(0, 2))}
        out.append(row)
    return out


def _data(pkg, name, kind):
    dt = pkg.data_type
    types = {"nx": dt.dense_vector_sub_sequence(DIM),
             "ids": dt.integer_value_sub_sequence(VOCAB),
             "flat": dt.dense_vector_sequence(DIM),
             "seq": dt.dense_vector_sequence(DIM),
             "label": dt.integer_value(2)}
    return pkg.layer.data(name=name, type=types[kind])


# -- the batch and the feed ---------------------------------------------------

def test_nested_batch_matches_jax():
    nested = _nested(0)
    want = JaxNested.from_nested(nested)
    got = NestedSequenceBatch.from_nested(nested)
    assert (got.batch_size, got.max_subseqs, got.max_len) == (
        want.batch_size, want.max_subseqs, want.max_len) == (3, 4, 16)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.outer_lengths.numpy(),
                                  np.asarray(want.outer_lengths))
    np.testing.assert_array_equal(got.inner_lengths.numpy(),
                                  np.asarray(want.inner_lengths))
    np.testing.assert_array_equal(got.outer_mask().numpy(),
                                  np.asarray(want.outer_mask()))
    np.testing.assert_array_equal(got.inner_mask(torch.float32).numpy(),
                                  np.asarray(want.inner_mask(np.float32)))
    flat, jflat = got.flatten_to_subsequences(), \
        want.flatten_to_subsequences()
    np.testing.assert_array_equal(flat.data.numpy(), np.asarray(jflat.data))
    np.testing.assert_array_equal(flat.lengths.numpy(),
                                  np.asarray(jflat.lengths))
    per = np.arange(12 * 2, dtype=np.float32).reshape(12, 2)
    outer = got.outer_sequence_of(torch.from_numpy(per))
    jouter = want.outer_sequence_of(per)
    assert isinstance(outer, SequenceBatch)
    np.testing.assert_array_equal(outer.data.numpy(), np.asarray(jouter.data))
    np.testing.assert_array_equal(outer.lengths.numpy(),
                                  np.asarray(jouter.lengths))
    padded = NestedSequenceBatch.from_nested(nested, max_subseqs=5,
                                             max_len=8, dtype=np.float64)
    assert tuple(padded.data.shape) == (3, 5, 8, DIM)
    assert padded.data.dtype == torch.float64


@pytest.mark.parametrize("kind", ["dense", "index", "sparse"])
def test_nested_feed_matches_jax(kind):
    dt_t, dt_j = paddle.data_type, jpaddle.data_type
    if kind == "dense":
        itypes = (dt_t.dense_vector_sub_sequence(DIM),
                  dt_j.dense_vector_sub_sequence(DIM))
        col = _nested(1)
    elif kind == "index":
        itypes = (dt_t.integer_value_sub_sequence(VOCAB),
                  dt_j.integer_value_sub_sequence(VOCAB))
        col = _nested_ids(1)
    else:
        itypes = (dt_t.sparse_binary_vector_sub_sequence(VOCAB),
                  dt_j.sparse_binary_vector_sub_sequence(VOCAB))
        col = [[[ids[:2] for _ in range(len(ids))] for ids in subs]
               for subs in _nested_ids(1)]
    got = convert_column(col, itypes[0], device="cpu")
    want = jax_convert_column(col, itypes[1])
    assert isinstance(got, NestedSequenceBatch)
    assert got.data.dtype == {"index": torch.int32}.get(kind, torch.float32)
    for a, b in ((got.data, want.data), (got.outer_lengths,
                                         want.outer_lengths),
                 (got.inner_lengths, want.inner_lengths)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_apply_takes_numpy_nested_feeds_and_returns_nested_values():
    def build(pkg):
        return pkg.layer.fc(input=_data(pkg, "nx", "nx"), size=2, name="h")

    _, out = both(build)
    topo = Topology(out)
    params = topo.init_params(seed=0, device="cpu")
    nb = JaxNested.from_nested(_nested(2))
    feed = {"nx": NestedSequenceBatch(np.asarray(nb.data),
                                      np.asarray(nb.outer_lengths),
                                      np.asarray(nb.inner_lengths))}
    values, updates = topo.apply(params, feed, mode="test")
    got = values["h"]
    assert isinstance(got, NestedSequenceBatch) and updates == {}
    assert tuple(got.data.shape) == (3, 4, 16, 2)
    assert got.outer_lengths.dtype == torch.int32


# -- layers over nested input -------------------------------------------------

POOLS = {"max": "MaxPooling", "avg": "AvgPooling", "sum": "SumPooling",
         "sqrt": "SqrtAvgPooling"}


@pytest.mark.parametrize("agg_level", [0, 1])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_nested_pooling_matches_jax(pool, agg_level):
    def build(pkg):
        h = pkg.layer.fc(input=_data(pkg, "nx", "nx"), size=4, name="h",
                         act=pkg.activation.Tanh())
        p = pkg.layer.pooling(input=h, name="p", agg_level=agg_level,
                              pooling_type=getattr(pkg.pooling,
                                                   POOLS[pool])())
        return [h, p]

    port, jax_side = run_both(build, _rows(3), ["h", "p"], seed=4)
    assert_match(port, jax_side)


@pytest.mark.parametrize("layer", ["last_seq", "first_seq"])
@pytest.mark.parametrize("agg_level", [0, 1])
def test_nested_instance_matches_jax(layer, agg_level):
    def build(pkg):
        h = pkg.layer.fc(input=_data(pkg, "nx", "nx"), size=4, name="h")
        return getattr(pkg.layer, layer)(input=h, name="pick",
                                         agg_level=agg_level)

    port, jax_side = run_both(build, _rows(5), ["pick"], seed=6)
    assert_match(port, jax_side)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("layer", ["max", "avg", "sum", "sqrt", "last_seq",
                                   "first_seq"])
def test_strided_selection_and_pooling_match_jax(layer, stride):
    def build(pkg):
        h = pkg.layer.fc(input=_data(pkg, "seq", "seq"), size=4, name="h")
        if layer in POOLS:
            return pkg.layer.pooling(
                input=h, name="s", stride=stride,
                pooling_type=getattr(pkg.pooling, POOLS[layer])())
        return getattr(pkg.layer, layer)(input=h, name="s", stride=stride)

    rows = [{"seq": r["seq"]} for r in _rows(7)]
    port, jax_side = run_both(build, rows, ["s"], seed=8)
    assert_match(port, jax_side)
    assert port[0]["s"].shape[1] == -(-16 // stride)


def test_expand_level_is_accepted_as_in_jax():
    def build(pkg):
        vec = pkg.layer.data(name="vec",
                             type=pkg.data_type.dense_vector(DIM))
        vec = pkg.layer.fc(input=vec, size=3, name="v")
        return pkg.layer.expand(input=vec, name="e", expand_level=1,
                                expand_as=_data(pkg, "seq", "seq"))

    rows = [{"seq": r["seq"], "vec": r["flat"][0]} for r in _rows(9)]
    assert_match(*run_both(build, rows, ["e"], seed=10))


def test_pooling_stride_over_nested_is_refused():
    def build(pkg):
        return pkg.layer.pooling(input=_data(pkg, "nx", "nx"), stride=2)

    _, out = both(build)
    topo = Topology(out)
    feed = {"nx": NestedSequenceBatch.from_nested(_nested(0))}
    with pytest.raises(EnforceError, match="stride over nested"):
        topo.apply({}, feed, mode="test")


# -- seq_concat, seq_reshape, seq_slice, sub_seq ------------------------------

def _two_seqs(seed):
    rng = np.random.RandomState(seed)
    return [{"a": rng.randn(n, DIM).astype(np.float32),
             "b": rng.randn(m, DIM).astype(np.float32),
             "off": [float(o)], "size": [float(s)]}
            for n, m, o, s in ((3, 2, 1, 2), (0, 4, 0, 3), (5, 1, 4, 4))]


def _seq_pair(pkg):
    dt = pkg.data_type
    return (pkg.layer.data(name="a", type=dt.dense_vector_sequence(DIM)),
            pkg.layer.data(name="b", type=dt.dense_vector_sequence(DIM)))


def test_seq_concat_matches_jax():
    def build(pkg):
        a, b = _seq_pair(pkg)
        ha = pkg.layer.fc(input=a, size=4, name="ha")
        hb = pkg.layer.fc(input=b, size=4, name="hb")
        return pkg.layer.seq_concat(a=ha, b=hb, name="cat",
                                    act=pkg.activation.Tanh())

    jout, out = both(build)
    assert out.name == jout.name and out.size == 4
    assert_match(*run_both(build, _two_seqs(11), ["cat"], seed=12))


def test_seq_reshape_matches_jax():
    def build(pkg):
        a, _ = _seq_pair(pkg)
        h = pkg.layer.fc(input=a, size=4, name="h")
        return pkg.layer.seq_reshape(input=h, reshape_size=8, name="r")

    rows = [{"a": r["a"]} for r in _two_seqs(13)]
    assert_match(*run_both(build, rows, ["r"], seed=14))


@pytest.mark.parametrize("bounds", ["starts", "ends", "both", "neither"])
def test_seq_slice_matches_jax(bounds):
    def build(pkg):
        a, _ = _seq_pair(pkg)
        dt = pkg.data_type
        off = pkg.layer.data(name="off", type=dt.dense_vector(1))
        size = pkg.layer.data(name="size", type=dt.dense_vector(1))
        h = pkg.layer.fc(input=a, size=4, name="h")
        return pkg.layer.seq_slice(
            input=h, name="sl",
            starts=off if bounds in ("starts", "both") else None,
            ends=size if bounds in ("ends", "both") else None)

    assert_match(*run_both(build, _two_seqs(15), ["sl"], seed=16))


def test_sub_seq_matches_jax():
    def build(pkg):
        a, _ = _seq_pair(pkg)
        dt = pkg.data_type
        off = pkg.layer.data(name="off", type=dt.dense_vector(1))
        size = pkg.layer.data(name="size", type=dt.dense_vector(1))
        h = pkg.layer.fc(input=a, size=4, name="h")
        return pkg.layer.sub_seq(input=h, offsets=off, sizes=size, name="ss")

    assert_match(*run_both(build, _two_seqs(17), ["ss"], seed=18))


# -- the nested recurrent_group -----------------------------------------------

def _outer_lstm(pkg, hidden=4, inner_group=False):
    """paragraphs of sentences -> embedding -> an outer group whose step
    runs an LSTM over the sentence and keeps its last step -> the outer
    sequence of sentence vectors -> max pooling -> softmax."""
    L = pkg.layer
    emb = L.embedding(input=_data(pkg, "ids", "ids"), size=4, name="emb")

    def step(sentence):
        if inner_group:
            h = _inner_group(pkg, sentence, "inner")
        else:
            h = pkg.networks.simple_lstm(input=sentence, size=hidden,
                                         name="sent_lstm")
        return L.last_seq(input=h, name="sent_vec")

    outer = L.recurrent_group(step=step, input=L.SubsequenceInput(emb),
                              name="outer")
    pooled = L.pooling(input=outer, name="para",
                       pooling_type=pkg.pooling.MaxPooling())
    return [outer, L.fc(input=pooled, size=2, name="out",
                        act=pkg.activation.Softmax())]


def _inner_group(pkg, seq, name):
    L = pkg.layer

    def inner_step(x_t):
        mem = L.memory(name=name + "_h", size=4)
        return L.fc(input=[x_t, mem], size=4, act=pkg.activation.Tanh(),
                    name=name + "_h",
                    param_attr=pkg.attr.ParamAttr(name=name + "_w"),
                    bias_attr=False)

    return L.recurrent_group(step=inner_step, input=seq, name=name)


def test_outer_group_over_an_lstm_matches_jax():
    """The flagship's LSTM inside the outer loop, once per sub-sequence:
    rows with fewer sub-sequences and an empty sub-sequence run it over
    rows of length 0; values and gradients as JAX's."""
    rows = [{"ids": r["ids"]} for r in _rows(19)]
    port, jax_side = run_both(lambda pkg: _outer_lstm(pkg), rows,
                              ["outer", "out"], seed=20)
    assert_match(port, jax_side)
    outer = port[0]["outer"]
    assert outer.shape == (3, 4, 4)
    # past each row's outer length the outer sequence is zero
    np.testing.assert_array_equal(outer[1, 1:], 0.0)
    # the empty sub-sequence's vector is zero (the masked LSTM output)
    np.testing.assert_array_equal(outer[2, 1], 0.0)


def test_group_in_group_matches_jax_and_the_flat_inner_group():
    rows = [{"ids": r["ids"]} for r in _rows(21)]
    port, jax_side = run_both(
        lambda pkg: _outer_lstm(pkg, inner_group=True), rows,
        ["outer", "out"], seed=22)
    assert_match(port, jax_side)
    # the flat formulation: the same inner group over each sub-sequence
    _, flat = both(lambda pkg: pkg.layer.last_seq(
        input=_inner_group(pkg, pkg.layer.data(
            name="fx", type=pkg.data_type.dense_vector_sequence(4)),
            "inner"), name="fl"))
    ftopo = Topology(flat)
    _, nested = both(lambda pkg: _outer_lstm(pkg, inner_group=True))
    topo = Topology(nested)
    params = topo.init_params(seed=3, device="cpu")
    feed = {"ids": NestedSequenceBatch.from_nested(
        [r["ids"] for r in rows])}
    values, _ = topo.apply(params, feed, mode="test",
                           outputs=["emb", "outer"])
    emb, outer = values["emb"], values["outer"].data
    for i, subs in enumerate(SHAPE):
        for j, n in enumerate(subs):
            if n == 0:
                continue
            fvals, _ = ftopo.apply(
                {"inner_w": params["inner_w"]},
                {"fx": SequenceBatch(emb.data[i, j, :n][None],
                                     torch.tensor([n]))}, mode="test")
            torch.testing.assert_close(outer[i, j], fvals["fl"][0],
                                       rtol=1e-5, atol=1e-6)


def test_nested_and_flat_inlinks_memory_and_a_nested_output_match_jax():
    """A nested and a flat inlink with a memory across sub-sequences; the
    group's second output is a sequence per sub-sequence, so it comes back
    nested (``get_output``)."""
    def build(pkg):
        L = pkg.layer
        x, f = _data(pkg, "nx", "nx"), _data(pkg, "flat", "flat")

        def step(sub, f_t):
            mem = L.memory(name="acc", size=DIM, boot_bias=True,
                           is_seq=False)
            s = L.pooling(input=sub, name="sub_sum",
                          pooling_type=pkg.pooling.SumPooling())
            acc = L.addto(input=[s, mem, f_t], name="acc",
                          act=pkg.activation.Tanh())
            h = L.fc(input=sub, size=DIM, name="sub_h")
            return [acc, h]

        group = L.recurrent_group(step=step, input=[x, f], name="g")
        inner = L.get_output(input=group, arg_name="sub_h", name="g_h")
        return [group, inner]

    port, jax_side = run_both(build, _rows(23), ["g", "g_h"], seed=24)
    assert_match(port, jax_side)
    _, (group, inner) = both(build)
    values, _ = Topology([group, inner]).apply(
        Topology(group).init_params(seed=0, device="cpu"),
        {"nx": NestedSequenceBatch.from_nested(_nested(23)),
         "flat": SequenceBatch.from_sequences([r["flat"]
                                               for r in _rows(23)])},
        mode="test")
    assert isinstance(values["g_h"], NestedSequenceBatch)
    assert isinstance(values["g"], SequenceBatch)


def test_nested_group_refuses_reverse_and_short_flat_inlinks():
    def build(pkg, reverse=False):
        L = pkg.layer
        return L.recurrent_group(
            step=lambda sub, f_t: L.addto(input=[L.last_seq(input=sub),
                                                 f_t]),
            input=[_data(pkg, "nx", "nx"), _data(pkg, "flat", "flat")],
            reverse=reverse, name="rg")

    _, rev = both(lambda pkg: build(pkg, reverse=True))
    nx = NestedSequenceBatch.from_nested(_nested(0))
    flat = SequenceBatch.from_sequences([r["flat"] for r in _rows(0)])
    with pytest.raises(EnforceError, match="reverse=True over nested"):
        Topology(rev).apply({}, {"nx": nx, "flat": flat}, mode="test")
    _, fwd = both(build)
    short = SequenceBatch(flat.data, torch.tensor([3, 1, 2]))
    with pytest.raises(EnforceError, match="shorter than sub-sequence"):
        Topology(fwd).apply({}, {"nx": nx, "flat": short}, mode="test")


# -- lstm_step and get_output -------------------------------------------------

def _lstm_unit_net(pkg):
    """The lstmemory_unit pattern: lstm_step with its cell state read back
    by get_output into the next step's memory."""
    L = pkg.layer
    x = _data(pkg, "seq", "seq")

    def step(x_t):
        h_mem = L.memory(name="cell_h", size=4)
        c_mem = L.memory(name="cell_c", size=4)
        gates = L.fc(input=[x_t, h_mem], size=16, name="gates")
        h = L.lstm_step(input=gates, state=c_mem, size=4, name="cell_h")
        L.get_output(input=h, arg_name="state", name="cell_c")
        return h

    h = L.recurrent_group(step=step, input=x, name="unit")
    return [h, L.last_seq(input=h, name="last")]


def test_lstm_step_and_its_state_match_jax():
    rows = [{"seq": r["seq"]} for r in _rows(25)]
    port, jax_side = run_both(_lstm_unit_net, rows, ["unit", "last"],
                              seed=26)
    assert_match(port, jax_side)
    jout, out = both(_lstm_unit_net)
    specs = Topology(out).param_specs()
    assert specs["cell_h.wbias"].shape == (12,)


@pytest.mark.parametrize("acts", ["default", "relu"])
def test_lstm_step_alone_matches_jax(acts):
    def build(pkg):
        L = pkg.layer
        kw = ({} if acts == "default" else
              {"act": pkg.activation.Relu(), "gate_act":
               pkg.activation.Sigmoid(), "state_act": pkg.activation.Tanh()})
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(16))
        c = pkg.layer.data(name="c", type=pkg.data_type.dense_vector(4))
        cell = L.lstm_step(input=x, state=c, size=4, name="cell", **kw)
        return [cell, L.get_output(input=cell, arg_name="state",
                                   name="state")]

    rng = np.random.RandomState(27)
    rows = [{"x": rng.randn(16).astype(np.float32),
             "c": rng.randn(4).astype(np.float32)} for _ in range(3)]
    assert_match(*run_both(build, rows, ["cell", "state"], seed=28))


def test_get_output_is_refused_where_jax_refuses():
    def build(pkg):
        L = pkg.layer
        return L.recurrent_group(
            step=lambda x_t: L.fc(input=L.fc(input=x_t, size=2,
                                             name="hidden"), size=2,
                                  name="o"),
            input=_data(pkg, "seq", "seq"), name="g1")

    _, group = both(build)
    with pytest.raises(EnforceError, match="must be returned"):
        paddle.layer.get_output(input=group, arg_name="hidden")
    with pytest.raises(EnforceError, match="no inner layer"):
        paddle.layer.get_output(input=group, arg_name="nowhere")
