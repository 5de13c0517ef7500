"""The recurrent-group layer family of the port (``layer/rnn_group.py``,
``layer/step.py``, ``layer/attention_utils.py``, ``first_seq`` /
``last_seq`` / ``expand``, ``networks.simple_attention``) against the JAX
package on the CPU, with inputs made by numpy from a seed.

- ``first_seq``, ``last_seq`` and ``expand`` on ragged input (lengths 0
  to T): forward within 1e-6.
- ``gru_step``, ``sequence_softmax_pool`` and ``simple_attention``:
  forward within 1e-6, gradients (parameters and inputs) within 1e-5 of
  max(1, max |JAX|); the pool in bfloat16 gives padded steps exactly 0
  weight and no NaN, a sequence of length 0 included.
- A generic ``recurrent_group``: two sequence inputs, a non-sequence
  StaticInput, ``memory(boot_with_const_value=)`` and a memory booted
  from a layer, ``reverse`` False and True: forward and gradients within
  1e-5.
- The group's loop runs once per ``Topology.apply`` (T step evaluations),
  and both packages hoist the same step nodes out of it.
- Every option left out raises "not ported yet"; memory() outside a
  group and a step reading a layer from outside its group are refused.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.layer import rnn_group
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.error import EnforceError

FWD_TOL, GRAD_TOL = 1e-6, 1e-5
B, T, D = 5, 7, 6
LENGTHS = np.array([T, 1, 4, 0, 6], np.int32)
PACKAGES = ((jpaddle, jax_reset_names), (paddle, reset_name_counters))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


def _both(build):
    """``build(pkg)`` in each package, names counted from 0 in each."""
    outs = []
    for pkg, reset in PACKAGES:
        reset()
        outs.append(build(pkg))
    return outs


def _np_params(topology, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s.shape) * scale).astype(np.float32)
            for k, s in sorted(topology.param_specs().items())}


def _feeds(arrays):
    """{name: (data, lengths or None)} -> (JAX feed, port feed)."""
    jfeed, feed = {}, {}
    for name, (data, lengths) in arrays.items():
        if lengths is None:
            jfeed[name] = jnp.asarray(data)
            feed[name] = torch.from_numpy(data)
        else:
            jfeed[name] = JaxSequenceBatch(jnp.asarray(data),
                                           jnp.asarray(lengths))
            feed[name] = SequenceBatch(torch.from_numpy(data),
                                       torch.from_numpy(lengths))
    return jfeed, feed


def _value(v):
    return v.data if hasattr(v, "data") and hasattr(v, "lengths") else v


def _run_both(jout, out, np_params, arrays, seed):
    """Forward values and gradients (of the sum of the output times a
    fixed random tensor) with respect to every parameter and every float
    feed, in both packages."""
    jfeed, feed = _feeds(arrays)
    jtopo, topo = JaxTopology(jout), Topology(out)
    want = _value(jtopo.apply({k: jnp.asarray(v)
                               for k, v in np_params.items()},
                              jfeed, mode="test")[0][jout.name])
    r = np.random.RandomState(seed).randn(*np.shape(want)).astype(
        np.float32)
    float_feeds = [k for k, (d, _) in arrays.items()
                   if d.dtype == np.float32]

    def jloss(p, xs):
        f = dict(jfeed)
        for k, x in xs.items():
            f[k] = (JaxSequenceBatch(x, f[k].lengths)
                    if isinstance(f[k], JaxSequenceBatch) else x)
        return jnp.sum(_value(jtopo.apply(p, f, mode="train")[0][
            jout.name]) * r)

    jgrads = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        {k: jnp.asarray(arrays[k][0]) for k in float_feeds})
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in np_params.items()}
    xs = {k: torch.from_numpy(arrays[k][0].copy()).requires_grad_()
          for k in float_feeds}
    for k, x in xs.items():
        feed[k] = (SequenceBatch(x, feed[k].lengths)
                   if isinstance(feed[k], SequenceBatch) else x)
    got = _value(topo.apply(leaves, feed, mode="train")[out.name])
    (got * torch.from_numpy(r)).sum().backward()
    grads = {**{k: v.grad for k, v in leaves.items()},
             **{k: v.grad for k, v in xs.items()}}
    return (got.detach(), np.asarray(want), grads,
            {**jgrads[0], **jgrads[1]})


def _check_grads(grads, jgrads):
    assert sorted(grads) == sorted(jgrads)
    for name, want in jgrads.items():
        assert grads[name] is not None, name
        assert _rel(grads[name], want) <= GRAD_TOL, name


# -- first_seq, last_seq, expand ----------------------------------------------

def _sequence_net(pkg):
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector_sequence(D))
    row = L.data(name="row", type=dt.dense_vector(3))
    return [L.first_seq(input=x), L.last_seq(input=x),
            L.expand(input=row, expand_as=x)]


def test_first_last_seq_and_expand_match_jax():
    jnets, nets = _both(_sequence_net)
    assert [n.name for n in nets] == [n.name for n in jnets] == [
        "__first_seq_0__", "__last_seq_0__", "__expand_layer_0__"]
    rng = np.random.RandomState(1)
    arrays = {"x": (rng.randn(B, T, D).astype(np.float32), LENGTHS),
              "row": (rng.randn(B, 3).astype(np.float32), None)}
    jfeed, feed = _feeds(arrays)
    want = JaxTopology(jnets).apply({}, jfeed)[0]
    got = Topology(nets).apply({}, feed)
    for jn, n in zip(jnets, nets):
        assert _rel(_value(got[n.name]), _value(want[jn.name])) <= FWD_TOL
    expanded = got[nets[2].name]
    np.testing.assert_array_equal(expanded.lengths.numpy(), LENGTHS)
    # the last valid step; zeros past each length in the expansion
    np.testing.assert_array_equal(got[nets[1].name][2].numpy(),
                                  arrays["x"][0][2, 3])
    assert float(expanded.data[3].abs().max()) == 0.0
    assert float(expanded.data[2, 4:].abs().max()) == 0.0


# -- gru_step, the attention pool, simple_attention ---------------------------

@pytest.mark.parametrize("naive", [False, True])
def test_gru_step_matches_jax(naive):
    def build(pkg):
        L, dt = pkg.layer, pkg.data_type
        x = L.data(name="x", type=dt.dense_vector(3 * D))
        h = L.data(name="h", type=dt.dense_vector(D))
        step = L.gru_step_naive if naive else L.gru_step
        return step(input=x, output_mem=h, size=D, name="gs")

    jout, out = _both(build)
    topo = Topology(out)
    assert {k: s.shape for k, s in topo.param_specs().items()} == {
        "gs.w0": (D, 3 * D), "gs.wbias": (3 * D,)}
    rng = np.random.RandomState(2)
    arrays = {"x": (rng.randn(B, 3 * D).astype(np.float32), None),
              "h": (rng.randn(B, D).astype(np.float32), None)}
    got, want, grads, jgrads = _run_both(jout, out, _np_params(topo, 3),
                                         arrays, seed=4)
    assert got.shape == (B, D)
    assert _rel(got, want) <= FWD_TOL
    _check_grads(grads, jgrads)


def _attention_net(pkg, pool_only):
    L, dt = pkg.layer, pkg.data_type
    enc = L.data(name="enc", type=dt.dense_vector_sequence(2 * D))
    proj = L.data(name="proj", type=dt.dense_vector_sequence(D))
    if pool_only:
        scores = L.data(name="scores", type=dt.dense_vector_sequence(1))
        utils = importlib.import_module(pkg.__name__
                                        + ".layer.attention_utils")
        return utils.sequence_softmax_pool(scores, enc, name="att")
    state = L.data(name="state", type=dt.dense_vector(5))
    return pkg.networks.simple_attention(encoded_sequence=enc,
                                         encoded_proj=proj,
                                         decoder_state=state, name="att")


@pytest.mark.parametrize("pool_only", [True, False])
def test_attention_matches_jax(pool_only):
    jout, out = _both(lambda pkg: _attention_net(pkg, pool_only))
    topo = Topology(out)
    expected = {} if pool_only else {"att_transform.w0": (5, D),
                                     "att_scores.w0": (D, 1)}
    assert {k: s.shape for k, s in topo.param_specs().items()} == expected
    rng = np.random.RandomState(5)
    lengths = np.array([T, 1, 4, 2, 6], np.int32)
    arrays = {"enc": (rng.randn(B, T, 2 * D).astype(np.float32), lengths),
              "proj": (rng.randn(B, T, D).astype(np.float32), lengths),
              "scores": (rng.randn(B, T, 1).astype(np.float32), lengths),
              "state": (rng.randn(B, 5).astype(np.float32), None)}
    arrays = {k: v for k, v in arrays.items()
              if k in Topology(out).data_layers}
    got, want, grads, jgrads = _run_both(jout, out, _np_params(topo, 6),
                                         arrays, seed=7)
    assert got.shape == (B, 2 * D)
    assert _rel(got, want) <= FWD_TOL
    _check_grads(grads, jgrads)


def test_attention_pool_bfloat16_masks_padding_exactly():
    """Padded logits at bfloat16's lowest value: min - max stays finite,
    so padded steps get weight exactly 0 (not NaN), large logits included,
    and a sequence of length 0 pools to zeros."""
    (out,) = _both(lambda pkg: _attention_net(pkg, True))[1:]
    rng = np.random.RandomState(8)
    lengths = np.array([T, 1, 4, 0, 6], np.int32)
    scores = (rng.randn(B, T, 1) * 50).astype(np.float32)
    scores[0, 0, 0] = 3e38  # near bfloat16's largest finite value
    enc = rng.randn(B, T, 2 * D).astype(np.float32)
    padded = enc.copy()
    padded[np.arange(T)[None, :] >= lengths[:, None]] = 1e4
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        got = []
        for values in (enc, padded):
            _, feed = _feeds({"enc": (values, lengths),
                              "scores": (scores, lengths)})
            got.append(Topology(out).apply({}, feed)[out.name])
    finally:
        dtype_mod.set_mixed_precision(None)
    assert got[0].dtype == torch.bfloat16
    assert bool(torch.isfinite(got[0]).all())
    assert torch.equal(got[0], got[1])  # the padding has no weight at all
    assert float(got[0][3].abs().max()) == 0.0
    # length 1: the one valid step, unscaled
    assert torch.equal(got[0][1], torch.from_numpy(enc[1, 0]).bfloat16())


# -- a generic recurrent_group ------------------------------------------------

def _group_net(pkg, reverse, mixed_out=False):
    """Two sequence inputs, a non-sequence StaticInput, a memory booted
    from a constant and one booted from a layer; the step's output is an
    fc of the second memory's layer (hoisted: it feeds no memory), or
    with ``mixed_out`` a mixed layer over a full_matrix_projection."""
    L, dt, A = pkg.layer, pkg.data_type, pkg.activation
    a = L.data(name="a", type=dt.dense_vector_sequence(4))
    b = L.data(name="b", type=dt.dense_vector_sequence(3))
    ctx = L.data(name="ctx", type=dt.dense_vector(5))
    boot = L.fc(input=ctx, size=D, act=A.Tanh(), name="boot")

    def step(a_t, b_t, ctx_s):
        acc = L.memory(name="acc", size=D, boot_with_const_value=0.25)
        h = L.memory(name="h", size=D, boot_layer=boot)
        acc_new = L.fc(input=[a_t, acc], size=D, act=A.Tanh(), name="acc")
        gin = L.fc(input=[b_t, ctx_s, acc_new], size=3 * D, name="gin")
        h_new = L.gru_step(input=gin, output_mem=h, size=D, name="h")
        if mixed_out:
            return L.mixed(size=4, act=A.Softmax(), name="out",
                           input=[L.full_matrix_projection(input=h_new)])
        return L.fc(input=h_new, size=4, act=A.Softmax(), name="out")

    return L.recurrent_group(step=step, input=[a, b, L.StaticInput(ctx)],
                             reverse=reverse, name="grp")


def _group_arrays(seed):
    rng = np.random.RandomState(seed)
    return {"a": (rng.randn(B, T, 4).astype(np.float32), LENGTHS),
            "b": (rng.randn(B, T, 3).astype(np.float32), LENGTHS),
            "ctx": (rng.randn(B, 5).astype(np.float32), None)}


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_group_matches_jax(reverse):
    jout, out = _both(lambda pkg: _group_net(pkg, reverse))
    assert out.name == jout.name == "grp" and out.size == 4
    assert out.output_activation == jout.output_activation == "softmax"
    topo = Topology(out)
    assert sorted(topo.param_specs()) == sorted(
        JaxTopology(jout).param_specs())
    got, want, grads, jgrads = _run_both(jout, out, _np_params(topo, 9),
                                         _group_arrays(10), seed=11)
    assert got.shape == (B, T, 4)
    assert _rel(got, want) <= GRAD_TOL
    _check_grads(grads, jgrads)
    # zero past each sequence's end, a sequence of length 0 included
    assert float(got[3].abs().max()) == 0.0
    assert float(got[2, 4:].abs().max()) == 0.0


def test_group_hoists_what_jax_hoists_and_loops_once_per_apply(monkeypatch):
    jout, out = _both(lambda pkg: _group_net(pkg, False))
    jprog, prog = jout._step_program, out._step_program
    names = [n.name for n in prog.hoisted_order]
    assert names == [n.name for n in jprog.hoisted_order] == ["out"]
    assert [n.name for n in prog.frontier] == [
        n.name for n in jprog.frontier] == ["h"]
    assert [n.name for n in prog.step_order] == [
        n.name for n in jprog.step_order]
    calls = []
    step = rnn_group._StepProgram.eval_step
    monkeypatch.setattr(rnn_group._StepProgram, "eval_step",
                        lambda self, *a, **k: calls.append(k.get("skip"))
                        or step(self, *a, **k))
    hoisted = []
    hoist = rnn_group._StepProgram.eval_hoisted
    monkeypatch.setattr(rnn_group._StepProgram, "eval_hoisted",
                        lambda self, *a: hoisted.append(1)
                        or hoist(self, *a))
    topo = Topology(out)
    _, feed = _feeds(_group_arrays(12))
    params = {k: torch.from_numpy(v) for k, v in _np_params(topo, 13).items()}
    topo.apply(params, feed)
    assert len(calls) == T and len(hoisted) == 1
    assert all(skip == prog.hoisted_ids for skip in calls)


def test_group_hoists_a_mixed_suffix_as_jax_does():
    """A mixed layer that feeds no memory is hoisted out of the loop, as
    the JAX package hoists it; values and gradients as above."""
    jout, out = _both(lambda pkg: _group_net(pkg, False, mixed_out=True))
    assert [n.name for n in out._step_program.hoisted_order] == [
        n.name for n in jout._step_program.hoisted_order] == ["out"]
    topo = Topology(out)
    got, want, grads, jgrads = _run_both(jout, out, _np_params(topo, 14),
                                         _group_arrays(15), seed=16)
    assert _rel(got, want) <= GRAD_TOL
    _check_grads(grads, jgrads)


# -- what is refused ----------------------------------------------------------

def _in_group(make_step, **kw):
    L, dt = paddle.layer, paddle.data_type
    reset_name_counters()
    x = L.data(name="x", type=dt.dense_vector_sequence(4))
    return L.recurrent_group(step=make_step(x), input=[x], **kw)


def _mem_step(**mem_kw):
    def make(x):
        def step(x_t):
            m = paddle.layer.memory(name="s", size=4, **mem_kw)
            return paddle.layer.fc(input=[x_t, m], size=4, name="s")
        return step
    return make


@pytest.mark.parametrize("build,match", [
    (lambda: _in_group(_mem_step(is_seq=True)), "is_seq"),
    (lambda: _in_group(_mem_step(boot_bias=True)), "boot_bias"),
    (lambda: _in_group(_mem_step(), targetInlink=paddle.layer.data(
        name="y", type=paddle.data_type.dense_vector_sequence(4))),
     "targetInlink"),
    (lambda: paddle.layer.recurrent_group(step=lambda x_t: x_t,
                                          input=[("nested", "rows")]),
     "nested inputs"),
    (lambda: paddle.layer.expand(
        input=paddle.layer.data(name="r", type=paddle.data_type
                                .dense_vector(2)),
        expand_as=paddle.layer.data(name="q", type=paddle.data_type
                                    .dense_vector_sequence(2)),
        expand_level=1), "expand_level"),
    (lambda: paddle.layer.expand(
        input=paddle.layer.data(name="r", type=paddle.data_type
                                .dense_vector(2)),
        expand_as=paddle.layer.data(name="q", type=paddle.data_type
                                    .dense_vector_sequence(2)),
        bias_attr=True), "bias"),
    (lambda: paddle.layer.first_seq(
        input=paddle.layer.data(name="q", type=paddle.data_type
                                .dense_vector_sequence(2)), agg_level=1),
     "agg_level"),
    (lambda: paddle.layer.last_seq(
        input=paddle.layer.data(name="q", type=paddle.data_type
                                .dense_vector_sequence(2)), stride=2),
     "stride"),
], ids=["memory_is_seq", "boot_bias", "targetInlink", "nested_input",
        "expand_level", "expand_bias", "first_seq_agg_level",
        "last_seq_stride"])
def test_options_left_out_raise_not_ported(build, match):
    with pytest.raises(EnforceError, match="%s.*not ported yet" % match):
        build()


def test_group_misuse_is_refused():
    L, dt = paddle.layer, paddle.data_type
    reset_name_counters()
    with pytest.raises(EnforceError, match="inside recurrent_group"):
        L.memory(name="m", size=4)
    x = L.data(name="x", type=dt.dense_vector_sequence(4))
    outside = L.data(name="o", type=dt.dense_vector(4))
    with pytest.raises(EnforceError, match="from outside the group"):
        L.recurrent_group(step=lambda x_t: L.fc(input=[x_t, outside],
                                                size=4), input=[x])
    with pytest.raises(EnforceError, match="does not match"):
        L.recurrent_group(step=lambda x_t: L.fc(input=[x_t, L.memory(
            name="nowhere", size=4)], size=4), input=[x])
    # the trace stack is empty again after a failed trace
    with pytest.raises(EnforceError, match="inside recurrent_group"):
        L.memory(name="m", size=4)
