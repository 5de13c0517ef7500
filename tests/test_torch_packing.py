"""Sequence packing in the port against the JAX package on the CPU
(``core/sequence.PackedSequenceBatch``, ``reset_bt`` of the three scans,
``data/bucketing.pack_samples`` / ``pack_feed`` / ``packed_batches``,
the packed dispatch of the recurrent layers and the layers that refuse
packed rows), mirroring tests/test_data_pipeline.py:165-340.

Values within 1e-6 and gradients within 1e-5 of max(1, max |JAX|); a
packed batch's cost and gradients equal the unpacked batch's within 1e-5
(the JAX package's acceptance test, forward and bidirectional).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.core.sequence import PackedSequenceBatch as JaxPacked
from paddle_tpu.data import bucketing as jbucketing
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.sequence import PackedSequenceBatch
from paddle_tpu_torch.data import bucketing
from paddle_tpu_torch.ops import rnn as torch_rnn
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import EnforceError

from tests.torch_parity import both, numpy_params, rel

TOL_FWD = 1e-6
TOL_GRAD = 1e-5


def _segments(seed, b=3, t=12):
    """Random packed layouts: each row holds segments of 1-5 steps, then
    padding (-1)."""
    rng = np.random.RandomState(seed)
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        at, s = 0, 0
        while at < t - 2:
            n = min(int(rng.randint(1, 6)), t - at)
            seg[r, at:at + n] = s
            at, s = at + n, s + 1
            if rng.rand() < 0.2:
                break
    return seg


def test_packed_batch_matches_jax():
    seg = _segments(0)
    lengths = (seg >= 0).sum(axis=1).astype(np.int32)
    data = np.random.RandomState(1).randn(3, 12, 2).astype(np.float32)
    got = PackedSequenceBatch(torch.from_numpy(data),
                              torch.from_numpy(lengths),
                              torch.from_numpy(seg))
    want = JaxPacked(jnp.asarray(data), jnp.asarray(lengths),
                     jnp.asarray(seg))
    np.testing.assert_array_equal(got.reset_mask().numpy(),
                                  np.asarray(want.reset_mask()))
    assert int(got.segment_count()) == int(want.segment_count())
    rev, jrev = got.reverse(), want.reverse()
    assert isinstance(rev, PackedSequenceBatch)
    np.testing.assert_array_equal(rev.data.numpy(), np.asarray(jrev.data))
    np.testing.assert_array_equal(rev.segments.numpy(), seg)
    # reversing twice is the identity, and map_data keeps the segments
    np.testing.assert_array_equal(rev.reverse().data.numpy(), data)
    assert got.map_data(lambda d: d * 2).segments is got.segments


SCANS = ("lstm", "gru", "rnn")


def _scan_args(kind, seed, b=3, t=12, h=4):
    rng = np.random.RandomState(seed)
    width = {"lstm": 4, "gru": 3, "rnn": 1}[kind] * h
    x = rng.randn(b, t, width).astype(np.float32)
    w = rng.randn(h, width).astype(np.float32) / 2
    seg = _segments(seed + 1, b, t)
    mask = (seg >= 0).astype(np.float32)
    h0 = rng.randn(b, h).astype(np.float32)
    return x, w, mask, seg, h0


def _run_scan(mod, kind, x, w, mask, reset, h0, arr, reverse=False):
    h = w.shape[0]
    if kind == "lstm":
        out, (hf, cf) = mod.lstm_scan(arr(x), arr(mask), None, None, arr(w),
                                      h0=arr(h0), c0=arr(h0) * 0.5,
                                      reset_bt=reset, reverse=reverse)
        return out, hf, cf
    if kind == "gru":
        out, hf = mod.gru_scan(arr(x), arr(mask), None, None,
                               arr(w[:, :2 * h]), arr(w[:, 2 * h:]),
                               h0=arr(h0), reset_bt=reset, reverse=reverse)
        return out, hf
    out, hf = mod.rnn_scan(arr(x), arr(mask), arr(w), h0=arr(h0),
                           reset_bt=reset, reverse=reverse)
    return out, hf


def _tensor(a):
    return a if torch.is_tensor(a) else torch.from_numpy(a)


@pytest.mark.parametrize("kind", SCANS)
def test_reset_scans_match_jax(kind):
    """Each scan with a packed reset mask: outputs, final carries and the
    gradients (input, weight, h0) as JAX's ``lax.scan`` branch."""
    x, w, mask, seg, h0 = _scan_args(kind, {"lstm": 2, "gru": 3,
                                            "rnn": 4}[kind])
    reset = JaxPacked(jnp.asarray(x), jnp.asarray(mask.sum(1)),
                      jnp.asarray(seg)).reset_mask()
    r = np.random.RandomState(5).randn(*x.shape[:2], w.shape[0])

    def jloss(x_, w_, h0_):
        outs = _run_scan(jax_rnn, kind, x_, w_, mask, reset, h0_,
                         jnp.asarray)
        return jnp.sum(outs[0] * r) + sum(jnp.sum(o) for o in outs[1:]), \
            outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h0))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, w, h0)]
    treset = torch.from_numpy(np.array(reset))
    outs = _run_scan(torch_rnn, kind, leaves[0], leaves[1], mask, treset,
                     leaves[2], _tensor)
    (torch.sum(outs[0] * torch.from_numpy(r).float())
     + sum(o.sum() for o in outs[1:])).backward()
    for got, want in zip(outs, jouts):
        assert rel(got.detach().numpy(), want) <= TOL_FWD
    for leaf, want in zip(leaves, jgrads):
        assert rel(leaf.grad.numpy(), want) <= TOL_GRAD
    # a whole-row reverse would mix packed neighbours
    with pytest.raises(ValueError, match="pre-reverse per segment"):
        _run_scan(torch_rnn, kind, x, w, mask, treset, h0, _tensor,
                  reverse=True)


# -- the packing helpers ------------------------------------------------------

def _seq_samples(n, seed, vocab=30, labels=5, max_len=9):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = int(rng.randint(1, max_len))
        out.append((rng.randint(0, vocab, k).tolist(),
                    rng.randint(0, labels, k).tolist()))
    return out


def test_pack_samples_and_packed_batches_match_jax():
    samples = _seq_samples(40, seed=1) + [([1] * 25, [0] * 25)]
    rows = bucketing.pack_samples(samples, max_len=20)
    assert rows == jbucketing.pack_samples(samples, max_len=20)
    assert len(rows) < len(samples)
    assert all(sum(len(s[0]) for s in row) <= 20 or len(row) == 1
               for row in rows)
    for open_rows in (64, 3):
        got = list(bucketing.packed_batches(
            lambda: iter(samples), batch_size=4, max_len=20,
            max_open_rows=open_rows)())
        want = list(jbucketing.packed_batches(
            lambda: iter(samples), batch_size=4, max_len=20,
            max_open_rows=open_rows)())
        assert got == want


def test_packed_batches_stream_with_a_bounded_open_set():
    """5-step samples never fill a 64-step row exactly: the capped open
    set still yields batches while the stream runs, and loses nothing."""
    samples = [([1] * 5, [0] * 5) for _ in range(400)]
    reader = bucketing.packed_batches(lambda: iter(samples), batch_size=4,
                                      max_len=64, max_open_rows=8)
    it = reader()
    first = next(it)
    rest = list(it)
    assert sum(len(s[0]) for b in [first] + rest for row in b
               for s in row) == 400 * 5
    assert all(sum(len(s[0]) for s in row) <= 64
               for b in [first] + rest for row in b)


def _tagger(pkg, rnn="gru", bidirectional=False, vocab=30, labels=5,
            hidden=4):
    L = pkg.layer
    word = L.data(name="word", type=pkg.data_type.integer_value_sequence(
        vocab))
    emb = L.embedding(input=word, size=6, name="emb")

    def layer(reverse, name):
        if rnn == "gru":
            return L.grumemory(input=L.fc(input=emb, size=3 * hidden,
                                          name=name + "_p"),
                               size=hidden, reverse=reverse, name=name)
        if rnn == "lstm":
            return L.lstmemory(input=L.fc(input=emb, size=4 * hidden,
                                          name=name + "_p"),
                               size=hidden, reverse=reverse, name=name)
        return L.recurrent(input=L.fc(input=emb, size=hidden,
                                      name=name + "_p"),
                           reverse=reverse, name=name)

    feat = layer(False, "fwd")
    if bidirectional:
        feat = L.concat(input=[feat, layer(True, "bwd")], name="both")
    scores = L.fc(input=feat, size=labels, name="scores")
    label = L.data(name="label", type=pkg.data_type.integer_value_sequence(
        labels))
    return L.classification_cost(input=scores, label=label, name="cost")


def test_pack_feed_matches_jax_and_widens_for_an_overlong_row():
    jcost, cost = both(_tagger)
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    samples = [([1, 2, 3], [0, 1, 2]), ([4, 5], [3, 4]), ([6], [0]),
               (list(range(1, 21)), [0] * 20)]
    rows = bucketing.pack_samples(samples, max_len=8)
    feed = bucketing.pack_feed(topo, rows, max_len=8, device="cpu")
    jfeed = jbucketing.pack_feed(jtopo, rows, max_len=8)
    for name in ("word", "label"):
        got, want = feed[name], jfeed[name]
        assert isinstance(got, PackedSequenceBatch)
        for a, b in ((got.data, want.data), (got.lengths, want.lengths),
                     (got.segments, want.segments)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    word = feed["word"]
    assert word.max_len == 32 and int(word.lengths.max()) == 20
    np.testing.assert_array_equal(word.data[0, :6].numpy(),
                                  [1, 2, 3, 4, 5, 6])
    np.testing.assert_array_equal(word.reset_mask()[0, :8].numpy(),
                                  [1, 0, 0, 1, 0, 1, 0, 0])
    with pytest.raises(TypeError, match="single-level"):
        dense = paddle.layer.data(name="d",
                                  type=paddle.data_type.dense_vector(2))
        bucketing.pack_feed(Topology(dense), [[(np.zeros(2),)]],
                            device="cpu")


def _cost_and_grads(topo, cost, params, feed):
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in params.items()}
    values, _ = topo.apply(leaves, feed, mode="train")
    total = values[cost.name].sum()
    total.backward()
    return float(total.detach()), {k: v.grad.numpy()
                                   for k, v in leaves.items()}


PACK_SAMPLES = [(np.random.RandomState(n).randint(0, 30, n).tolist(),
                 np.random.RandomState(n + 9).randint(0, 5, n).tolist())
                for n in (3, 5, 2, 7, 4, 6, 1, 4)]


@pytest.mark.parametrize("rnn", ["gru", "lstm", "recurrent"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_packed_rows_match_unpacked_and_jax(rnn, bidirectional):
    """The packing acceptance test in the port: the packed batch's cost
    and gradients equal the unpacked batch's; and the packed batch's
    equal the JAX package's on the same parameters."""
    jcost, cost = both(lambda pkg: _tagger(pkg, rnn, bidirectional))
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    params = numpy_params(topo.param_specs(), seed=6)
    cu, gu = _cost_and_grads(topo, cost, params,
                             convert_feed(topo, PACK_SAMPLES, device="cpu"))
    rows = bucketing.pack_samples(PACK_SAMPLES, max_len=16)
    assert len(rows) < len(PACK_SAMPLES)
    feed = bucketing.pack_feed(topo, rows, max_len=16, device="cpu")
    cp, gp = _cost_and_grads(topo, cost, params, feed)
    assert abs(cu - cp) <= 1e-5 * max(1.0, abs(cu))
    for name in gu:
        assert rel(gp[name], gu[name]) <= TOL_GRAD, name

    jfeed = jbucketing.pack_feed(jtopo, rows, max_len=16)

    def jloss(p):
        values, _ = jtopo.apply(p, jfeed, mode="train")
        return jnp.sum(values[jcost.name])

    jc, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                        for k, v in params.items()})
    assert abs(cp - float(jc)) <= TOL_FWD * max(1.0, abs(float(jc)))
    for name in gp:
        assert rel(gp[name], np.asarray(jg[name])) <= TOL_GRAD, name


def test_packed_layers_keep_their_segments():
    jcost, cost = both(lambda pkg: _tagger(pkg, "gru", True))
    topo = Topology(cost)
    params = {k: torch.from_numpy(v) for k, v in
              numpy_params(topo.param_specs(), seed=1).items()}
    feed = bucketing.pack_feed(topo, bucketing.pack_samples(
        PACK_SAMPLES, 16), max_len=16, device="cpu")
    values, _ = topo.apply(params, feed, mode="test",
                           outputs=["emb", "fwd", "bwd", "both", "scores"])
    for name in ("emb", "fwd", "bwd", "both", "scores"):
        assert isinstance(values[name], PackedSequenceBatch), name


def test_layers_that_mix_positions_refuse_packed_rows():
    """pooling, last_seq, context windows, recurrent groups and the CRF
    would bridge packed neighbours: each refuses, as in JAX."""
    def feed_of(topo):
        return bucketing.pack_feed(topo, bucketing.pack_samples(
            [([1, 2], [0, 1]), ([3], [1])], 8), max_len=8, device="cpu")

    L, dt = paddle.layer, paddle.data_type

    def word_emb():
        paddle.layer.reset_name_counters()
        word = L.data(name="word", type=dt.integer_value_sequence(20))
        label = L.data(name="label", type=dt.integer_value_sequence(4))
        return L.embedding(input=word, size=4, name="emb"), label

    builders = {
        "pooling": lambda e, lab: L.pooling(input=e),
        "last_seq": lambda e, lab: L.last_seq(input=e),
        "first_seq": lambda e, lab: L.first_seq(input=e),
        "context_projection": lambda e, lab: L.mixed(
            input=L.context_projection(input=e, context_len=3), size=12),
        "recurrent_group": lambda e, lab: L.recurrent_group(
            step=lambda x_t: L.fc(input=x_t, size=2), input=e),
        "crf": lambda e, lab: L.crf(input=L.fc(input=e, size=4), label=lab),
        "crf_decoding": lambda e, lab: L.crf_decoding(
            input=L.fc(input=e, size=4)),
        "seq_reshape": lambda e, lab: L.seq_reshape(input=e,
                                                    reshape_size=2),
    }
    for what, build in builders.items():
        emb, label = word_emb()
        out = build(emb, label)
        topo = Topology([out, label])
        params = topo.init_params(seed=0, device="cpu")
        with pytest.raises(EnforceError, match="packed"):
            topo.apply(params, feed_of(topo), mode="test")


def test_streaming_decode_refuses_packed_rows():
    _, cost = both(_tagger)
    topo = Topology(cost)
    params = topo.init_params(seed=0, device="cpu")
    feed = bucketing.pack_feed(topo, bucketing.pack_samples(
        PACK_SAMPLES[:3], 16), max_len=16, device="cpu")
    with pytest.raises(EnforceError, match="packed rows"):
        topo.apply_decode(params, feed, {}, outputs=["fwd"])
