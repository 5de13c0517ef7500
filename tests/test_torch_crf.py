"""The BiLSTM-CRF tagger (``models.text.sequence_tagging_rnn`` +
``layer.crf``) and what it brings (reverse recurrences,
``SequenceBatch.reverse``, ``ops.crf``, ``layer.crf`` /
``crf_decoding``) in both packages, on the CPU, with inputs made by numpy
from a seed.

- ``SequenceBatch.reverse`` against the JAX package's, lengths 0, 1, T
  and in between.
- ``lstm_scan`` / ``gru_scan(reverse=True)`` (through the kernels' plain
  versions) against the JAX scans on ragged batches: outputs, final
  states and gradients within 1e-5; the padding stays at the end of
  every row.
- ``crf_nll`` and its gradients, ``crf_decode`` (paths equal, scores
  within 1e-5) against paddle_tpu/ops/crf.py on ragged batches, labels
  outside [0, L) in the padding; the bfloat16 dtype rule.
- ``crf`` with ``weight``, ``crf_decoding`` with and without ``label``
  against the JAX layers.
- The tagger's names and shapes at the bench configuration (word dict
  30000, 67 labels, emb 64, hidden 128); a 5-step Momentum trajectory of
  a small tagger + crf (emb 8, hidden 16, 5 labels, ragged) against the
  JAX trainer within 1e-5, with both LSTM directions through the
  backward's plain version each step; the trained parameters served from
  a bundle, which carries only the names the served topology declares.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models import text as jax_text
from paddle_tpu.ops import crf as jax_crf
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.models import text
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import lstm_kernels as lk
from paddle_tpu_torch.ops import rnn as torch_rnn
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import load_bundle
from paddle_tpu_torch.serve.export import export_bundle, parse_builder
from paddle_tpu_torch.topology import Topology

TOL = 1e-5
B, T, H = 5, 9, 16
LENGTHS = np.array([T, 1, 4, 0, 7], np.int32)
BENCH = dict(word_dict_size=30000, label_dict_size=67, emb_size=64,
             hidden=128)
SMALL = dict(word_dict_size=40, label_dict_size=5, emb_size=8, hidden=16)
BUILDER = "paddle_tpu_torch.models.text:sequence_tagging_rnn"


def _mask(lengths=LENGTHS, steps=T):
    return (np.arange(steps)[None, :] < lengths[:, None]).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


# -- SequenceBatch.reverse ----------------------------------------------------

@pytest.mark.parametrize("trailing", [(), (3,)])
def test_sequence_reverse_matches_jax(trailing):
    rng = np.random.RandomState(1)
    data = rng.randn(B, T, *trailing).astype(np.float32)
    want = JaxSequenceBatch(jnp.asarray(data), jnp.asarray(LENGTHS)).reverse()
    got = SequenceBatch(torch.from_numpy(data),
                        torch.from_numpy(LENGTHS)).reverse()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.lengths.numpy(), LENGTHS)
    # row 2 (length 4): its four steps reversed, the padding in place
    np.testing.assert_array_equal(got.data[2, :4].numpy(), data[2, 3::-1])
    np.testing.assert_array_equal(got.data[2, 4:].numpy(), data[2, 4:])
    # twice is the identity
    np.testing.assert_array_equal(got.reverse().data.numpy(), data)


# -- reverse scans ------------------------------------------------------------

def _lstm_inputs(seed):
    rng = np.random.RandomState(seed)
    return {"gates": (rng.randn(B, T, 4 * H) * 0.5).astype(np.float32),
            "w": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
            "peep": (rng.randn(3 * H) * 0.3).astype(np.float32),
            "h0": (rng.randn(B, H) * 0.5).astype(np.float32),
            "c0": (rng.randn(B, H) * 0.5).astype(np.float32),
            "r_seq": rng.randn(B, T, H).astype(np.float32),
            "r_h": rng.randn(B, H).astype(np.float32),
            "r_c": rng.randn(B, H).astype(np.float32)}


_LSTM_WRT = ("gates", "w", "peep", "h0", "c0")


def _loss(h_seq, finals, x, xp):
    out = (h_seq * xp.asarray(x["r_seq"])).sum()
    for f, key in zip(finals, ("r_h", "r_c")):
        out = out + (f * xp.asarray(x[key])).sum()
    return out


def test_reverse_lstm_scan_matches_jax(monkeypatch):
    x = _lstm_inputs(seed=2)
    mask = _mask()

    def jrun(gates, w, peep, h0, c0):
        h_seq, finals = jax_rnn.lstm_scan(
            gates, jnp.asarray(mask), None, None, w, h0=h0, c0=c0,
            reverse=True, use_peephole=True, w_peep=peep)
        return _loss(h_seq, finals, x, jnp), (h_seq, finals)

    args = [jnp.asarray(x[k]) for k in _LSTM_WRT]
    (_, (want_seq, want_f)), want_g = jax.value_and_grad(
        jrun, argnums=tuple(range(5)), has_aux=True)(*args)

    calls = []
    plain = lk.lstm_seq_bwd_reference
    monkeypatch.setattr(lk, "lstm_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in _LSTM_WRT}
    h_seq, finals = torch_rnn.lstm_scan(
        leaves["gates"], torch.from_numpy(mask), None, None, leaves["w"],
        h0=leaves["h0"], c0=leaves["c0"], reverse=True, use_peephole=True,
        w_peep=leaves["peep"])
    _loss(h_seq, finals, x, torch).backward()
    assert calls == [1]  # one backward through the kernel's plain version
    assert _rel(h_seq.detach(), want_seq) <= TOL
    for got, want in zip(finals, want_f):
        assert _rel(got.detach(), want) <= TOL
    for name, want in zip(_LSTM_WRT, want_g):
        assert _rel(leaves[name].grad, want) <= TOL, name
    # the padding stays zero, and so does a row of length 0
    assert float(h_seq.detach()[2, 4:].abs().max()) == 0.0
    assert float(h_seq.detach()[3].abs().max()) == 0.0


def test_reverse_gru_scan_matches_jax():
    rng = np.random.RandomState(3)
    x = {"proj": (rng.randn(B, T, 3 * H) * 0.5).astype(np.float32),
         "w_rz": (rng.randn(H, 2 * H) / np.sqrt(H)).astype(np.float32),
         "w_c": (rng.randn(H, H) / np.sqrt(H)).astype(np.float32),
         "h0": (rng.randn(B, H) * 0.5).astype(np.float32),
         "r_seq": rng.randn(B, T, H).astype(np.float32),
         "r_h": rng.randn(B, H).astype(np.float32)}
    wrt = ("proj", "w_rz", "w_c", "h0")
    mask = _mask()

    def jrun(proj, w_rz, w_c, h0):
        h_seq, h_f = jax_rnn.gru_scan(proj, jnp.asarray(mask), None, None,
                                      w_rz, w_c, h0=h0, reverse=True)
        return _loss(h_seq, (h_f,), x, jnp), (h_seq, h_f)

    (_, (want_seq, want_f)), want_g = jax.value_and_grad(
        jrun, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(x[k]) for k in wrt))
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in wrt}
    h_seq, h_f = torch_rnn.gru_scan(
        leaves["proj"], torch.from_numpy(mask), None, None, leaves["w_rz"],
        leaves["w_c"], h0=leaves["h0"], reverse=True)
    _loss(h_seq, (h_f,), x, torch).backward()
    assert _rel(h_seq.detach(), want_seq) <= TOL
    assert _rel(h_f.detach(), want_f) <= TOL
    for name, want in zip(wrt, want_g):
        assert _rel(leaves[name].grad, want) <= TOL, name


def test_reverse_grumemory_layer_matches_jax():
    outs = []
    for pkg, reset in ((jpaddle, jax_reset_names),
                       (paddle, reset_name_counters)):
        reset()
        w = pkg.layer.data(name="w",
                           type=pkg.data_type.integer_value_sequence(20))
        emb = pkg.layer.embedding(input=w, size=6, name="e")
        outs.append(pkg.networks.simple_gru(input=emb, size=8, name="g",
                                            reverse=True))
    jout, out = outs
    topo = Topology(out)
    rng = np.random.RandomState(4)
    np_params = {k: (rng.randn(*s.shape) * 0.5).astype(np.float32)
                 for k, s in sorted(topo.param_specs().items())}
    ids = rng.randint(0, 20, (B, T)).astype(np.int32)
    want = JaxTopology(jout).apply(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        {"w": JaxSequenceBatch(jnp.asarray(ids), jnp.asarray(LENGTHS))})[0][
            jout.name]
    got = topo.apply({k: torch.from_numpy(v) for k, v in np_params.items()},
                     {"w": SequenceBatch(torch.from_numpy(ids),
                                         torch.from_numpy(LENGTHS))},
                     mode="test")[0][out.name]
    assert _rel(got.data, want.data) <= TOL


# -- ops.crf ------------------------------------------------------------------

def _crf_inputs(seed, labels=6):
    rng = np.random.RandomState(seed)
    lengths = np.array([T, 1, 4, 7, 2], np.int32)
    tags = rng.randint(0, labels, (B, T)).astype(np.int32)
    tags[~_mask(lengths).astype(bool)] = 99  # padding: clipped, not indexed
    return {"emissions": rng.randn(B, T, labels).astype(np.float32),
            "labels": tags, "mask": _mask(lengths),
            "w": (rng.randn(labels + 2, labels) * 0.5).astype(np.float32),
            "lengths": lengths}


def test_crf_nll_and_gradients_match_jax():
    x = _crf_inputs(seed=5)
    r = np.random.RandomState(6).randn(B).astype(np.float32)

    def jrun(em, w):
        nll = jax_crf.crf_nll(em, jnp.asarray(x["labels"]),
                              jnp.asarray(x["mask"]), w)
        return jnp.sum(nll * r), nll

    (_, want), (want_dem, want_dw) = jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True)(jnp.asarray(x["emissions"]),
                                            jnp.asarray(x["w"]))
    em = torch.from_numpy(x["emissions"]).requires_grad_()
    w = torch.from_numpy(x["w"]).requires_grad_()
    got = crf_ops.crf_nll(em, torch.from_numpy(x["labels"]),
                          torch.from_numpy(x["mask"]), w)
    (got * torch.from_numpy(r)).sum().backward()
    assert got.shape == (B,)
    assert _rel(got.detach(), want) <= TOL
    assert _rel(em.grad, want_dem) <= TOL
    assert _rel(w.grad, want_dw) <= TOL
    # padded emissions get no gradient
    assert float(em.grad[1, 1:].abs().max()) == 0.0


def test_crf_decode_matches_jax():
    x = _crf_inputs(seed=7)
    want_paths, want_scores = jax_crf.crf_decode(
        jnp.asarray(x["emissions"]), jnp.asarray(x["mask"]),
        jnp.asarray(x["w"]))
    paths, scores = crf_ops.crf_decode(torch.from_numpy(x["emissions"]),
                                       torch.from_numpy(x["mask"]),
                                       torch.from_numpy(x["w"]))
    assert paths.dtype == torch.int32
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))
    assert _rel(scores, want_scores) <= TOL
    # the best path's score is its unnormalised log-likelihood: -nll + logZ
    nll = crf_ops.crf_nll(torch.from_numpy(x["emissions"]), paths,
                          torch.from_numpy(x["mask"]),
                          torch.from_numpy(x["w"]))
    worse = crf_ops.crf_nll(torch.from_numpy(x["emissions"]),
                            (paths + 1) % 6, torch.from_numpy(x["mask"]),
                            torch.from_numpy(x["w"]))
    assert bool((nll <= worse + 1e-6).all())


def test_crf_keeps_the_emissions_dtype_in_bfloat16():
    x = _crf_inputs(seed=8)
    args = [x["emissions"], x["labels"], x["mask"], x["w"]]
    want = jax_crf.crf_nll(*(jnp.asarray(a, jnp.bfloat16) if a.dtype ==
                             np.float32 and i != 2 else jnp.asarray(a)
                             for i, a in enumerate(args)))
    got = crf_ops.crf_nll(*(torch.from_numpy(a).bfloat16() if a.dtype ==
                            np.float32 and i != 2 else torch.from_numpy(a)
                            for i, a in enumerate(args)))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    f32 = crf_ops.crf_nll(*(torch.from_numpy(a) for a in args))
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 3e-2
    assert _rel(got.float(), f32) <= 3e-2


def test_crf_bfloat16_gradient_tracks_jax_over_a_long_sequence():
    """Over 60 steps and 67 labels (the bench tagger's) the partition
    function reaches a few hundred, where bfloat16 rounds by up to 1: the
    gradient must come from exp(x - max) / sum, as JAX's logsumexp gives
    it, or the rounding compounds step by step (torch.logsumexp's
    gradient, exp(x - rounded result), diverged the tagger's bfloat16
    training). The bfloat16 gradient departs from float32 by no more than
    1.5 times the JAX package's own bfloat16 departure (17 % of the
    largest entry for the emissions, 7 % for the weights, here)."""
    rng = np.random.RandomState(21)
    b, steps, labels = 4, 60, 67
    em = rng.randn(b, steps, labels).astype(np.float32)
    tags = rng.randint(0, labels, (b, steps)).astype(np.int32)
    mask = _mask(np.array([60, 59, 31, 1], np.int32), steps)
    w = (rng.randn(labels + 2, labels) * 0.5).astype(np.float32)

    def jgrads(dtype):
        return [np.asarray(g, np.float32) for g in jax.grad(
            lambda e, ww: jnp.sum(jax_crf.crf_nll(
                e, jnp.asarray(tags), jnp.asarray(mask), ww).astype(
                    jnp.float32)), argnums=(0, 1))(
                jnp.asarray(em, dtype), jnp.asarray(w, dtype))]

    def grads(dtype):
        e = torch.from_numpy(em).to(dtype).requires_grad_()
        ww = torch.from_numpy(w).to(dtype).requires_grad_()
        crf_ops.crf_nll(e, torch.from_numpy(tags), torch.from_numpy(mask),
                        ww).float().sum().backward()
        return [e.grad.float().numpy(), ww.grad.float().numpy()]

    for got, want, jgot, jwant in zip(grads(torch.bfloat16),
                                      grads(torch.float32),
                                      jgrads(jnp.bfloat16),
                                      jgrads(jnp.float32)):
        jax_err = _rel(jgot, jwant)
        assert _rel(got, want) <= 1.5 * jax_err + 1e-3


# -- layer.crf / crf_decoding -------------------------------------------------

def _crf_nets(pkg, reset):
    reset()
    L, dt = pkg.layer, pkg.data_type
    scores = L.data(name="scores", type=dt.dense_vector_sequence(6))
    label = L.data(name="label", type=dt.integer_value_sequence(6))
    weight = L.data(name="weight", type=dt.dense_vector(1))
    shared = pkg.attr.ParamAttr(name="crfw")
    return (L.crf(input=scores, label=label, weight=weight,
                  param_attr=shared),
            L.crf_decoding(input=scores, param_attr=shared),
            L.crf_decoding(input=scores, label=label, param_attr=shared))


def test_crf_layers_match_jax():
    jnets = _crf_nets(jpaddle, jax_reset_names)
    nets = _crf_nets(paddle, reset_name_counters)
    assert [n.name for n in nets] == [n.name for n in jnets] == [
        "__crf_layer_0__", "__crf_decoding_layer_0__",
        "__crf_decoding_layer_1__"]
    assert [n.size for n in nets] == [n.size for n in jnets] == [6, 6, 1]
    x = _crf_inputs(seed=9)
    weight = np.random.RandomState(10).rand(B, 1).astype(np.float32)
    # the first two rows decode to the label, the rest get random labels
    paths, _ = crf_ops.crf_decode(torch.from_numpy(x["emissions"]),
                                  torch.from_numpy(x["mask"]),
                                  torch.from_numpy(x["w"]))
    tags = x["labels"].copy()
    tags[:2] = paths.numpy()[:2]
    jfeed = {"scores": JaxSequenceBatch(jnp.asarray(x["emissions"]),
                                        jnp.asarray(x["lengths"])),
             "label": JaxSequenceBatch(jnp.asarray(tags),
                                       jnp.asarray(x["lengths"])),
             "weight": jnp.asarray(weight)}
    feed = {"scores": SequenceBatch(torch.from_numpy(x["emissions"]),
                                    torch.from_numpy(x["lengths"])),
            "label": SequenceBatch(torch.from_numpy(tags),
                                   torch.from_numpy(x["lengths"])),
            "weight": torch.from_numpy(weight)}
    want = JaxTopology(list(jnets)).apply({"crfw": jnp.asarray(x["w"])},
                                          jfeed)[0]
    topo = Topology(list(nets))
    assert topo.param_specs()["crfw"].shape == (8, 6)
    got, _ = topo.apply({"crfw": torch.from_numpy(x["w"])}, feed, mode="test")
    cost, path, errors = (got[n.name] for n in nets)
    jcost, jpath, jerrors = (want[n.name] for n in jnets)
    assert _rel(cost, jcost) <= TOL
    np.testing.assert_array_equal(path.data.numpy(), np.asarray(jpath.data))
    np.testing.assert_array_equal(path.lengths.numpy(), x["lengths"])
    np.testing.assert_array_equal(errors.numpy(), np.asarray(jerrors))
    assert errors.numpy()[:2].tolist() == [0.0, 0.0]
    assert errors.dtype == torch.float32


# -- the BiLSTM-CRF tagger ----------------------------------------------------

def _tagger(pkg, model, reset, **kw):
    reset()
    scores = model.sequence_tagging_rnn(**kw)
    label = pkg.layer.data(name="label",
                           type=pkg.data_type.integer_value_sequence(
                               kw["label_dict_size"]))
    return scores, pkg.layer.crf(input=scores, label=label, name="tag_crf")


def test_tagger_names_and_shapes_match_the_jax_builder():
    _, jcost = _tagger(jpaddle, jax_text, jax_reset_names, **BENCH)
    _, cost = _tagger(paddle, text, reset_name_counters, **BENCH)
    jtopo, topo = JaxTopology(jcost), Topology(cost)
    assert [(n.name, n.layer_type, n.size) for n in topo.nodes] == [
        (n.name, n.layer_type, n.size) for n in jtopo.nodes]
    jspecs, specs = jtopo.param_specs(), topo.param_specs()
    assert {k: s.shape for k, s in specs.items()} == {
        k: tuple(s.shape) for k, s in jspecs.items()}
    assert specs["tag_crf.w0"].shape == (69, 67)
    assert specs["tag_bwd.w0"].shape == (128, 512)
    assert topo.by_name["tag_concat"].size == 256


def _numpy_params(specs, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
            for k, s in sorted(specs.items())}


def _batches(n=5, rows=6, seed=11):
    """Ragged (word ids, tags) minibatches: lengths 1 to 12, with 1 and 12
    in every batch."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(1, 13, rows)
        lens[:2] = (12, 1)
        out.append([(rng.randint(0, SMALL["word_dict_size"], k).tolist(),
                     rng.randint(0, SMALL["label_dict_size"], k).tolist())
                    for k in lens])
    return out


def _costs_of(trainer, batches, event_mod):
    costs = []
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event_mod.EndIteration) else None)
    return costs


def test_bilstm_crf_trajectory_matches_jax(monkeypatch):
    _, jcost = _tagger(jpaddle, jax_text, jax_reset_names, **SMALL)
    _, cost = _tagger(paddle, text, reset_name_counters, **SMALL)
    topo = Topology(cost)
    np_params = _numpy_params(topo.param_specs(), seed=12)
    batches = _batches()

    jparams = JaxParameters()
    jparams._specs = dict(JaxTopology(jcost).param_specs())
    jparams._values = {k: v.copy() for k, v in np_params.items()}
    jcosts = _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=0.05, momentum=0.9)),
        batches, jpaddle.event)

    calls = []
    plain = lk.lstm_seq_bwd_reference
    monkeypatch.setattr(lk, "lstm_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()}, topo.param_specs())
    costs = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.05, momentum=0.9),
        device="cpu"), batches, paddle.event)

    assert len(costs) == len(jcosts) == 5
    assert len(calls) == 10  # both directions' backward, every step
    np.testing.assert_allclose(costs, jcosts, rtol=TOL)
    assert costs[-1] < costs[0]
    for name in sorted(np_params):
        assert _rel(params.get(name), jparams.get(name)) <= TOL, name
        assert not np.array_equal(params.get(name), np_params[name]), name


def test_bf16_policy_tagger_cost_tracks_f32():
    scores, cost = _tagger(paddle, text, reset_name_counters, **SMALL)
    topo = Topology(cost)
    params = {k: torch.from_numpy(v) for k, v in
              _numpy_params(topo.param_specs(), seed=13).items()}
    rng = np.random.RandomState(14)
    lens = np.array([12, 1, 7], np.int32)
    ids = rng.randint(0, 40, (3, 12)).astype(np.int32)
    tags = rng.randint(0, 5, (3, 12)).astype(np.int32)
    feed = {"word": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens)),
            "label": SequenceBatch(torch.from_numpy(tags),
                                   torch.from_numpy(lens))}
    f32 = topo.apply(params, feed, mode="test")[0][cost.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed, mode="test")[0][cost.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert bf16.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert _rel(bf16.float(), f32) <= 3e-2


def test_trained_tagger_serves_from_a_bundle(tmp_path):
    scores, cost = _tagger(paddle, text, reset_name_counters, **SMALL)
    topo = Topology(cost)
    params = Parameters({k: torch.from_numpy(v) for k, v in _numpy_params(
        topo.param_specs(), seed=15).items()}, topo.param_specs())
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.05, momentum=0.9),
        device="cpu")
    trainer.train(lambda: iter(_batches(n=2, seed=16)), num_passes=1)
    out_dir = str(tmp_path / "tagger")
    trainer.export_inference_bundle(parse_builder(BUILDER, SMALL), out_dir,
                                    batch_sizes=(4,), seq_len=12)
    bundle = load_bundle(out_dir, device="cpu")
    assert bundle.outputs[0]["name"] == "tag_scores"
    rng = np.random.RandomState(17)
    lens = np.array([12, 3, 1], np.int32)
    ids = rng.randint(0, 40, (3, 12)).astype(np.int32)
    got = bundle.infer({"word": ids, "word:lens": lens})["tag_scores"]
    want = infer(scores, params, [(list(r[:n]),) for r, n in zip(ids, lens)],
                 device="cpu")
    assert got.shape == (3, 12, SMALL["label_dict_size"])
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0,
                                   atol=1e-5)


def test_export_keeps_the_served_names_of_a_trained_superset(tmp_path):
    """``export_bundle(trained=True)`` takes a trainer's parameters (the
    served scores' and the CRF's transitions) and writes only the names
    the served topology declares; without it the extra name is refused,
    and a declared name the superset lacks is refused either way."""
    _, cost = _tagger(paddle, text, reset_name_counters, **SMALL)
    topo = Topology(cost)
    values = {k: torch.from_numpy(v) for k, v in _numpy_params(
        topo.param_specs(), seed=18).items()}
    params = Parameters(values, topo.param_specs())
    builder = parse_builder(BUILDER, SMALL)
    with pytest.raises(Exception, match="tag_crf.w0"):
        export_bundle(builder, params, str(tmp_path / "strict"),
                      batch_sizes=(4,), seq_len=12)
    out_dir = str(tmp_path / "served")
    export_bundle(builder, params, out_dir, batch_sizes=(4,), seq_len=12,
                  trained=True)
    bundle = load_bundle(out_dir, device="cpu")
    assert sorted(bundle.params) == sorted(
        n for n in values if n != "tag_crf.w0")
    short = {k: v for k, v in values.items() if k != "tag_fwd.w0"}
    with pytest.raises(Exception, match="tag_fwd.w0"):
        export_bundle(builder, Parameters(short, topo.param_specs()),
                      str(tmp_path / "short"), batch_sizes=(4,),
                      seq_len=12, trained=True)
