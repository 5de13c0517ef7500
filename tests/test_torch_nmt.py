"""The attention NMT (``models.text.seq2seq_attention``) and beam-search
generation in both packages, on the CPU, with inputs made by numpy from a
seed (vocabulary 12, emb 8, enc/dec 12, as tests/test_seq2seq.py).

- Names, types, sizes and parameter shapes at the bench width (30000,
  512) equal to the JAX builder's; both packages hoist the vocabulary fc
  out of the decoder's loop; the generator reads only parameters the
  cost's Parameters hold.
- The cost and every parameter's gradient on ragged rows within 1e-5 of
  max(1, max |JAX|), both encoder directions through the GRU kernels'
  plain versions; the decoder's softmax marker reaches the cost.
- A 3-step Momentum trajectory against the JAX trainer within 1e-5.
- The padding test of tests/test_seq2seq.py; bfloat16 costs within 5e-2
  of float32.
- ``generate`` against JAX's on the same parameters: sequences and
  lengths equal, scores within 1e-5; ``BeamSearchControlCallbacks``
  (``candidate_adjust`` masking a token, ``on_step``'s calls) against
  JAX; both tests of tests/test_generation_golden.py on the port (the
  golden file read, not written); the port's counterpart of
  ``test_seq2seq_generation_shares_trained_params``; ``generate`` without
  a device raises on a machine without a card.
"""

import json
import os

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
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch import activation as A
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models import text
from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology

TOL = 1e-5
VOCAB, BOS, EOS = 12, 0, 1
SMALL = dict(src_dict_size=VOCAB, trg_dict_size=VOCAB, emb_size=8,
             enc_size=12, dec_size=12, name="nmt_t", bos_id=BOS,
             eos_id=EOS)
BENCH = dict(src_dict_size=30000, trg_dict_size=30000, emb_size=512,
             enc_size=512, dec_size=512)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "beam_lm.json")
FEEDS = ("source_words", "target_words", "target_next_words")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


def _models(**kw):
    """(JAX (cost, make_generator), port (cost, make_generator)), names
    counted from 0 in each package."""
    jax_reset_names()
    jmodel = jax_text.seq2seq_attention(**kw)
    reset_name_counters()
    return jmodel, text.seq2seq_attention(**kw)


def _np_params(topology, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s.shape) * scale).astype(np.float32)
            for k, s in sorted(topology.param_specs().items())}


def _rows(seed, n, max_len=9):
    """``n`` ragged (source, <s> + target, target + </s>) rows, lengths
    1 to ``max_len``."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        src = rng.randint(2, VOCAB, rng.randint(1, max_len + 1))
        trg = rng.randint(2, VOCAB, rng.randint(0, max_len))
        rows.append((src.tolist(), [BOS] + trg.tolist(),
                     trg.tolist() + [EOS]))
    return rows


def _feeds(rows):
    """(JAX feed, port feed) of the rows, each slot padded to its bucket."""
    jfeed, feed = {}, {}
    for i, name in enumerate(FEEDS):
        seqs = [np.asarray(r[i], np.int32) for r in rows]
        jfeed[name] = JaxSequenceBatch.from_sequences(seqs)
        feed[name] = SequenceBatch.from_sequences(seqs)
    return jfeed, feed


def _jax_params(jtopology, np_params):
    params = JaxParameters()
    params._specs = dict(jtopology.param_specs())
    params._values = {k: v.copy() for k, v in np_params.items()}
    return params


# -- the model ----------------------------------------------------------------

def test_names_and_shapes_match_the_jax_builder_at_bench_width():
    (jcost, jmake), (cost, make) = _models(**BENCH)
    jtopo, topo = JaxTopology(jcost), Topology(cost)
    assert [(n.name, n.layer_type, n.size) for n in topo.nodes] == [
        (n.name, n.layer_type, n.size) for n in jtopo.nodes]
    specs = topo.param_specs()
    assert {k: s.shape for k, s in specs.items()} == {
        k: tuple(s.shape) for k, s in jtopo.param_specs().items()}
    assert specs["nmt_out.w0"].shape == (512, 30000)
    assert specs["nmt_dec_h.w0"].shape == (512, 1536)
    assert specs["nmt_gru_in.w0"].shape == (1024, 1536)
    n_params = sum(int(np.prod(s.shape)) for s in specs.values())
    assert 53.3e6 < n_params < 53.5e6
    group = topo.by_name["nmt_decoder"]
    jgroup = jtopo.by_name["nmt_decoder"]
    assert [n.name for n in group._step_program.hoisted_order] == [
        n.name for n in jgroup._step_program.hoisted_order] == ["nmt_out"]
    assert group.output_activation == "softmax"
    jgen, gen = jmake(beam_size=4), make(beam_size=4)
    assert [s.name for s in gen.param_specs()] == [
        s.name for s in jgen.param_specs()]
    assert not [s.name for s in gen.param_specs() if s.name not in specs]
    assert [n.name for n in gen.context_nodes] == [
        "nmt_encoded", "nmt_enc_proj", "nmt_dec_boot"]


def test_cost_and_gradients_match_jax(monkeypatch):
    (jcost, _), (cost, _) = _models(**SMALL)
    jtopo, topo = JaxTopology(jcost), Topology(cost)
    np_params = _np_params(topo, seed=1)
    jfeed, feed = _feeds(_rows(seed=2, n=6))

    def jloss(p):
        c = jtopo.apply(p, jfeed, mode="train")[0][jcost.name]
        return jnp.mean(c), c

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    calls = []
    plain = gk.gru_seq_bwd_reference
    monkeypatch.setattr(gk, "gru_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in np_params.items()}
    got = topo.apply(leaves, feed, mode="train")[cost.name]
    got.mean().backward()
    assert calls == [1, 1]  # both encoder directions
    assert got.shape == (6,)
    assert _rel(got.detach(), want) <= TOL
    for name, want_g in jgrads.items():
        assert leaves[name].grad is not None, name
        assert _rel(leaves[name].grad, want_g) <= TOL, name
        assert float(leaves[name].grad.abs().max()) > 0.0, name


def _costs_of(trainer, batches, event_mod):
    costs = []
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event_mod.EndIteration) else None)
    return costs


def test_momentum_trajectory_matches_jax():
    (jcost, _), (cost, _) = _models(**SMALL)
    topo = Topology(cost)
    np_params = _np_params(topo, seed=3)
    batches = [_rows(seed=4 + i, n=5) for i in range(3)]
    jparams = _jax_params(JaxTopology(jcost), np_params)
    jcosts = _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=0.05, momentum=0.9)),
        batches, jpaddle.event)
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()}, topo.param_specs())
    costs = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.05, momentum=0.9),
        device="cpu"), batches, paddle.event)
    assert len(costs) == len(jcosts) == 3
    np.testing.assert_allclose(costs, jcosts, rtol=TOL)
    for name in sorted(np_params):
        assert _rel(params.get(name), jparams.get(name)) <= TOL, name
        assert not np.array_equal(params.get(name), np_params[name]), name


def test_attention_masks_padding():
    """tests/test_seq2seq.py's padding test on the port: one source padded
    to two lengths gives the same cost."""
    _, (cost, _) = _models(**SMALL)
    topo = Topology(cost)
    params = topo.init_params(seed=0, device="cpu")
    src = np.asarray([3, 4, 5], np.int32)
    trg_in = np.asarray([BOS, 3, 4, 5], np.int32)
    trg_out = np.asarray([3, 4, 5, EOS], np.int32)

    def run(max_len):
        feed = {"source_words": SequenceBatch.from_sequences(
                    [src], max_len=max_len),
                "target_words": SequenceBatch.from_sequences([trg_in]),
                "target_next_words": SequenceBatch.from_sequences([trg_out])}
        return topo.apply(params, feed)[cost.name].numpy()

    np.testing.assert_allclose(run(3), run(9), rtol=1e-5, atol=1e-6)


def test_bf16_policy_cost_tracks_f32():
    _, (cost, _) = _models(**SMALL)
    topo = Topology(cost)
    params = {k: torch.from_numpy(v) for k, v in
              _np_params(topo, seed=5).items()}
    _, feed = _feeds(_rows(seed=6, n=6))
    f32 = topo.apply(params, feed)[cost.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed)[cost.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert f32.dtype == torch.float32 and bool(torch.isfinite(bf16).all())
    assert _rel(bf16.float(), f32) <= 5e-2


# -- generation ---------------------------------------------------------------

def _generators(beam_size, max_length, control=None):
    (jcost, jmake), (cost, make) = _models(**SMALL)
    topo = Topology(cost)
    np_params = _np_params(topo, seed=7)
    jgen, gen = jmake(beam_size, max_length), make(beam_size, max_length)
    if control is not None:
        jgen.control, gen.control = control
    return (jgen, _jax_params(JaxTopology(jcost), np_params), gen,
            Parameters({k: torch.from_numpy(v) for k, v in
                        np_params.items()}, topo.param_specs()))


def _sources(seed, n=5):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(2, VOCAB, k).astype(np.int32)
            for k in rng.randint(1, 9, n)]
    return ({"source_words": JaxSequenceBatch.from_sequences(seqs)},
            {"source_words": SequenceBatch.from_sequences(seqs)})


@pytest.mark.parametrize("beam_size,max_length", [(3, 8), (4, 30)])
def test_generate_matches_jax(beam_size, max_length):
    jgen, jparams, gen, params = _generators(beam_size, max_length)
    jfeed, feed = _sources(seed=8)
    jseqs, jlens, jscores = jgen.generate(jparams, feed=jfeed)
    seqs, lens, scores = gen.generate(params, feed=feed, device="cpu")
    assert seqs.dtype == np.int32 and seqs.shape == (5, beam_size,
                                                     max_length)
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    np.testing.assert_array_equal(lens, np.asarray(jlens))
    assert _rel(scores, jscores) <= TOL
    assert (scores[:, :-1] >= scores[:, 1:]).all()


def test_control_callbacks_match_jax():
    """``candidate_adjust`` forbids token 5 everywhere; ``on_step`` sees
    every step, as in JAX."""
    seen = {"jax": [], "port": []}

    def controls(xp, key):
        def adjust(t, tokens, history, logp):
            if xp is jnp:
                return logp.at[:, 5].set(-jnp.inf)
            logp = logp.clone()
            logp[:, 5] = -float("inf")
            return logp

        def on_step(t, tokens, scores, finished):
            seen[key].append((t, np.asarray(tokens).tolist()))

        return adjust, on_step

    jcb = jpaddle.layer.BeamSearchControlCallbacks(*controls(jnp, "jax"))
    cb = L.BeamSearchControlCallbacks(*controls(torch, "port"))
    jgen, jparams, gen, params = _generators(3, 8, control=(jcb, cb))
    jfeed, feed = _sources(seed=9)
    jseqs, _, jscores = jgen.generate(jparams, feed=jfeed)
    seqs, _, scores = gen.generate(params, feed=feed, device="cpu")
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert _rel(scores, jscores) <= TOL
    assert not (seqs == 5).any()
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 2


def _golden_generator(vocab=9, beam=3, max_len=6):
    def step(prev_emb):
        mem = L.memory(name="glm_h", size=10)
        h = L.fc(input=[prev_emb, mem], size=10, act=A.Tanh(), name="glm_h")
        return L.fc(input=h, size=vocab, act=A.Softmax(), name="glm_out")

    reset_name_counters()
    return L.beam_search(
        step=step,
        input=[L.GeneratedInput(size=vocab, embedding_name="glm_emb",
                                embedding_size=5, bos_id=0, eos_id=1)],
        bos_id=0, eos_id=1, beam_size=beam, max_length=max_len)


def test_generation_matches_golden():
    """tests/test_generation_golden.py's golden decode, on the port, with
    the JAX package's initial parameters."""
    from tests.test_generation_golden import _generator, _params

    jgen = _generator()  # the JAX generator, for its seeded parameters
    jparams = _params(jgen)
    gen = _golden_generator()
    params = Parameters({k: torch.from_numpy(np.array(jparams.get(k)))
                         for k in jparams.names()},
                        {s.name: s for s in gen.param_specs()})
    seqs, lengths, scores = gen.generate(params, device="cpu")
    with open(GOLDEN) as f:
        want = json.load(f)
    assert seqs.tolist() == want["seqs"]
    assert lengths.tolist() == want["lengths"]
    np.testing.assert_allclose(scores, np.asarray(want["scores"]),
                               atol=2e-3)


def test_beam_search_matches_hand_computed_markov_chain():
    """tests/test_generation_golden.py's hand-built Markov chain (one-hot
    embeddings, the fc weight the log transition matrix): the beam of 3
    finds [2, 1], [2, 3, 1] and [3, 1], in that order."""
    reset_name_counters()
    vocab = 4
    P = np.array([[0.01, 0.01, 0.88, 0.10],
                  [0.25, 0.25, 0.25, 0.25],
                  [0.01, 0.70, 0.01, 0.28],
                  [0.02, 0.95, 0.02, 0.01]], np.float64)
    gen = L.beam_search(
        step=lambda prev_emb: L.fc(input=prev_emb, size=vocab,
                                   act=A.Softmax(), bias_attr=False,
                                   name="mk_out"),
        input=[L.GeneratedInput(size=vocab, embedding_name="mk_emb",
                                embedding_size=vocab, bos_id=0, eos_id=1)],
        bos_id=0, eos_id=1, beam_size=3, max_length=4)
    assert [s.name for s in gen.param_specs()] == ["mk_out.w0"]
    params = Parameters({
        "mk_emb": torch.eye(vocab),
        "mk_out.w0": torch.from_numpy(np.log(P).astype(np.float32))})
    seqs, lengths, scores = gen.generate(params, device="cpu")
    assert lengths[0].tolist() == [2, 3, 2]
    assert seqs[0, 0, :2].tolist() == [2, 1]
    assert seqs[0, 1, :3].tolist() == [2, 3, 1]
    assert seqs[0, 2, :2].tolist() == [3, 1]
    np.testing.assert_allclose(
        scores[0], np.log([0.88 * 0.70, 0.88 * 0.28 * 0.95, 0.10 * 0.95]),
        rtol=1e-4)


def test_generation_shares_trained_params():
    """tests/test_seq2seq.py's test on the port (Momentum in place of
    Adam, which is not ported yet)."""
    _, (cost, make_generator) = _models(**SMALL)
    params = Parameters.create(cost, seed=0, device="cpu")
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
        learning_rate=0.05, momentum=0.9), device="cpu")
    trainer.train(paddle.batch(lambda: iter(_rows(seed=10, n=24)), 12),
                  num_passes=2)
    gen = make_generator(beam_size=3, max_length=8)
    missing = [s.name for s in gen.param_specs() if s.name not in params]
    assert missing == []
    seqs, lengths, scores = gen.generate(params, feed={
        "source_words": SequenceBatch.from_sequences(
            [np.asarray([3, 4, 5], np.int32)])}, device="cpu")
    assert seqs.shape[:2] == (1, 3)
    assert (scores[:, :-1] >= scores[:, 1:]).all()
    assert lengths.min() >= 1 and seqs.dtype == np.int32


def test_generate_without_a_device_needs_a_card(monkeypatch):
    _, (cost, make_generator) = _models(**SMALL)
    params = Parameters.create(cost, seed=0, device="cpu")
    gen = make_generator(beam_size=2, max_length=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feed = {"source_words": SequenceBatch.from_sequences(
        [np.asarray([3, 4], np.int32)])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.generate(params, feed=feed)
    seqs, _, _ = gen.generate(params, feed=feed, device="cpu")
    assert seqs.shape == (1, 2, 3)
