"""The GRU sequence tagger (``models.text.sequence_tagging_gru``) in both
packages, on the CPU: forward, names, training, serving and the CLI.

- Forward: the same numpy parameters carried into the port by
  ``params_from_numpy`` and the same ragged feed give per-timestep label
  probabilities within 1e-5 (float32; the sums run in another order,
  these inputs show at most 6e-8).
- Names: layers, parameters (names and shapes) and the auto names
  ``__gru_0__`` / ``__simple_gru_0__`` agree with the JAX builder; both
  argument spellings of ``simple_gru``.
- Training: the tagger plus an ``integer_value_sequence`` label and
  ``classification_cost``, 5 steps of both packages' ``trainer.SGD`` with
  ``Momentum(learning_rate=0.1, momentum=0.9)`` from the same numpy
  parameters on the same ragged minibatches. The JAX side runs its
  lax.scan branch, the port its kernel branch (the plain versions of both
  GRU kernels on the CPU). Costs within 1e-6 and every parameter within
  1e-5 after step 5 (relative and absolute): the sums run in another
  order and the differences compound over 5 momentum steps at lr 0.1.
  These inputs show 1.5e-7 relative on the costs (sums of up to 12
  per-timestep costs, about 10) and 1.5e-7 on parameters that move by up
  to 0.5.
- Serving: export, ``load_bundle(device="cpu")``, the batching engine and
  one ``POST /infer`` against the port's ``inference.infer``, a JAX
  bundle's params.npz served by the port against the JAX bundle, and
  ``cli export`` / ``serve --selfcheck`` with the tagger builder.
Every engine and server is stopped inside its test.
"""

import json
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import sequence_tagging_gru as jax_model
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.models.text import sequence_tagging_gru
from paddle_tpu_torch.ops import gru_kernels as gk
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import (InferenceEngine, export_bundle,
                                    load_bundle, serve_in_thread)
from paddle_tpu_torch.serve.export import parse_builder
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.error import EnforceError

BUILDER = "paddle_tpu_torch.models.text:sequence_tagging_gru"
SMALL = dict(dict_size=50, label_size=5, emb_size=8, hidden=16)
SEQ_LEN = 12
TOL_COST, TOL_PARAM = 1e-6, 1e-5


def _both():
    jax_reset_names()
    jout = jax_model(**SMALL)
    reset_name_counters()
    out = sequence_tagging_gru(**SMALL)
    return (JaxTopology(jout), jout), (Topology(out), out)


def _numpy_params(specs, seed=0):
    """Every parameter from a numpy seed, biases included (nonzero, so the
    3H GRU bias is exercised)."""
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(specs.items())}


def _feed(seed=0, rows=5, t=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 60, (rows, t)).astype(np.int32)
    lens = np.array([t, 0, 1, 4, 7][:rows], np.int32)
    return ids, lens


def test_tagger_forward_matches_jax():
    (jtopo, jout), (topo, out) = _both()
    np_params = _numpy_params(topo.param_specs())
    ids, lens = _feed()
    want = jtopo.apply({k: jnp.asarray(v) for k, v in np_params.items()},
                       {"word": JaxSequenceBatch(jnp.asarray(ids),
                                                 jnp.asarray(lens))},
                       mode="test")[0][jout.name]
    params = params_from_numpy(np_params, topo, device="cpu")
    got = topo.apply(params, {"word": SequenceBatch(
        torch.from_numpy(ids), torch.from_numpy(lens))},
        mode="test")[0][out.name]
    assert isinstance(got, SequenceBatch)
    assert got.data.shape == (5, 9, SMALL["label_size"])
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=1e-5, atol=1e-5)


def test_tagger_names_and_shapes_match_the_jax_builder():
    (jtopo, jout), (topo, out) = _both()
    assert [n.name for n in topo.nodes] == [n.name for n in jtopo.nodes]
    assert out.name == jout.name == "gru_tag_out"
    jax_reset_names()
    jspecs = JaxParameters.create(jout)
    specs = topo.param_specs()
    assert sorted(specs) == sorted(jspecs.names())
    for name in specs:
        assert specs[name].shape == tuple(jspecs.get(name).shape), name
    assert specs["gru_tag_gru.w0"].shape == (16, 48)
    assert specs["gru_tag_gru.wbias"].shape == (48,)
    # the transform has no bias unless mixed_bias_param_attr is given
    assert "gru_tag_gru_transform.wbias" not in specs


def _unnamed(pkg, attr_mod):
    """An unnamed grumemory and simple_gru, and two named simple_grus that
    spell the same parameters both ways (mat_*/inner_*/bias_* and the v1
    DSL's mixed_*/gru_*)."""
    words = pkg.layer.data(name="w",
                           type=pkg.data_type.integer_value_sequence(9))
    emb = pkg.layer.embedding(input=words, size=6, name="e")
    proj = pkg.layer.fc(input=emb, size=3 * 4, bias_attr=False, name="p")
    gru = pkg.layer.grumemory(input=proj)
    net = pkg.networks.simple_gru(input=emb, size=4,
                                  mixed_bias_param_attr=True,
                                  gru_bias_attr=False)
    spelled = [
        pkg.networks.simple_gru(
            input=emb, size=4, name="a",
            mat_param_attr=attr_mod.ParamAttr(name="mat"),
            inner_param_attr=attr_mod.ParamAttr(name="inner"),
            bias_param_attr=attr_mod.ParamAttr(name="bias")),
        pkg.networks.simple_gru(
            input=emb, size=4, name="b",
            mixed_param_attr=attr_mod.ParamAttr(name="mat"),
            gru_param_attr=attr_mod.ParamAttr(name="inner"),
            gru_bias_attr=attr_mod.ParamAttr(name="bias"))]
    return [gru, net] + spelled


def _shapes(topology):
    return {s.name: s.shape for s in topology.param_specs().values()}


def test_auto_names_and_both_spellings_match_jax():
    from paddle_tpu import attr as jattr
    from paddle_tpu_torch import attr

    jax_reset_names()
    jnodes = _unnamed(jpaddle, jattr)
    reset_name_counters()
    nodes = _unnamed(paddle, attr)
    assert [n.name for n in nodes] == [n.name for n in jnodes] == [
        "__gru_0__", "__simple_gru_0__", "a", "b"]
    specs = _shapes(Topology(nodes))
    assert specs == _shapes(JaxTopology(jnodes))
    # mixed_bias_param_attr gives the transform a bias; gru_bias_attr=False
    # takes the GRU's away
    assert "__simple_gru_0___transform.wbias" in specs
    assert "__simple_gru_0__.wbias" not in specs
    assert specs["__gru_0__.w0"] == (4, 12)
    # both spellings name the same three parameters (beside the embedding)
    assert _shapes(Topology(nodes[2])) == _shapes(Topology(nodes[3])) == {
        "e.w0": (9, 6), "mat": (6, 12), "inner": (4, 12), "bias": (12,)}


def _tagger_cost(pkg, model):
    out = model(**SMALL)
    label = pkg.layer.data(
        name="label",
        type=pkg.data_type.integer_value_sequence(SMALL["label_size"]))
    return out, pkg.layer.classification_cost(input=out, label=label)


def _batches(seed=0, n=5, rows=4):
    """Ragged minibatches of (ids, labels); lengths include 0, 1 and 12."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lens = rng.randint(1, 13, rows)
        lens[:2] = (0, 12) if i % 2 == 0 else (1, 7)
        out.append([(rng.randint(0, 50, int(k)).tolist(),
                     rng.randint(0, SMALL["label_size"], int(k)).tolist())
                    for k in lens])
    return out


def _costs_of(trainer, batches, event_mod):
    costs = []
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event_mod.EndIteration) else None)
    return costs


def test_tagger_training_trajectory_matches_jax(monkeypatch):
    jax_reset_names()
    _, jcost = _tagger_cost(jpaddle, jax_model)
    reset_name_counters()
    _, cost = _tagger_cost(paddle, sequence_tagging_gru)
    topo = Topology(cost)
    np_params = _numpy_params(topo.param_specs(), seed=1)
    batches = _batches()

    jparams = JaxParameters.create(jcost)
    for name, value in np_params.items():
        jparams.set(name, value)
    jcosts = _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=0.1, momentum=0.9)),
        batches, jpaddle.event)

    calls = []
    plain = gk.gru_seq_bwd_reference
    monkeypatch.setattr(gk, "gru_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()}, topo.param_specs())
    costs = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.1, momentum=0.9),
        device="cpu"), batches, paddle.event)

    assert len(costs) == len(jcosts) == 5
    assert len(calls) == 5  # the GRU backward ran once a step
    np.testing.assert_allclose(costs, jcosts, rtol=TOL_COST, atol=TOL_COST)
    assert costs[-1] != costs[0]
    for name in sorted(np_params):
        np.testing.assert_allclose(params.get(name), jparams.get(name),
                                   rtol=TOL_PARAM, atol=TOL_PARAM,
                                   err_msg=name)
        assert not np.array_equal(params.get(name), np_params[name]), name


@pytest.fixture(scope="module")
def tagger_bundle(tmp_path_factory):
    """(bundle dir, output layer, Parameters) of the small tagger."""
    reset_name_counters()
    out = sequence_tagging_gru(**SMALL)
    topo = Topology(out)
    params = Parameters({k: torch.from_numpy(v) for k, v in
                         _numpy_params(topo.param_specs(), seed=2).items()},
                        topo.param_specs())
    out_dir = str(tmp_path_factory.mktemp("tagger"))
    export_bundle(parse_builder(BUILDER, SMALL), params, out_dir,
                  batch_sizes=(1, 4), seq_len=SEQ_LEN)
    return out_dir, out, params


def _request(rng, rows):
    lens = rng.randint(0, SEQ_LEN + 1, rows).astype(np.int32)
    lens[0] = SEQ_LEN
    return {"word": rng.randint(0, 60, (rows, SEQ_LEN)).astype(np.int32),
            "word:lens": lens}


def _check_rows(got, req, out, params):
    """Each row's valid timesteps against the port's ``infer`` of the
    same sequences (float32; the engine pads rows, infer pads time to
    another length, neither changes a valid step)."""
    lens = req["word:lens"]
    want = infer(out, params, [(list(ids[:n]),) for ids, n in
                               zip(req["word"], lens)], device="cpu")
    assert got.shape == (len(lens), SEQ_LEN, SMALL["label_size"])
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=1e-5,
                                   atol=1e-6)


def test_tagger_bundle_engine_and_http_match_infer(tagger_bundle):
    out_dir, out, params = tagger_bundle
    bundle = load_bundle(out_dir, device="cpu")
    assert bundle.outputs == [{"name": "gru_tag_out", "dtype": "float32",
                               "shape_suffix": [SEQ_LEN, 5]}]
    rng = np.random.RandomState(0)
    engine = InferenceEngine(bundle, max_latency_ms=20.0)
    server = thread = None
    try:
        reqs = [_request(rng, n) for n in (1, 3, 2, 4)]
        futures = [engine.submit(r) for r in reqs]
        for req, fut in zip(reqs, futures):
            _check_rows(fut.result(timeout=60)["gru_tag_out"], req, out,
                        params)
        server, thread = serve_in_thread(bundle, engine)
        req = _request(rng, 3)
        body = json.dumps({"inputs": {k: v.tolist()
                                      for k, v in req.items()}}).encode()
        url = "http://127.0.0.1:%d/infer" % server.server_address[1]
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})) as fh:
            resp = json.loads(fh.read())
        _check_rows(np.asarray(resp["outputs"]["gru_tag_out"], np.float32),
                    req, out, params)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()
    stats = engine.stats()
    assert stats["requests"] == 5 and stats["batches_failed"] == 0


def test_jax_tagger_params_serve_like_the_jax_bundle(tmp_path):
    """params.npz written by the JAX package's export_bundle for the
    tagger loads into the port's bundle and answers as the JAX Bundle
    does, every timestep (padded ones included) within 1e-5."""
    import jax

    from paddle_tpu.serve.bundle import Bundle as JaxBundle
    from paddle_tpu.serve.export import export_bundle as jax_export

    jax_reset_names()
    jout = jax_model(**SMALL)
    jtopo = JaxTopology(jout)
    jparams = JaxParameters()
    jparams._specs = jtopo.param_specs()
    jparams._values = jtopo.init_params(jax.random.PRNGKey(13))
    jax_dir = str(tmp_path / "jax")
    jax_export(jout, jparams, jax_dir, batch_sizes=(1, 4), seq_len=SEQ_LEN)
    port_dir = str(tmp_path / "port")
    export_bundle(parse_builder(BUILDER, SMALL),
                  Parameters.from_npz(str(tmp_path / "jax" / "params.npz")),
                  port_dir, batch_sizes=(1, 4), seq_len=SEQ_LEN)
    port, ref = load_bundle(port_dir, device="cpu"), JaxBundle(jax_dir)
    assert port.manifest["inputs"] == ref.manifest["inputs"]
    rng = np.random.RandomState(1)
    for rows in (1, 3):
        req = _request(rng, rows)
        np.testing.assert_allclose(port.infer(req)["gru_tag_out"],
                                   ref.infer(req)["gru_tag_out"],
                                   rtol=1e-5, atol=1e-5)


def test_cli_export_and_serve_the_tagger(tmp_path, capsys):
    out_dir = str(tmp_path / "b")
    assert cli.main(["export", "--builder", BUILDER, "--builder-kwargs",
                     json.dumps(SMALL), "--seed", "3", "--device", "cpu",
                     "-o", out_dir, "--batch-sizes", "1,2",
                     "--seq-len", "6"]) == 0
    exported = json.loads(capsys.readouterr().out)
    assert exported["outputs"] == [{"name": "gru_tag_out",
                                    "dtype": "float32",
                                    "shape_suffix": [6, 5]}]
    assert cli.main(["serve", out_dir, "--selfcheck", "--device", "cpu"]) == 0
    check = json.loads(capsys.readouterr().out)
    assert check["ok"] and check["outputs"] == {"gru_tag_out": [1, 6, 5]}


def test_export_refuses_decode_slots(tmp_path):
    """The decode export takes positive slot capacities and windows only
    (tests/test_torch_scheduler.py holds the decode block against the JAX
    package's)."""
    reset_name_counters()
    params = Parameters.create(Topology(sequence_tagging_gru(**SMALL)),
                               device="cpu")
    builder = parse_builder(BUILDER, SMALL)
    with pytest.raises(EnforceError, match="decode_slots must be positive"):
        export_bundle(builder, params, str(tmp_path), seq_len=SEQ_LEN,
                      decode_slots=(0, 4))
    with pytest.raises(EnforceError, match="decode_window must be >= 1"):
        export_bundle(builder, params, str(tmp_path), seq_len=SEQ_LEN,
                      decode_slots=(4,), decode_window=-1)
    manifest = export_bundle(builder, params, str(tmp_path),
                             seq_len=SEQ_LEN, decode_slots=(4,))
    assert manifest["decode"]["window"] == 8
    assert manifest["decode"]["slots"] == [{"slots": 4}]


def test_bf16_policy_tagger_tracks_f32():
    """Under the bfloat16 compute policy the GRU kernel's plain version
    runs in bfloat16 (r*h and h rounded every step, sums in float32);
    probabilities stay within bfloat16 rounding of the float32 run."""
    from paddle_tpu_torch.core import dtype as dtype_mod

    _, (topo, out) = _both()
    params = params_from_numpy(_numpy_params(topo.param_specs()), topo,
                               device="cpu")
    ids, lens = _feed()
    feed = {"word": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    f32 = topo.apply(params, feed, mode="test")[0][out.name].data
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed, mode="test")[0][out.name].data
    finally:
        dtype_mod.set_mixed_precision(None)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=3e-2)
