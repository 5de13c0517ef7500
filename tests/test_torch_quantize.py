"""Quantized int8 bundles (serve/quantize.py) in both packages, on the CPU,
small: the scheme and its selection, the mixed-dtype payload, the port's
int8 bundles against the JAX package's, the accuracy gate, the CLI and the
guards.

- The scheme: ``quantize_int8`` gives bit-identical q and scale;
  ``quantizable_params`` picks the same names as the JAX package's on the
  mlp, the small flagship and ResNet-18 (fc native; conv non-native;
  embedding, LSTM cell, bias and batch-norm tensors never).
- The payload: int8 tensors and float32 sidecars round-trip bit-exact
  through ``to_npz`` / ``from_npz`` and keep their static specs through
  ``to_tar`` / ``from_tar``; ``params_from_numpy`` keeps int8 int8 and the
  sidecars float32 under a bfloat16 dtype.
- Against the JAX package, from the same numpy parameters: ``params.npz``
  arrays equal; the mlp's and the small flagship's answers within 1e-5 of
  the JAX int8 bundle's (both dequantize in float32, then sum float32
  products in another order); ResNet-18 at 32x32 within 1e-5 of the JAX
  forward over ``dequant_for_trace(qparams)``, as ``export._make_forward``
  runs it.
- The JAX package's accuracy gate against the fp twin (argmax agreement
  >= 0.98, max drift <= 0.05, tests/test_quantize.py) on the port's mlp and
  flagship.
Every engine is stopped inside its test.
"""

import io
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import text_classification_lstm as jax_lstm
from paddle_tpu.models.vision import mlp as jax_mlp
from paddle_tpu.models.vision import resnet as jax_resnet
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.serve import quantize as jq
from paddle_tpu.serve.bundle import Bundle as JaxBundle
from paddle_tpu.serve.export import export_bundle as jax_export
from paddle_tpu.topology import Topology as JaxTopology

from paddle_tpu_torch import cli
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.models.vision import mlp, resnet
from paddle_tpu_torch.ops import int8_kernels as ik
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import InferenceEngine, export_bundle, load_bundle
from paddle_tpu_torch.serve import quantize as pq
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.error import EnforceError
from tests.torch_decode import port_model

MLP_BUILDER = "paddle_tpu_torch.models.vision:mlp"
LSTM_BUILDER = "paddle_tpu_torch.models.text:text_classification_lstm"
RESNET_BUILDER = "paddle_tpu_torch.models.vision:resnet"
SMALL = dict(dict_size=50, emb_size=16, hidden=32, num_classes=2,
             num_layers=2)
RESNET18 = dict(depth=18, num_classes=10, im_size=32)
SEQ_LEN = 8
SCHEME = "int8-sym-perchannel"

MODELS = {
    "mlp": (mlp, jax_mlp, {}, MLP_BUILDER),
    "flagship": (text_classification_lstm, jax_lstm, SMALL, LSTM_BUILDER),
    "resnet18": (resnet, jax_resnet, RESNET18, RESNET_BUILDER),
}


def _both(model):
    """(port topology, JAX topology, JAX output layer) of one model."""
    build, jbuild, kwargs, _ = MODELS[model]
    jax_reset_names()
    jout = jbuild(**kwargs)
    reset_name_counters()
    return Topology(build(**kwargs)), JaxTopology(jout), jout


def _numpy_params(specs, seed=0):
    """Weights N(0, 1/fan_in); biases, batch-norm betas and moving means
    N(0, 0.1^2); gammas 1 + N(0, 0.1^2); moving variances 1 + U(0, 0.5)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = spec.shape
        if name.endswith(".moving_var"):
            value = 1 + 0.5 * rng.rand(*shape)
        elif "_bn.w0" in name:
            value = 1 + 0.1 * rng.randn(*shape)
        elif len(shape) < 2:
            value = 0.1 * rng.randn(*shape)
        else:
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        out[name] = value.astype(np.float32)
    return out


def _port_params(topo, arrays):
    return Parameters({k: torch.from_numpy(v) for k, v in arrays.items()},
                      topo.param_specs())


def _jax_params(jtopo, arrays):
    jparams = JaxParameters()
    jparams._specs = jtopo.param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jparams


# -- the scheme --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 4, 16), (5,), (8, 4)])
def test_quantize_int8_is_bit_identical_to_the_jax_package(shape):
    w = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    if shape == (8, 4):
        w[:, 1] = 0.0  # an all-zero channel: scale 1.0
    q, scale = pq.quantize_int8(w)
    jq_, jscale = jq.quantize_int8(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert q.tobytes() == jq_.tobytes()
    assert scale.tobytes() == jscale.tobytes()
    for a, b in ((pq.SCHEME_INT8, jq.SCHEME_INT8),
                 (pq.SCALE_SUFFIX, jq.SCALE_SUFFIX),
                 (pq.QUANTIZABLE_CONSUMERS, jq.QUANTIZABLE_CONSUMERS),
                 (pq.INT8_NATIVE_CONSUMERS, jq.INT8_NATIVE_CONSUMERS),
                 (pq.scale_name("a.w0"), jq.scale_name("a.w0"))):
        assert a == b
    assert pq.is_scale_name("a.w0::scale") and not pq.is_scale_name("a.w0")
    # dequantize: numpy and tensors alike, the scale's dtype
    np.testing.assert_array_equal(
        pq.dequantize(torch.from_numpy(q), torch.from_numpy(scale)).numpy(),
        jq.dequantize(q, scale))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_quantizable_params_pick_the_jax_packages_names(model):
    topo, jtopo, _ = _both(model)
    arrays = _numpy_params(topo.param_specs())
    chosen = pq.quantizable_params(topo, _port_params(topo, arrays))
    assert chosen == jq.quantizable_params(jtopo, _jax_params(jtopo, arrays))
    assert chosen
    for name, info in chosen.items():
        kind = topo.by_name[name.rsplit(".", 1)[0]].layer_type
        assert info["native"] == (kind == "fc"), name
    never = [n for n in arrays if n.endswith((".wbias", ".moving_mean",
                                              ".moving_var"))
             or "_bn." in n or "emb" in n or n.startswith("lstm0.")
             or n.startswith("lstm1.")]
    assert never and not set(never) & set(chosen)
    if model == "resnet18":
        assert sum(not i["native"] for i in chosen.values()) == 20  # convs


def test_nothing_to_quantize_raises():
    reset_name_counters()
    from paddle_tpu_torch import data_type, layer

    out = layer.embedding(input=layer.data(
        name="w", type=data_type.integer_value(10)), size=4)
    topo = Topology(out)
    with pytest.raises(EnforceError, match="nothing to quantize"):
        pq.quantize_parameters(Parameters.create(topo, device="cpu"), topo)


# -- the payload ---------------------------------------------------------------

def test_mixed_dtype_payload_round_trips_bit_exact():
    topo, _, _ = _both("mlp")
    qparams, qmanifest = pq.quantize_parameters(
        _port_params(topo, _numpy_params(topo.param_specs())), topo)
    assert qmanifest["scheme"] == SCHEME
    assert qparams.get("mlp_fc0.w0").dtype == np.int8
    assert qparams.get("mlp_fc0.w0::scale").dtype == np.float32
    assert qparams.get("mlp_fc0.wbias").dtype == np.float32
    buf = io.BytesIO()
    qparams.to_npz(buf)
    buf.seek(0)
    back = Parameters.from_npz(buf)
    assert back.names() == qparams.names()
    for name in qparams.names():
        a, b = qparams.get(name), back.get(name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    tar = io.BytesIO()
    qparams.to_tar(tar)
    tar.seek(0)
    back = Parameters.from_tar(tar, device="cpu")
    assert back.get("mlp_out.w0").tobytes() == qparams.get(
        "mlp_out.w0").tobytes()
    _, static, _ = back.partition()
    assert "mlp_out.w0" in static and "mlp_out.w0::scale" in static


def test_params_from_numpy_keeps_int8_and_float32_sidecars_under_bf16():
    topo, _, _ = _both("mlp")
    qparams, qmanifest = pq.quantize_parameters(
        _port_params(topo, _numpy_params(topo.param_specs())), topo)
    arrays = {n: qparams.get(n) for n in qparams.names()}
    got = params_from_numpy(arrays, topo, device="cpu",
                            dtype=torch.bfloat16, quantization=qmanifest)
    assert got["mlp_fc1.w0"].dtype == torch.int8
    assert got["mlp_fc1.w0::scale"].dtype == torch.float32
    assert got["mlp_fc1.wbias"].dtype == torch.bfloat16
    assert got["mlp_fc1.w0::scale"].numpy().tobytes() == arrays[
        "mlp_fc1.w0::scale"].tobytes()


@pytest.mark.parametrize("case,match", [
    ("extra", "unexpected"),
    ("no_block", "unexpected"),
    ("missing_sidecar", "missing"),
    ("sidecar_shape", "shape"),
    ("float_weight", "must be int8"),
])
def test_params_from_numpy_guards_a_quantized_payload(case, match):
    topo, _, _ = _both("mlp")
    qparams, qmanifest = pq.quantize_parameters(
        _port_params(topo, _numpy_params(topo.param_specs())), topo)
    arrays = {n: qparams.get(n) for n in qparams.names()}
    if case == "extra":
        arrays["mlp_fc0.w1"] = np.zeros((3,), np.float32)
    elif case == "no_block":
        qmanifest = None
    elif case == "missing_sidecar":
        del arrays["mlp_out.w0::scale"]
    elif case == "sidecar_shape":
        arrays["mlp_out.w0::scale"] = arrays["mlp_out.w0::scale"][:5]
    elif case == "float_weight":
        arrays["mlp_out.w0"] = arrays["mlp_out.w0"].astype(np.float32)
    with pytest.raises(EnforceError, match=match):
        params_from_numpy(arrays, topo, device="cpu", quantization=qmanifest)


def test_export_refuses_other_schemes(tmp_path):
    topo, _, _ = _both("mlp")
    params = _port_params(topo, _numpy_params(topo.param_specs()))
    with pytest.raises(EnforceError, match=r"unsupported quantize scheme "
                       r"'fp16' \(only 'int8'\)"):
        export_bundle(port_model(MLP_BUILDER), params,
                      str(tmp_path / "b"), quantize="fp16")


# -- against the JAX package ---------------------------------------------------

def _export_pair(tmp_path, model, batch_sizes, seq_len=None):
    """The same numpy parameters exported int8 by both packages; returns
    (port bundle dir, JAX bundle dir, numpy parameters)."""
    topo, jtopo, jout = _both(model)
    arrays = _numpy_params(topo.param_specs(), seed=7)
    _, _, kwargs, builder = MODELS[model]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    manifest = export_bundle(port_model(builder, **kwargs),
                             _port_params(topo, arrays), port_dir,
                             batch_sizes=batch_sizes, seq_len=seq_len,
                             quantize="int8")
    jmanifest = jax_export(jout, _jax_params(jtopo, arrays), jax_dir,
                           batch_sizes=batch_sizes, seq_len=seq_len,
                           quantize="int8")
    assert manifest["quantization"] == jmanifest["quantization"]
    return port_dir, jax_dir, arrays


def _same_payload(port_dir, jax_dir):
    with np.load(port_dir + "/params.npz") as a, \
            np.load(jax_dir + "/params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name


def test_int8_mlp_bundle_matches_the_jax_int8_bundle(tmp_path):
    port_dir, jax_dir, _ = _export_pair(tmp_path, "mlp", (1, 4))
    _same_payload(port_dir, jax_dir)
    port, ref = load_bundle(port_dir, device="cpu"), JaxBundle(jax_dir)
    assert "quantized=%s" % SCHEME in repr(port)
    assert port.params()["mlp_fc0.w0"].dtype == torch.int8
    x = np.random.RandomState(3).randn(4, 784).astype(np.float32)
    for rows in (1, 3, 4):
        np.testing.assert_allclose(port.infer({"pixel": x[:rows]})["mlp_out"],
                                   ref.infer({"pixel": x[:rows]})["mlp_out"],
                                   rtol=0, atol=1e-5)


def test_int8_flagship_bundle_matches_the_jax_int8_bundle(tmp_path):
    port_dir, jax_dir, _ = _export_pair(tmp_path, "flagship", (1, 4),
                                        SEQ_LEN)
    _same_payload(port_dir, jax_dir)
    port, ref = load_bundle(port_dir, device="cpu"), JaxBundle(jax_dir)
    assert sorted(port.quantization["params"]) == [
        "lstm0_transform.w0", "lstm1_transform.w0", "lstm_out.w0"]
    rng = np.random.RandomState(4)
    for rows in (1, 3, 4):
        req = {"word": rng.randint(0, 60, (rows, SEQ_LEN)).astype(np.int32),
               "word:lens": rng.randint(0, SEQ_LEN + 1, rows)
               .astype(np.int32)}
        np.testing.assert_allclose(port.infer(req)["lstm_out"],
                                   ref.infer(req)["lstm_out"], rtol=0,
                                   atol=1e-5)


def test_int8_resnet18_matches_the_jax_forward_over_dequant_for_trace(
        tmp_path):
    """The port's int8 bundle (conv weights resident int8, dequantized at
    the top of every forward; the fc in K9's plain version) against the
    JAX forward over dequant_for_trace(qparams) in test mode."""
    topo, jtopo, jout = _both("resnet18")
    arrays = _numpy_params(topo.param_specs(), seed=9)
    out_dir = str(tmp_path / "b")
    export_bundle(port_model(RESNET_BUILDER, **RESNET18),
                  _port_params(topo, arrays), out_dir, batch_sizes=(2,),
                  quantize="int8")
    bundle = load_bundle(out_dir, device="cpu")
    qparams, qmanifest = jq.quantize_parameters(_jax_params(jtopo, arrays),
                                                jtopo)
    with np.load(out_dir + "/params.npz") as pz:
        for name in qparams.names():
            assert pz[name].tobytes() == np.asarray(
                qparams.get(name)).tobytes(), name
    x = np.random.RandomState(5).randn(2, 3 * 32 * 32).astype(np.float32)
    jparams = jq.dequant_for_trace(
        {n: jnp.asarray(qparams.get(n)) for n in qparams.names()}, qmanifest)
    want, _ = jtopo.apply(jparams, {"image": jnp.asarray(x)}, mode="test")
    got = bundle.run({"image": x}, 2)["res_out"]
    np.testing.assert_allclose(got, np.asarray(want[jout.name]), rtol=0,
                               atol=1e-5)
    # the resident conv weights stay int8 after a forward
    assert bundle.params()["res2_0_a_conv.w0"].dtype == torch.int8
    assert sum(t.dtype == torch.int8 for t in bundle.params().values()) == 21


# -- the accuracy gate -----------------------------------------------------------

def _gate(got, want):
    agreement = float(np.mean(got.argmax(1) == want.argmax(1)))
    return agreement, float(np.abs(got - want).max())


def test_accuracy_gate_on_the_port_mlp(tmp_path):
    topo, _, _ = _both("mlp")
    params = Parameters.create(topo, seed=0, device="cpu")
    builder = port_model(MLP_BUILDER)
    export_bundle(builder, params, str(tmp_path / "fp"), batch_sizes=(8,))
    export_bundle(builder, params, str(tmp_path / "q"), batch_sizes=(8,),
                  quantize="int8")
    fp = load_bundle(str(tmp_path / "fp"), device="cpu")
    q = load_bundle(str(tmp_path / "q"), device="cpu")
    x = np.random.RandomState(0).randn(64, 784).astype(np.float32)
    got = np.concatenate([q.infer({"pixel": x[i:i + 8]})["mlp_out"]
                          for i in range(0, 64, 8)])
    want = np.concatenate([fp.infer({"pixel": x[i:i + 8]})["mlp_out"]
                           for i in range(0, 64, 8)])
    agreement, drift = _gate(got, want)
    assert agreement >= 0.98 and drift <= 0.05, (agreement, drift)


def test_accuracy_gate_on_the_port_flagship_through_the_engine(tmp_path):
    topo, _, _ = _both("flagship")
    params = _port_params(topo, _numpy_params(topo.param_specs(), seed=1))
    builder = port_model(LSTM_BUILDER, **SMALL)
    export_bundle(builder, params, str(tmp_path / "fp"), batch_sizes=(1, 8),
                  seq_len=SEQ_LEN)
    export_bundle(builder, params, str(tmp_path / "q"), batch_sizes=(1, 8),
                  seq_len=SEQ_LEN, quantize="int8")
    fp = load_bundle(str(tmp_path / "fp"), device="cpu")
    q = load_bundle(str(tmp_path / "q"), device="cpu")
    rng = np.random.RandomState(2)
    reqs = [{"word": rng.randint(0, 50, (n, SEQ_LEN)).astype(np.int32),
             "word:lens": rng.randint(1, SEQ_LEN + 1, n).astype(np.int32)}
            for n in (8, 5, 8, 3, 8, 8)]
    before = ik.launches
    engine = InferenceEngine(q, max_latency_ms=20.0)
    try:
        got = [f.result(timeout=60)["lstm_out"]
               for f in [engine.submit(r) for r in reqs]]
    finally:
        engine.stop()
    agreement, drift = _gate(np.concatenate(got), np.concatenate(
        [fp.infer(r)["lstm_out"] for r in reqs]))
    assert agreement >= 0.98 and drift <= 0.05, (agreement, drift)
    assert ik.launches == before  # the CPU path runs the plain version


# -- the CLI ---------------------------------------------------------------------

def test_cli_export_quantize_int8_and_selfcheck(tmp_path, capsys):
    out_dir = str(tmp_path / "b")
    assert cli.main(["export", "--builder", LSTM_BUILDER, "--builder-kwargs",
                     json.dumps(SMALL), "--seed", "3", "--device", "cpu",
                     "--quantize", "int8", "-o", out_dir,
                     "--batch-sizes", "1,2", "--seq-len", "5"]) == 0
    exported = json.loads(capsys.readouterr().out)
    assert exported["quantization"] == SCHEME
    with np.load(out_dir + "/params.npz") as pz:
        assert pz["lstm_out.w0"].dtype == np.int8
        assert pz["lstm_out.w0::scale"].dtype == np.float32
    assert cli.main(["serve", out_dir, "--selfcheck", "--device", "cpu"]) == 0
    check = json.loads(capsys.readouterr().out)
    assert check["ok"] and check["outputs"] == {"lstm_out": [1, 2]}
    with pytest.raises(SystemExit):
        cli.main(["export", "--builder", LSTM_BUILDER, "--quantize", "fp16",
                  "-o", out_dir])
