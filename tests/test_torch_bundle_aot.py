"""The port's AOT serving bundle against the JAX package's, on the CPU.

``export_bundle`` writes one ``torch.export`` program per batch bucket
(and per decode slot capacity) beside ``params.npz`` and a manifest with
the JAX bundle's keys; ``Bundle`` loads the programs without the graph.
Here, from the same numpy parameters in both packages:

* the manifest's keys and values against JAX's, bucket choice and padding;
* a fresh process (``OMP_NUM_THREADS=1``) that blocks the port's graph,
  topology, layer, network, model, config and inference modules loads an
  fp, an int8 and a decode bundle and answers within 1e-5 of the JAX
  bundles (the decode bundle: one window);
* the compute dtype is the export's: a bundle exported under the bfloat16
  policy serves bfloat16 with the policy off or on, as JAX's does, and a
  float32 bundle serves float32 under the policy;
* ``verify_bundle``, ``is_bundle``, the refusals (a bundle written before
  the programs, a platform without a program, ``cuda`` without a card);
* ``cli export --config`` and ``--builder`` with a parameter tar against
  the JAX CLI's bundle;
* the signatures of ``export_bundle`` and ``SGD.export_inference_bundle``.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import dtype as jax_dtype
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models import text as jax_text
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.serve import load_bundle as jax_load
from paddle_tpu.serve.export import export_bundle as jax_export
from paddle_tpu.topology import Topology as JaxTopology

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models import text
from paddle_tpu_torch.serve import is_bundle, load_bundle
from paddle_tpu_torch.serve.export import export_bundle, verify_bundle
from paddle_tpu_torch.topology import Topology
from tests.torch_decode import (GRU_BUILDER, SMALL as TAGGER, export_pair,
                                numpy_params, port_parameters, sequences)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(dict_size=50, emb_size=16, hidden=32, num_classes=3,
                num_layers=2)
SEQ_LEN = 8
BUCKETS = (1, 4)
TOL = 1e-5

# the fresh process: any import of the port's graph machinery fails
LOADER = """\
import json
import sys

FORBIDDEN = tuple("paddle_tpu_torch." + m for m in (
    "graph", "topology", "layer", "networks", "models", "config",
    "inference"))


class GraphImportBlocker:
    def find_spec(self, name, path=None, target=None):
        if name in FORBIDDEN or any(name.startswith(f + ".")
                                    for f in FORBIDDEN):
            raise ImportError("bundle loading must not rebuild the graph: "
                              "import of %r" % name)
        return None


sys.meta_path.insert(0, GraphImportBlocker())

import numpy as np

from paddle_tpu_torch.serve import load_bundle

for job in json.loads(sys.argv[1]):
    bundle = load_bundle(job["bundle"], device="cpu")
    with np.load(job["inputs"]) as data:
        inputs = {k: data[k] for k in data.files}
    if job["decode"]:
        carry, outs = bundle.decode_step(bundle.zero_carry(), inputs)
        out = {k: v.numpy() for k, v in outs.items()}
        out.update({"carry:%s:%d" % (layer, i): leaf.numpy()
                    for layer, leaves in carry.items()
                    for i, leaf in enumerate(leaves)})
    else:
        out = bundle.infer(inputs)
    np.savez(job["outputs"], **out)
print("LOADED_WITHOUT_GRAPH")
"""


def _flagship_pair(tmp, quantize=None, bf16=False, name="flagship"):
    """The small flagship exported by both packages from the same numpy
    parameters (under the bfloat16 policy in both with ``bf16``); returns
    (port dir, JAX dir)."""
    reset_name_counters()
    out = text.text_classification_lstm(**FLAGSHIP)
    topo = Topology(out)
    arrays = numpy_params(topo.param_specs(), seed=21)
    jax_reset_names()
    jout = jax_text.text_classification_lstm(**FLAGSHIP)
    jparams = JaxParameters()
    jparams._specs = JaxTopology(jout).param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    port_dir = str(tmp / ("%s_port" % name))
    jax_dir = str(tmp / ("%s_jax" % name))
    if bf16:
        dtype_mod.set_mixed_precision("bfloat16")
        jax_dtype.set_mixed_precision("bfloat16")
    try:
        export_bundle(out, port_parameters(topo, arrays), port_dir,
                      batch_sizes=BUCKETS, seq_len=SEQ_LEN,
                      quantize=quantize)
        jax_export(jout, jparams, jax_dir, batch_sizes=BUCKETS,
                   seq_len=SEQ_LEN, quantize=quantize)
    finally:
        if bf16:
            dtype_mod.set_mixed_precision(None)
            jax_dtype.set_mixed_precision(None)
    return port_dir, jax_dir


def _request(rows, seed=3):
    rng = np.random.RandomState(seed)
    return {"word": rng.randint(0, FLAGSHIP["dict_size"],
                                (rows, SEQ_LEN)).astype(np.int32),
            "word:lens": rng.randint(1, SEQ_LEN + 1, rows).astype(np.int32)}


@pytest.fixture(scope="module")
def fp_pair(tmp_path_factory):
    return _flagship_pair(tmp_path_factory.mktemp("fp"))


def test_manifest_keys_and_specs_match_jax(fp_pair):
    port_dir, jax_dir = fp_pair
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    assert set(port.manifest) == set(ref.manifest)
    for key in ("version", "name", "platforms", "compute_dtype", "inputs",
                "outputs", "seq_len", "params_file", "hbm_estimate_bytes"):
        assert port.manifest[key] == ref.manifest[key], key
    assert [b["batch"] for b in port.manifest["buckets"]] == list(BUCKETS)
    assert [b["artifact"] for b in port.manifest["buckets"]] == [
        "fwd_b%d.pt2" % b for b in BUCKETS]
    assert port.manifest["framework"] == {
        "paddle_tpu_torch": "0.1.0", "torch": torch.__version__}
    # params.npz is the only payload: no program stores a parameter
    for b in port.manifest["buckets"]:
        program = torch.export.load(os.path.join(port_dir, b["artifact"]))
        assert not program.state_dict and not program.constants
        assert program.example_inputs is None


@pytest.mark.parametrize("rows,bucket", [(1, 1), (2, 4), (3, 4), (4, 4)])
def test_bucket_choice_and_padding_match_jax(fp_pair, rows, bucket):
    port_dir, jax_dir = fp_pair
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    assert port.bucket_for(rows)["batch"] == ref.bucket_for(rows)["batch"] \
        == bucket
    req = _request(rows, seed=rows)
    got = port.infer(req)["lstm_out"]
    assert got.shape == (rows, FLAGSHIP["num_classes"])
    np.testing.assert_allclose(got, ref.infer(req)["lstm_out"], rtol=TOL,
                               atol=TOL)
    # the padding rows replicate the last row and are sliced off
    padded = {k: np.concatenate([v, np.repeat(v[-1:], bucket - rows, 0)])
              for k, v in req.items()}
    np.testing.assert_array_equal(
        port.run(padded, bucket)["lstm_out"][:rows], got)
    with pytest.raises(ValueError, match="largest exported bucket"):
        port.bucket_for(5)


def test_fresh_process_serves_fp_int8_and_decode_without_the_graph(
        tmp_path, fp_pair):
    q_port, q_jax = _flagship_pair(tmp_path, quantize="int8", name="q")
    _, dec_port, _, dec_jax = export_pair(tmp_path / "dec", GRU_BUILDER,
                                          TAGGER)
    req = _request(3, seed=7)
    dec_ref = jax_load(dec_jax)
    flat = dec_ref.dummy_decode_flat()
    seqs = sequences([4, 2], seed=5)
    for i, seq in enumerate(seqs):
        flat["word"][i, :len(seq)] = seq
    flat["lens"][:] = [len(q) for q in seqs]
    flat["reset"][:] = 1.0
    jobs, want = [], []
    for name, port_dir, ref, inputs, decode in (
            ("fp", fp_pair[0], jax_load(fp_pair[1]), req, False),
            ("int8", q_port, jax_load(q_jax), req, False),
            ("decode", dec_port, dec_ref, flat, True)):
        np.savez(str(tmp_path / (name + "_in.npz")), **inputs)
        jobs.append({"bundle": port_dir, "decode": decode,
                     "inputs": str(tmp_path / (name + "_in.npz")),
                     "outputs": str(tmp_path / (name + "_out.npz"))})
        if decode:
            carry, outs = ref.decode_step(ref.zero_carry(), inputs)
            expect = {k: np.asarray(v) for k, v in outs.items()}
            expect.update({"carry:%s:%d" % (layer, i): np.asarray(leaf)
                           for layer, leaves in carry.items()
                           for i, leaf in enumerate(leaves)})
        else:
            expect = ref.infer(inputs)
        want.append(expect)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", LOADER, json.dumps(jobs)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED_WITHOUT_GRAPH" in proc.stdout
    for job, expect in zip(jobs, want):
        with np.load(job["outputs"]) as got:
            assert sorted(got.files) == sorted(expect)
            for key in expect:
                np.testing.assert_allclose(got[key], expect[key], rtol=TOL,
                                           atol=TOL, err_msg=key)


def test_int8_bundle_payload_and_answers_match_jax(tmp_path):
    port_dir, jax_dir = _flagship_pair(tmp_path, quantize="int8")
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    assert port.manifest["quantization"] == ref.manifest["quantization"]
    assert {k: v.dtype for k, v in port.params().items()
            if v.dtype == torch.int8}
    req = _request(4, seed=8)
    np.testing.assert_allclose(port.infer(req)["lstm_out"],
                               ref.infer(req)["lstm_out"], rtol=TOL,
                               atol=TOL)


def test_decode_window_matches_jax(tmp_path):
    _, port_dir, _, jax_dir = export_pair(tmp_path, GRU_BUILDER, TAGGER)
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    flat = port.dummy_decode_flat()
    seqs = sequences([3, 4], seed=9)
    for i, seq in enumerate(seqs):
        flat["word"][i, :len(seq)] = seq
    flat["lens"][:] = [3, 4]
    flat["reset"][:] = 1.0
    carry, outs = port.decode_step(port.zero_carry(), flat)
    jcarry, jouts = ref.decode_step(ref.zero_carry(), dict(flat))
    for name in outs:
        np.testing.assert_allclose(outs[name].numpy(),
                                   np.asarray(jouts[name]), rtol=TOL,
                                   atol=TOL)
    for layer in carry:
        for leaf, jleaf in zip(carry[layer], jcarry[layer]):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       rtol=TOL, atol=TOL)


def test_bf16_export_computes_in_bf16_whatever_the_serving_policy(
        tmp_path, fp_pair):
    """The compute dtype is the export's: the bfloat16 bundle's manifest
    says so, it answers the same with the serving policy off and on, and
    within 1e-2 of the JAX bfloat16 bundle; the float32 bundle served
    under the bfloat16 policy answers as JAX's float32 bundle."""
    port_dir, jax_dir = _flagship_pair(tmp_path, bf16=True, name="bf16")
    ref = jax_load(jax_dir)
    req = _request(4, seed=11)
    off = load_bundle(port_dir, device="cpu")
    assert off.manifest["compute_dtype"] == ref.manifest["compute_dtype"] \
        == "bfloat16"
    got_off = off.infer(req)["lstm_out"]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        got_on = load_bundle(port_dir, device="cpu").infer(req)["lstm_out"]
        fp_got = load_bundle(fp_pair[0], device="cpu").infer(req)[
            "lstm_out"]
    finally:
        dtype_mod.set_mixed_precision(None)
    np.testing.assert_array_equal(got_on, got_off)
    np.testing.assert_allclose(got_off, np.asarray(
        ref.infer(req)["lstm_out"], np.float32), atol=1e-2)
    np.testing.assert_allclose(fp_got, jax_load(fp_pair[1]).infer(req)[
        "lstm_out"], rtol=TOL, atol=TOL)


def test_verify_bundle_and_is_bundle(fp_pair, tmp_path):
    from paddle_tpu.serve.bundle import is_bundle as jax_is_bundle

    port_dir, jax_dir = fp_pair
    assert verify_bundle(port_dir, device="cpu") == {
        "lstm_out": (1, FLAGSHIP["num_classes"])}
    assert is_bundle(port_dir) and jax_is_bundle(jax_dir)
    # each package's bundle is its own format
    assert not is_bundle(jax_dir) and not jax_is_bundle(port_dir)
    assert not is_bundle(str(tmp_path)) and not is_bundle(
        os.path.join(port_dir, "params.npz"))


def test_refuses_a_builder_bundle_and_a_missing_platform(fp_pair, tmp_path):
    from paddle_tpu_torch.utils.error import EnforceError

    with open(os.path.join(fp_pair[0], "manifest.json")) as fh:
        manifest = json.load(fh)
    old = tmp_path / "old"
    old.mkdir()
    # the manifest a bundle had before it held programs
    legacy = dict(manifest, builder={"module": "m", "function": "f",
                                     "kwargs": {}},
                  buckets=[{"batch": 1}])
    (old / "manifest.json").write_text(json.dumps(legacy))
    with pytest.raises(ValueError, match="re-export"):
        load_bundle(str(old), device="cpu")
    cuda_only = tmp_path / "cuda_only"
    cuda_only.mkdir()
    (cuda_only / "manifest.json").write_text(
        json.dumps(dict(manifest, platforms=["cuda"])))
    with pytest.raises(ValueError, match="no program for device cpu"):
        load_bundle(str(cuda_only), device="cpu")
    reset_name_counters()
    out = text.text_classification_lstm(**FLAGSHIP)
    params = port_parameters(Topology(out), numpy_params(
        Topology(out).param_specs()))
    if not torch.cuda.is_available():
        with pytest.raises(EnforceError, match="platform 'cuda' needs"):
            export_bundle(out, params, str(tmp_path / "c"),
                          seq_len=SEQ_LEN, platforms=("cuda",))
    with pytest.raises(EnforceError, match="platforms must name"):
        export_bundle(out, params, str(tmp_path / "t"), seq_len=SEQ_LEN,
                      platforms=("tpu",))


EXPORT_CONFIG = """
import paddle.v2 as paddle


def infer_outputs():
    words = paddle.layer.data(
        name="word", type=paddle.data_type.integer_value_sequence(50))
    emb = paddle.layer.embedding(input=words, size=8, name="cfg_emb")
    lstm = paddle.networks.simple_lstm(input=emb, size=6, name="cfg_lstm")
    pooled = paddle.layer.pooling(input=lstm,
                                  pooling_type=paddle.pooling.MaxPooling(),
                                  name="cfg_pool")
    return paddle.layer.fc(input=pooled, size=3,
                           act=paddle.activation.Softmax(), name="cfg_out")
"""


def _params_tar(tmp_path, jout):
    """A JAX parameter tar of ``jout``'s parameters from numpy."""
    arrays = numpy_params(JaxTopology(jout).param_specs(), seed=31)
    jparams = JaxParameters()
    jparams._specs = JaxTopology(jout).param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    path = str(tmp_path / "params.tar")
    with open(path, "wb") as fh:
        jparams.to_tar(fh)
    return path


@pytest.mark.parametrize("source", ["config", "builder"])
def test_cli_export_with_a_parameter_tar_matches_the_jax_cli(
        tmp_path, capsys, source):
    import importlib.util

    from paddle_tpu import cli as jcli

    from paddle_tpu_torch import cli

    conf = tmp_path / "export_conf.py"
    conf.write_text(EXPORT_CONFIG)
    if source == "config":
        args = ["--config", str(conf)]
        saved = {n: m for n, m in sys.modules.items()
                 if n == "paddle" or n.startswith("paddle.")}
        sys.path.insert(0, os.path.join(ROOT, "compat"))
        try:
            jax_reset_names()
            spec = importlib.util.spec_from_file_location("jax_conf",
                                                          str(conf))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            tar = _params_tar(tmp_path, mod.infer_outputs())
        finally:
            sys.path.remove(os.path.join(ROOT, "compat"))
    else:
        args = ["--builder", "paddle_tpu.models.text:"
                "text_classification_lstm"]
        jax_reset_names()
        tar = _params_tar(tmp_path, jax_text.text_classification_lstm())
    common = ["--params", tar, "--batch-sizes", "1,2", "--seq-len", "6"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    try:
        assert jcli.main(["export", *args, *common, "-o", jax_dir]) == 0
    finally:
        if source == "config":
            for n in [n for n in sys.modules
                      if n == "paddle" or n.startswith("paddle.")]:
                del sys.modules[n]
            sys.modules.update(saved)
    capsys.readouterr()
    port_args = (args if source == "config" else
                 ["--builder", "paddle_tpu_torch.models.text:"
                  "text_classification_lstm"])
    assert cli.main(["export", *port_args, *common, "--device", "cpu",
                     "-o", port_dir]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["buckets"] == [1, 2] and summary["platforms"] == ["cpu"]
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    assert port.manifest["outputs"] == ref.manifest["outputs"]
    assert port.manifest["inputs"] == ref.manifest["inputs"]
    rng = np.random.RandomState(4)
    dict_size = ref.manifest["inputs"][0]["dim"]
    req = {"word": rng.randint(0, dict_size, (2, 6)).astype(np.int32),
           "word:lens": np.array([6, 3], np.int32)}
    name = port.manifest["outputs"][0]["name"]
    np.testing.assert_allclose(port.infer(req)[name], ref.infer(req)[name],
                               rtol=TOL, atol=TOL)


def test_export_signatures_match_jax():
    from paddle_tpu.serve.export import export_bundle as jexport
    from paddle_tpu.trainer import SGD as JaxSGD

    from paddle_tpu_torch.trainer import SGD

    assert inspect.signature(export_bundle) == inspect.signature(jexport)
    assert inspect.signature(SGD.export_inference_bundle) == \
        inspect.signature(JaxSGD.export_inference_bundle)
