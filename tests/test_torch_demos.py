"""The reference demos run unchanged on the port, on the CPU:

* each demo of the slice (mnist with LeNet and VGG-16, quick_start's
  LSTM, seq2seq, traffic_prediction, fit_a_line, gan on uniform and
  mnist data, model_zoo's ResNet-18) through ``python -m
  paddle_tpu_torch.demo <script> --quick ... --cpu`` in a subprocess,
  asserting what tests/test_demos.py asserts of the JAX run;
* one step of each demo's model in both packages: the demo's own
  ``build`` (or model function) imported through each package's binding,
  the same numpy parameters (``convert.params_from_numpy``) and the same
  first minibatch of the port's dataset; the cost within 1e-5 relative
  and every gradient within 1e-4 of its largest entry (float32 sums in
  other orders; VGG-16 at batch 2 with the same dropout masks on both
  sides);
* gan (both datasets): the demo's own recipe through each package's
  MultiNetworkTrainer from the same numpy parameters, both phases'
  losses within 1e-5 and the parameter store within 1e-5 over 3
  iterations; model_zoo: the demo itself in both packages from one
  parameter tar, its top-1 classes equal and its feature norm within
  1e-4;
* the binding itself: no file of the JAX package is loaded, ``paddle_tpu``
  names the port's modules only inside it, and a script whose modules
  are not ported fails with the port's "not ported yet". quick_start's
  lr and cnn and sequence_tagging run in tests/test_torch_demos_text.py.

seq2seq runs at ``--dict-size 30000``: the JAX package's synthetic wmt14
draws ids up to 30000 whatever ``dict_size`` says, where the port's
``classification_cost`` raises on an out-of-range label.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_feed as jax_convert_feed

from paddle_tpu_torch import demo
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.ops import dropout as dropout_ops
from paddle_tpu_torch.topology import Topology, convert_feed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = os.path.join(ROOT, "demos")
TOL_COST = 1e-5
TOL_GRAD = 1e-4


# A demo's subprocess computes with one CPU thread: beside the suite's
# other workers, a pool of busy-waiting threads per process is what makes
# a quick demo run slow (one such run measured 199 s with the default
# threads on a loaded machine, 4.6 s with one).
SUBPROCESS_ENV = dict(os.environ, OMP_NUM_THREADS="1")


def run_demo(script, args, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.demo",
         os.path.join(DEMOS, script)] + list(args) + ["--cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=SUBPROCESS_ENV)
    return proc


# (script, arguments, lines the output must hold)
RUNS = {
    "mnist_lenet": ("mnist/train.py", ["--quick", "--save", ""],
                    ("test error", "predictions:")),
    "mnist_vgg": ("mnist/train.py", ["--quick", "--save", "", "--model",
                                     "vgg"], ("test error", "predictions:")),
    "quick_start_lstm": ("quick_start/train.py", ["--quick", "--model",
                                                  "lstm"], ("test error",)),
    "seq2seq": ("seq2seq/train.py", ["--quick", "--dict-size", "30000"],
                ("beam best",)),
    "traffic_prediction": ("traffic_prediction/train.py", ["--quick"],
                           ("test RMSE",)),
    "fit_a_line": ("fit_a_line/train.py", ["--quick", "--export", ""],
                   ("test cost", "predictions:")),
    "gan_uniform": ("gan/train.py", ["--quick", "--data", "uniform"],
                    ("d_loss", "generated samples")),
    "gan_mnist": ("gan/train.py", ["--quick", "--data", "mnist"],
                  ("d_loss", "generated image stats")),
    "model_zoo": ("model_zoo/resnet_infer.py",
                  ["--depth", "18", "--im-size", "32", "--batch", "2",
                   "--classes", "10"], ("top-1 classes:", "features from")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_demo_runs_unchanged_on_the_port(name):
    script, args, lines = RUNS[name]
    proc = run_demo(script, args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout[-2000:])
    assert "nan" not in proc.stdout.lower(), proc.stdout[-2000:]


UNPORTED_SCRIPT = """
import paddle_tpu.plot
"""


@pytest.mark.parametrize("args,error", [
    ([], "paddle_tpu.plot is not ported yet")])
def test_unported_demo_fails_on_the_port(tmp_path, args, error):
    """A script that imports a module the port lacks fails with the port's
    "not ported yet" (every reference demo but vae, which calls jax
    itself, now runs)."""
    script = tmp_path / "unported.py"
    script.write_text(UNPORTED_SCRIPT)
    proc = run_demo(str(script), args)
    assert proc.returncode != 0
    assert error in proc.stderr, proc.stderr[-2000:]
    assert "paddle_tpu_torch" in proc.stderr  # the port answered


BINDING_PROBE = r"""
import json, os, sys
from paddle_tpu_torch import demo
import paddle_tpu_torch, paddle_tpu_torch.layer
root = os.path.abspath(sys.argv[1])
seen = {}
with demo.PortBinding():
    import paddle_tpu
    import paddle_tpu.layer
    from paddle_tpu.core.sequence import SequenceBatch
    from paddle_tpu_torch.core import sequence
    seen["alias"] = (paddle_tpu is paddle_tpu_torch
                     and paddle_tpu.layer is paddle_tpu_torch.layer
                     and SequenceBatch is sequence.SequenceBatch)
demo.run(os.path.join(root, "demos", "traffic_prediction", "train.py"),
         ["--quick"], device="cpu")
loaded = sorted(n for n, m in sys.modules.items()
                if os.path.abspath(getattr(m, "__file__", None) or "")
                .startswith(os.path.join(root, "paddle_tpu") + os.sep))
seen["jax_files"] = loaded
seen["left_bound"] = sorted(n for n in sys.modules
                            if n == "paddle_tpu"
                            or n.startswith("paddle_tpu."))
seen["jax"] = "jax" in sys.modules
print(json.dumps(seen))
"""


def test_demo_run_loads_no_file_of_the_jax_package():
    """A demo's own ``sys.path.insert`` of the repository root puts the
    JAX package on the path; the binding still answers every
    ``paddle_tpu`` import with the port, loads no file under paddle_tpu/
    (nor JAX), and leaves no ``paddle_tpu`` name behind."""
    proc = subprocess.run([sys.executable, "-c", BINDING_PROBE, ROOT],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "test RMSE" in proc.stdout
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"alias": True, "jax_files": [], "left_bound": [],
                    "jax": False}


def test_binding_sets_aside_and_restores_the_jax_package():
    import paddle_tpu as jax_pkg
    import paddle_tpu.layer as jax_layer

    import paddle_tpu_torch

    path_before, meta_before = list(sys.path), list(sys.meta_path)
    with demo.PortBinding():
        import paddle_tpu

        assert paddle_tpu is paddle_tpu_torch
        sys.path.insert(0, "/nonexistent")
        with pytest.raises(ModuleNotFoundError, match="not ported yet"):
            import paddle_tpu.plot  # noqa: F401
        with pytest.raises(AttributeError, match="not ported yet"):
            paddle_tpu.parallel
    assert sys.modules["paddle_tpu"] is jax_pkg
    assert sys.modules["paddle_tpu.layer"] is jax_layer
    assert sys.path == path_before and sys.meta_path == meta_before


def test_run_restores_the_default_device_and_argv():
    from paddle_tpu_torch.core import place

    before, argv = place.default_device(), list(sys.argv)
    demo.run(os.path.join(DEMOS, "fit_a_line", "train.py"),
             ["--quick", "--export", ""], device="cpu")
    assert place.default_device() == before and sys.argv == argv


def test_runner_usage_without_a_script():
    assert demo.main([]) == 2


# -- one step of each demo's model in both packages ------------------------------

def _jax_demo(script):
    path = os.path.join(DEMOS, script)
    name = "jax_demo_" + script.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_demo(script):
    return demo.load(os.path.join(DEMOS, script),
                     "port_demo_" + script.replace("/", "_")[:-3])


def _numpy_params(specs, seed):
    """Weights N(0, 1/fan_in) (fan_in: all but the last axis), biases and
    peephole checks N(0, 0.1^2), from a numpy seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = tuple(spec.shape)
        std = (0.1 if len(shape) < 2 or name.endswith("bias")
               else 1.0 / np.sqrt(np.prod(shape[:-1])))
        out[name] = (rng.randn(*shape) * std).astype(np.float32)
    return out


def _first(reader, n):
    return [s for _, s in zip(range(n), reader())]


def _step_both(jcost, cost, rows):
    """Cost and gradients of one train-mode step of each package on
    ``rows`` from the same numpy parameters."""
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    specs = topo.param_specs()
    assert sorted(specs) == sorted(jtopo.param_specs())
    np_params = _numpy_params(specs, seed=3)
    params = {k: v.requires_grad_() for k, v in
              params_from_numpy(np_params, topo, device="cpu").items()}
    values, _ = topo.apply(params, convert_feed(topo, rows, "cpu"),
                        mode="train", rng=torch.Generator())
    loss = values[cost.name].float().mean()
    loss.backward()
    jfeed = jax_convert_feed(jtopo, rows)

    def jloss(p):
        jvalues, _ = jtopo.apply(p, jfeed, mode="train",
                                 rng=jax.random.PRNGKey(0))
        return jnp.mean(jvalues[jcost.name])

    jval, jgrads = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    assert abs(float(loss) - float(jval)) <= TOL_COST * max(
        1.0, abs(float(jval)))
    worst = {}
    for name, p in params.items():
        want = np.asarray(jgrads[name])
        assert p.grad is not None, name
        got = p.grad.numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0, name
        worst[name] = float(np.abs(got - want).max() / np.abs(want).max())
    bad = {k: v for k, v in worst.items() if not v <= TOL_GRAD}
    assert not bad, bad
    return float(loss)


class _Masks:
    """Numpy keep-masks handed out in call order, one per dropout layer."""

    def __init__(self, shapes, keep, seed):
        rng = np.random.RandomState(seed)
        self.masks = [rng.rand(*s) < keep for s in shapes]
        self.calls = 0

    def next(self, shape):
        mask = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert tuple(mask.shape) == tuple(shape)
        return mask


def _both_built(script, build):
    jmod, mod = _jax_demo(script), _port_demo(script)
    jax_reset_names()
    jout = build(jmod)
    reset_name_counters()
    return jout, build(mod), mod


@pytest.mark.parametrize("model,rows", [("lenet", 8), ("vgg", 2)])
def test_mnist_step_matches_jax(monkeypatch, model, rows):
    jbuilt, built, mod = _both_built("mnist/train.py",
                                     lambda m: m.build(model))
    if model == "vgg":
        shapes = [(rows, 4096), (rows, 4096)]
        jmasks, pmasks = _Masks(shapes, 0.5, 1), _Masks(shapes, 0.5, 1)
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(
                                jmasks.next(shape)))
        monkeypatch.setattr(dropout_ops, "keep_mask",
                            lambda shape, p, gen, device: torch.from_numpy(
                                pmasks.next(shape)).to(device))
    _step_both(jbuilt[3], built[3], _first(mod.mnist.train(), rows))
    if model == "vgg":
        assert pmasks.calls == 2 and jmasks.calls >= 2


def test_quick_start_lstm_step_matches_jax():
    jbuilt, built, mod = _both_built("quick_start/train.py",
                                     lambda m: m.build("lstm", 5000))
    rows = _first(mod.imdb.train(mod.imdb.word_dict(5000)), 4)
    _step_both(jbuilt[2], built[2], rows)


def test_seq2seq_step_matches_jax():
    def build(m):
        return m.text.seq2seq_attention(
            src_dict_size=30000, trg_dict_size=30000, emb_size=16,
            enc_size=24, dec_size=24)[0]

    jcost, cost, mod = _both_built("seq2seq/train.py", build)
    _step_both(jcost, cost, _first(mod.wmt14.train(30000), 3))


def test_traffic_prediction_step_matches_jax():
    jbuilt, built, mod = _both_built("traffic_prediction/train.py",
                                     lambda m: m.build())
    _step_both(jbuilt[2], built[2], _first(mod.make_reader(8, seed=0), 4))


def test_fit_a_line_step_matches_jax():
    jbuilt, built, mod = _both_built("fit_a_line/train.py",
                                     lambda m: m.build())
    _step_both(jbuilt[1], built[1], _first(mod.uci_housing.train(), 8))


@pytest.mark.parametrize("data", ["uniform", "mnist"])
def test_gan_phases_match_jax(data):
    """The gan demo's recipe (its ``build``, Adam per phase, each phase
    updating its own side, the generator's fakes from its extra output)
    in both packages from the same numpy parameters, 3 iterations at
    batch 4."""
    dims = {"uniform": (10, 2, 64), "mnist": (100, 784, 256)}[data]
    jmod, mod = _jax_demo("gan/train.py"), _port_demo("gan/train.py")
    jax_reset_names()
    jmn, jfake = jmod.build(*dims)
    reset_name_counters()
    # build imports paddle_tpu.attr when it runs: inside the binding
    with demo.PortBinding():
        mn, fake = mod.build(*dims)

    def trainer(m, multi, fake_layer, **kw):
        return m.MultiNetworkTrainer(
            multi, update_equations=lambda: m.opt.Adam(learning_rate=2e-4,
                                                       beta1=0.5),
            phase_trainable={"gen": lambda p: p.startswith("gen_"),
                             "dis": lambda p: p.startswith("dis_")},
            extra_outputs={"gen": [fake_layer]}, **kw)

    jtr = trainer(jmod, jmn, jfake)
    tr = trainer(mod, mn, fake, device="cpu")
    start = _numpy_params({n: tr._params[n] for n in tr._params}, seed=4)
    assert sorted(start) == sorted(jtr._params)
    for name, value in start.items():
        jtr._params[name] = jnp.asarray(value)
        tr._params[name].copy_(torch.from_numpy(value))
    rng = np.random.RandomState(0)
    images = np.stack([s for s, _ in _first(mod.mnist.train(), 16)]) \
        if data == "mnist" else None
    n = 4
    for _ in range(3):
        noise = rng.randn(n, dims[0]).astype(np.float32)
        rows = [(z, [1.0]) for z in noise]
        fakes = tr.infer("gen", rows)[fake.name]
        jfakes = jtr.infer("gen", rows)[jfake.name]
        assert np.abs(fakes - jfakes).max() <= 1e-5 * max(
            1.0, np.abs(jfakes).max())
        real = (images[rng.randint(0, len(images), n)] if data == "mnist"
                else rng.randn(n, 2).astype(np.float32))
        d_batch = [(s, [1.0]) for s in real] + [(s, [0.0]) for s in jfakes]
        g_batch = [(z, [1.0]) for z in rng.randn(n, dims[0]).astype(
            np.float32)]
        for phase, batch, feeding in (
                ("dis", d_batch, {"sample": 0, "d_label": 1}),
                ("gen", g_batch, {"noise": 0, "g_label": 1})):
            loss = tr.train_batch(phase, batch, feeding=feeding)
            jloss = jtr.train_batch(phase, batch, feeding=feeding)
            assert abs(loss - jloss) <= TOL_COST * max(1.0, abs(jloss))
    got, want = tr.get_params(), jtr.get_params()
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1e-5 * max(
            1.0, np.abs(want[name]).max()), name


def _model_zoo_lines(stdout):
    classes = [ln for ln in stdout.splitlines()
               if ln.startswith("top-1 classes:")][0]
    feats = [ln for ln in stdout.splitlines()
             if ln.startswith("features from")][0]
    return classes, feats.rsplit(" ", 1)[0], float(feats.rsplit(" ", 1)[1])


def test_model_zoo_matches_jax(tmp_path, capsys):
    """model_zoo's resnet_infer.py, unchanged, in both packages from one
    parameter tar (either package reads the other's): the same top-1
    classes and feature layer, the feature norm within 1e-4."""
    from paddle_tpu_torch.models import vision
    from paddle_tpu_torch.parameters import Parameters

    reset_name_counters()
    out = vision.resnet(depth=18, num_classes=10, im_size=32)
    tar = str(tmp_path / "resnet18.tar")
    with open(tar, "wb") as f:
        Parameters.create(out, seed=3, device="cpu").to_tar(f)
    args = ["--depth", "18", "--im-size", "32", "--batch", "2",
            "--classes", "10", "--params", tar]
    proc = run_demo("model_zoo/resnet_infer.py", args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_reset_names()
    _jax_demo("model_zoo/resnet_infer.py").main(args)
    classes, layer, norm = _model_zoo_lines(proc.stdout)
    jclasses, jlayer, jnorm = _model_zoo_lines(capsys.readouterr().out)
    assert (classes, layer) == (jclasses, jlayer)
    assert abs(norm - jnorm) <= 1e-4 * max(1.0, jnorm)
