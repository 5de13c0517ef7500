"""The port's v1 config front end and ``cli train`` / ``test`` / ``time``
against the JAX package's, on the CPU.

- ``config`` (paddle_tpu_torch/config.py against paddle_tpu/config.py):
  ``get_config_arg`` with its types, ``settings`` (the rule that the
  learning-rate schedule is rebuilt only when settings() names it,
  regularization, the clipping threshold, ``model_average``), the three
  forms of ``define_py_data_sources2`` (module/obj, split lists, direct
  readers) with the lazy import of an absent module, ``declared_input_type``
  and ``pop_config``.
- The ``paddle`` shim: every name the JAX shim binds is bound; a stub
  raises "not ported yet" where the port lacks the layer.
- The CLI against the JAX CLI: a v1 config in the ``from
  paddle.trainer_config_helpers import *`` form (two LSTM layers, an
  ``@provider``, ``get_config_arg``) trained for 2 passes from the same
  JAX checkpoint (``--init-model``) gives the same test cost and the same
  pass checkpoints (1e-5: float32 sums in different orders over 8 Adam
  steps); both CLIs run in one process in either order, each on its own
  shim, and the port leaves the ``paddle*`` entries of ``sys.modules`` as
  it found them.
- chip_smoke.py's v1_text configs (the db-lstm form over mixed_layer and
  full_matrix_projection, and bidirectional_lstm / _gru) trained by both
  CLIs at a small size from one JAX checkpoint, held the same way.
- ``cli test --params`` scores the saved tar as the trainer's own
  ``test`` does; ``cli time`` prints a positive ``ms_per_batch``; the
  verbs and options not ported yet raise.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import cli as jcli
from paddle_tpu import config as jconfig
from paddle_tpu.graph import reset_name_counters as jax_reset_names

from paddle_tpu_torch import cli
from paddle_tpu_torch import config
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.utils.error import EnforceError

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROVIDER = '''
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, dict_size=30, **kwargs):
    settings.input_types = [integer_value_sequence(dict_size),
                            integer_value(2)]
    settings.dict_size = dict_size


@provider(init_hook=hook)
def process(settings, file_name):
    rng = np.random.RandomState(0 if file_name == "train" else 1)
    for _ in range(24 if file_name == "train" else 8):
        n = int(rng.randint(3, 9))
        yield ([int(x) for x in rng.randint(0, settings.dict_size, n)],
               int(rng.randint(0, 2)))
'''

CONFIG = '''
from paddle.trainer_config_helpers import *

batch_size = get_config_arg("batch_size", int, 8)
hidden_size = get_config_arg("hidden_size", int, 16)
lstm_num = get_config_arg("lstm_num", int, 2)

define_py_data_sources2(train_list=["train"], test_list=["test"],
                        module="{provider}", obj="process",
                        args={{"dict_size": 30}})
settings(batch_size=batch_size, learning_rate=2e-3,
         learning_method=AdamOptimizer(),
         regularization=L2Regularization(8e-4),
         gradient_clipping_threshold=25)

net = data_layer(name="word", size=30)
net = embedding_layer(input=net, size=8)
for i in range(lstm_num):
    net = simple_lstm(input=net, size=hidden_size)
net = pooling_layer(input=net, pooling_type=MaxPooling())
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer(name="label", size=2)
loss = classification_cost(input=net, label=lab)
outputs(loss)
'''


def _write_config(tmp_path, name):
    """A config dir with its own provider module (a name of its own: the
    JAX loader leaves the providers it imports in sys.modules)."""
    d = tmp_path / name
    d.mkdir()
    provider = "prov_" + name
    (d / (provider + ".py")).write_text(PROVIDER)
    (d / "conf.py").write_text(CONFIG.format(provider=provider))
    return str(d / "conf.py"), provider


def _paddle_entries():
    return {n: m for n, m in sys.modules.items()
            if n == "paddle" or n.startswith("paddle.")}


def _test_cost(out):
    line = [ln for ln in out.splitlines() if ln.startswith("test cost=")][-1]
    return float(line.split("=")[1].split()[0])


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize("args,name,type_,default", [
    ("a=3,b=x", "a", int, None), ("a=3,b=x", "b", str, None),
    ("f=0.25", "f", float, None), ("on=yes", "on", bool, None),
    ("on=0", "on", bool, None), ("", "missing", int, 7)])
def test_get_config_arg_equals_jax(args, name, type_, default):
    values = []
    for mod in (jconfig, config):
        mod.reset()
        mod.set_config_args(args)
        values.append(mod.get_config_arg(name, type_, default))
        mod.reset()
    assert values[0] == values[1]
    assert type(values[0]) is type(values[1])


def _optimizers():
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as opt

    return jopt, opt


SETTINGS = {
    "defaults": lambda o: {},
    "lr": lambda o: {"learning_rate": 0.05},
    "schedule": lambda o: {"learning_rate": 0.1,
                           "learning_rate_decay_a": 0.5,
                           "learning_rate_decay_b": 0.75,
                           "learning_rate_schedule": "poly"},
    "method_lr_kept": lambda o: {
        "learning_method": o.Momentum(learning_rate=0.01, momentum=0.9)},
    "method_lr_rebuilt": lambda o: {
        "learning_method": o.Adam(learning_rate=0.01),
        "learning_rate": 0.3},
    "reg_clip_average": lambda o: {
        "batch_size": 16, "learning_method": o.Adam(),
        "regularization": o.L2Regularization(8e-4),
        "gradient_clipping_threshold": 25,
        "model_average": o.ModelAverage(0.5)},
    "average_float": lambda o: {"model_average": 0.25},
}


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_settings_equals_jax(case):
    """The optimizer settings() leaves behind: its type, learning rate at
    steps 1, 5 and 20 (rebuilt only when settings() names the schedule),
    regularization, clip and model average, and the batch size."""
    import jax.numpy as jnp

    jopt, opt = _optimizers()
    got = []
    for mod, o, step in ((jconfig, jopt, jnp.float32),
                         (config, opt, lambda s: torch.tensor(float(s)))):
        mod.reset()
        mod.settings(**SETTINGS[case](o))
        st = mod.pop_config()
        method = st["settings"]["optimizer"]
        reg = method.regularization
        got.append((type(method).__name__,
                    [float(method.lr_fn(step(s))) for s in (1, 5, 20)],
                    None if reg is None else (reg.l1, reg.l2),
                    method.clip, method.model_average,
                    st["settings"]["batch_size"]))
    (jname, jlr, *jrest), (name, lr, *rest) = got
    assert name == jname and rest == jrest
    np.testing.assert_allclose(lr, jlr, rtol=1e-6)


def _provider_defs():
    """The same @provider reader factory made by each package's shim:
    (JAX's, the port's)."""
    out = []
    for compat in (os.path.join(ROOT, "compat"), cli.COMPAT_DIR):
        saved = _paddle_entries()
        for n in saved:
            del sys.modules[n]
        sys.path.insert(0, compat)
        try:
            from paddle.trainer.PyDataProvider2 import (integer_value,
                                                        provider)

            def hook(settings, n=3, **kw):
                settings.input_types = {"x": integer_value(10)}
                settings.n = n

            @provider(init_hook=hook)
            def process(settings, file_name):
                for i in range(settings.n):
                    yield {"x": (i + len(file_name)) % 10}

            out.append(process)
        finally:
            sys.path.remove(compat)
            for n in list(_paddle_entries()):
                del sys.modules[n]
            sys.modules.update(saved)
    return out


@pytest.mark.parametrize("form", ["module_obj", "split", "direct",
                                  "absent_module"])
def test_define_py_data_sources2_equals_jax(form, monkeypatch):
    """The three declaration forms give the same data sources, input types
    and samples; a module absent when the config runs is imported when
    the reader is made."""
    import types

    factories = _provider_defs()
    results = []
    for mod, factory in zip((jconfig, config), factories):
        name = "prov_forms_%s" % ("jax" if mod is jconfig else "port")
        module = types.ModuleType(name)
        module.process = factory
        mod.reset()
        if form == "module_obj":
            monkeypatch.setitem(sys.modules, name, module)
            mod.define_py_data_sources2(train_list=["ab"], test_list=["c"],
                                        module=name, obj="process",
                                        args={"n": 4})
        elif form == "split":
            monkeypatch.setitem(sys.modules, name, module)
            mod.define_py_data_sources2(train_list=["ab"], test_list=["c"],
                                        module=[name, name],
                                        obj=["process", "process"],
                                        args=[{"n": 2}, {"n": 5}])
        elif form == "direct":
            mod.define_py_data_sources2(
                train_reader=lambda: iter([(1,), (2,)]),
                test_reader=lambda: iter([(3,)]))
        else:
            # not importable while the config runs, importable later
            mod.define_py_data_sources2(train_list=["ab"], module=name,
                                        obj="process")
            monkeypatch.setitem(sys.modules, name, module)
        declared = mod.declared_input_type("x")
        st = mod.pop_config()
        ds = st["data_sources"]
        results.append((
            sorted(ds),
            {k: list(ds[k]()()) for k in ds},
            None if declared is None else (declared.dim, declared.seq_type,
                                           declared.value_type)))
        assert mod.pop_config() is None  # drained
    assert results[0] == results[1]
    if form != "direct":
        assert results[1][1]["train"]


def test_shim_binds_every_name_of_the_jax_shim():
    """``from paddle.trainer_config_helpers import *`` binds in the port
    every public name the JAX shim binds: None where the JAX shim binds
    None, the port's own object elsewhere (no layer name is left to a stub
    raising "not ported yet")."""
    names = {}
    for compat in (os.path.join(ROOT, "compat"), cli.COMPAT_DIR):
        saved = _paddle_entries()
        for n in saved:
            del sys.modules[n]
        sys.path.insert(0, compat)
        try:
            ns = {}
            exec("from paddle.trainer_config_helpers import *", ns)
            names[compat] = {k: v for k, v in ns.items()
                             if not k.startswith("_")}
        finally:
            sys.path.remove(compat)
            for n in list(_paddle_entries()):
                del sys.modules[n]
            sys.modules.update(saved)
    jax_names, port_names = names.values()
    assert set(port_names) == set(jax_names)
    for k, v in jax_names.items():
        assert (port_names[k] is None) == (v is None), k
    assert port_names["img_conv_group"] is None
    import paddle_tpu_torch as pt

    assert port_names["fc_layer"] is pt.layer.fc
    assert port_names["simple_lstm"] is pt.networks.simple_lstm
    # the mixed-layer family, the group and bidirectional RNNs and the
    # activations are the port's own objects now
    assert port_names["mixed_layer"] is pt.layer.mixed
    assert port_names["full_matrix_projection"] is \
        pt.layer.full_matrix_projection
    assert port_names["recurrent_layer"] is pt.layer.recurrent
    assert port_names["STanhActivation"] is pt.activation.STanh
    assert port_names["SqrtAvgPooling"] is pt.pooling.SqrtAvgPooling
    for name in ("bidirectional_lstm", "bidirectional_gru",
                 "lstmemory_group", "gru_group", "sequence_conv_pool",
                 "text_conv_pool"):
        assert port_names[name] is getattr(pt.networks, name), name
    # the remaining layers are ported: no stub is left
    for name in ("nce_layer", "ctc_layer", "warp_ctc_layer",
                 "block_expand_layer", "row_conv_layer", "tensor_layer",
                 "selective_fc_layer", "priorbox_layer",
                 "detection_output_layer", "multibox_loss_layer",
                 "multiplex_layer", "prelu_layer", "gated_unit_layer",
                 "out_prod_layer", "spp_layer", "maxout_layer", "pad_layer",
                 "crop_layer", "rotate_layer", "conv_shift_layer",
                 "bilinear_interp_layer", "hsigmoid"):
        assert port_names[name].__module__.startswith(
            "paddle_tpu_torch.layer."), name
    assert port_names["nce_layer"] is pt.layer.nce


# -- the CLI against JAX's ---------------------------------------------------

def _jax_checkpoint(conf, directory):
    """The config's initial parameters as a JAX checkpoint."""
    jax_reset_names()
    cfg = jcli._load_config(conf, "hidden_size=16")
    _, _, trainer = jcli._build(cfg)
    trainer.save_checkpoint(directory)
    return directory


def _pass_params(save_dir, pass_id):
    path = [os.path.join(save_dir, d) for d in sorted(os.listdir(save_dir))
            if d.startswith("pass-%05d-" % pass_id)][-1]
    params, _, _ = ckpt.load_checkpoint(path)
    return params


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_cli_train_equals_jax_cli(tmp_path, order, capsys):
    """Both CLIs train the v1 config for 2 passes from the same JAX
    checkpoint, in one process, in the order given: the same test cost and
    pass checkpoints (1e-5), each on its own shim; the port's run leaves
    the paddle* entries of sys.modules exactly as it found them."""
    conf, provider = _write_config(tmp_path, "cfg_" + order)
    init = _jax_checkpoint(conf, str(tmp_path / "init"))
    common = ["--config", conf, "--config-args", "hidden_size=16",
              "--init-model", init, "--num-passes", "2"]
    runs = {}

    def run_jax():
        jax_reset_names()
        assert jcli.main(["train", *common, "--save-dir",
                          str(tmp_path / "save_jax")]) == 0
        runs["jax"] = _test_cost(capsys.readouterr().out)
        assert sys.modules["paddle"].__file__.startswith(
            os.path.join(ROOT, "compat"))
        assert sys.modules[provider].provider.__module__ == \
            "paddle.trainer.PyDataProvider2"

    def run_port():
        before = _paddle_entries()
        assert cli.main(["train", *common, "--device", "cpu", "--save-dir",
                         str(tmp_path / "save_port")]) == 0
        runs["port"] = _test_cost(capsys.readouterr().out)
        after = _paddle_entries()
        assert after.keys() == before.keys()
        assert all(after[n] is before[n] for n in before)
        # the port's shim answered the config and its provider
        shim = cli.ConfigScope(conf)
        assert not shim.modules  # a fresh scope holds nothing
        assert cli.CONFIG_MODULE not in sys.modules

    for step in ((run_jax, run_port) if order == "jax_first"
                 else (run_port, run_jax)):
        step()
    assert abs(runs["port"] - runs["jax"]) < TOL
    for pass_id in (0, 1):
        want = _pass_params(str(tmp_path / "save_jax"), pass_id)
        got = _pass_params(str(tmp_path / "save_port"), pass_id)
        assert sorted(got.names()) == sorted(want.names())
        for n in want.names():
            np.testing.assert_allclose(np.asarray(got.get(n)),
                                       np.asarray(want.get(n)), rtol=TOL,
                                       atol=TOL, err_msg=n)


V1_SMALL = "dict_size=30,emb_size=8,hidden_size=4,depth=3,batch_size=8"


@pytest.mark.parametrize("name,args", [("dblstm", ""),
                                       ("bidi_lstm", "rnn=lstm"),
                                       ("bidi_gru", "rnn=gru")])
def test_v1_text_configs_train_like_the_jax_cli(tmp_path, capsys, name,
                                                args):
    """chip_smoke.py's v1_text configs (the quick_start db-lstm form: a
    mixed_layer over a full_matrix_projection and lstmemory layers of
    alternating direction; the bidirectional form with
    bidirectional_lstm or bidirectional_gru) at a small size, trained for
    2 passes by the port's and the JAX package's ``cli train`` from one
    JAX checkpoint on the same provider: the same test cost and pass
    checkpoints (1e-5)."""
    import chip_smoke

    d = tmp_path / name
    d.mkdir()
    module = "v1small_%s_provider" % name
    (d / (module + ".py")).write_text(chip_smoke.V1_PROVIDER_SRC)
    src = {run[0]: run[1] for run in chip_smoke.V1_TEXT_RUNS}[name]
    conf = str(d / "conf.py")
    with open(conf, "w") as fh:
        fh.write(src % {"module": module, "max_len": 9, "train": 24,
                        "test": 8, "seed": 7})
    args = ",".join(a for a in (args, V1_SMALL) if a)
    jax_reset_names()
    cfg = jcli._load_config(conf, args)
    _, _, trainer = jcli._build(cfg)
    init = str(tmp_path / "init")
    trainer.save_checkpoint(init)
    common = ["--config", conf, "--config-args", args, "--init-model", init,
              "--num-passes", "2"]
    jax_reset_names()
    assert jcli.main(["train", *common, "--save-dir",
                      str(tmp_path / "save_jax")]) == 0
    want = _test_cost(capsys.readouterr().out)
    assert cli.main(["train", *common, "--device", "cpu", "--save-dir",
                     str(tmp_path / "save_port")]) == 0
    got = _test_cost(capsys.readouterr().out)
    assert abs(got - want) < TOL
    for pass_id in (0, 1):
        jparams = _pass_params(str(tmp_path / "save_jax"), pass_id)
        params = _pass_params(str(tmp_path / "save_port"), pass_id)
        assert sorted(params.names()) == sorted(jparams.names())
        for n in jparams.names():
            np.testing.assert_allclose(np.asarray(params.get(n)),
                                       np.asarray(jparams.get(n)), rtol=TOL,
                                       atol=TOL, err_msg=n)


OCR_PROVIDER = '''
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def hook(settings, **kwargs):
    settings.input_types = [dense_vector(96), integer_value_sequence(6)]


@provider(init_hook=hook)
def process(settings, file_name):
    rng = np.random.RandomState(2 if file_name == "train" else 3)
    for _ in range(16 if file_name == "train" else 8):
        yield (rng.rand(96).astype(np.float32).tolist(),
               [int(x) for x in rng.randint(1, 6, rng.randint(1, 4))])
'''

OCR_CONFIG = '''
from paddle.trainer_config_helpers import *

define_py_data_sources2(train_list=["train"], test_list=["test"],
                        module="{provider}", obj="process")
settings(batch_size=8, learning_rate=1e-3, learning_method=AdamOptimizer())

img = data_layer(name="image", size=96, height=8, width=12)
conv = img_conv_layer(input=img, filter_size=3, num_filters=8,
                      num_channels=1, padding=1, act=TanhActivation())
columns = block_expand_layer(input=conv, block_x=1, block_y=8,
                             num_channels=8)
proj = fc_layer(input=columns, size=16, act=TanhActivation())
scores = fc_layer(input=proj, size=6, act=SoftmaxActivation())
lab = data_layer(name="label", size=6)
loss = warp_ctc_layer(input=scores, label=lab, size=6, blank=0,
                      norm_by_times=True)
outputs(loss)
'''


def test_v1_ocr_config_with_warp_ctc_and_block_expand_trains_like_jax(
        tmp_path, capsys):
    """A v1 OCR config (img_conv_layer, block_expand_layer into a
    12-step sequence of columns, fc_layer, warp_ctc_layer), built by the
    port's shim as by the JAX package's: ``python -m paddle_tpu_torch.cli
    train`` in a fresh process and the JAX package's ``cli train``, from
    one JAX checkpoint for 2 passes, give the same test cost and pass
    checkpoints (1e-5)."""
    import subprocess

    d = tmp_path / "ocr"
    d.mkdir()
    (d / "ocr_provider.py").write_text(OCR_PROVIDER)
    conf = str(d / "conf.py")
    (d / "conf.py").write_text(OCR_CONFIG.format(provider="ocr_provider"))
    jax_reset_names()
    cfg = jcli._load_config(conf, "")
    _, _, trainer = jcli._build(cfg)
    init = str(tmp_path / "init")
    trainer.save_checkpoint(init)
    common = ["--config", conf, "--init-model", init, "--num-passes", "2"]
    jax_reset_names()
    assert jcli.main(["train", *common, "--save-dir",
                      str(tmp_path / "save_jax")]) == 0
    want = _test_cost(capsys.readouterr().out)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "train", *common,
         "--device", "cpu", "--save-dir", str(tmp_path / "save_port")],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = _test_cost(proc.stdout)
    assert abs(got - want) < TOL
    for pass_id in (0, 1):
        jparams = _pass_params(str(tmp_path / "save_jax"), pass_id)
        params = _pass_params(str(tmp_path / "save_port"), pass_id)
        assert sorted(params.names()) == sorted(jparams.names())
        for n in jparams.names():
            np.testing.assert_allclose(np.asarray(params.get(n)),
                                       np.asarray(jparams.get(n)), rtol=TOL,
                                       atol=TOL, err_msg=n)


def test_config_scope_resolves_the_port_shim_lazily(tmp_path):
    """A config naming a provider absent when it runs: the reader, made
    later, imports it inside the config's scope, under the port's shim,
    and sys.modules is left as it was."""
    conf, provider = _write_config(tmp_path, "lazy")
    src = open(conf).read().replace('module="%s"' % provider,
                                    'module="late_%s"' % provider)
    open(conf, "w").write(src)
    before = _paddle_entries()
    reset_name_counters()
    cfg = cli._load_config(conf)
    os.rename(os.path.join(os.path.dirname(conf), provider + ".py"),
              os.path.join(os.path.dirname(conf),
                           "late_%s.py" % provider))
    reader = cfg.train_reader()
    rows = list(reader())
    assert len(rows) == 24 and isinstance(rows[0][0], list)
    module = cfg.config_scope.modules["late_" + provider]
    assert module.provider.__module__ == "paddle.trainer.PyDataProvider2"
    assert cfg.config_scope.modules["paddle"].__file__.startswith(
        cli.COMPAT_DIR)
    assert _paddle_entries() == before
    assert "late_" + provider not in sys.modules


def test_cli_test_and_time(tmp_path, capsys):
    """``cli test --params`` scores the saved parameter tar as the
    trainer's own ``test`` on the same rows does; ``cli time`` prints a
    positive ms per batch over --iters batches."""
    from paddle_tpu_torch import minibatch

    conf, _ = _write_config(tmp_path, "cfg_test")
    save = str(tmp_path / "save")
    assert cli.main(["train", "--config", conf, "--device", "cpu",
                     "--save-dir", save]) == 0
    trained = _test_cost(capsys.readouterr().out)
    tar = os.path.join(save, sorted(os.listdir(save))[-1], "parameters.tar")
    assert cli.main(["test", "--config", conf, "--device", "cpu",
                     "--params", tar]) == 0
    scored = _test_cost(capsys.readouterr().out)
    # the trainer's own test over the same rows, from the same tar
    cfg = cli._load_config(conf)
    _, params, trainer = cli._build(cfg, "cpu")
    with open(tar, "rb") as f:
        params.init_from_tar(f)
    trainer.stage_parameters()
    own = trainer.test(minibatch.batch(cfg.test_reader(), 8)).cost
    assert abs(scored - own) < 1e-6 and abs(scored - trained) < 1e-6
    # without --params the test scores the initial parameters
    assert cli.main(["test", "--config", conf, "--device", "cpu"]) == 0
    assert abs(_test_cost(capsys.readouterr().out) - scored) > 1e-6
    assert cli.main(["time", "--config", conf, "--device", "cpu",
                     "--iters", "2"]) == 0
    timed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert timed["ms_per_batch"] > 0 and timed["batches"] == 2
    assert timed["batch_size"] == 8


@pytest.mark.parametrize("argv,match", [
    (["merge_model", "--params", "p.tar", "-o", "m.tar"], "not ported yet"),
    (["analyze", "--all"], "not ported yet"),
    (["cluster_train", "--num-processes", "2", "--devices-per-process",
      "2"], "not ported yet"),
    (["observe", ".", "--regress", "BASELINE.json"], "not ported yet")])
def test_unported_verbs_and_options_raise(tmp_path, argv, match):
    conf, _ = _write_config(tmp_path, "cfg_refuse")
    if argv[0] in ("train", "cluster_train"):
        argv = argv + ["--config", conf, "--device", "cpu"]
    with pytest.raises((NotImplementedError, EnforceError), match=match):
        cli.main(argv)


# -- serve: several models, fleets and their refusals -------------------------

@pytest.mark.parametrize("flag", ["--front", "--host-id", "--lease-ttl",
                                  "--rehome-retries"])
def test_cluster_flags_raise_by_name(flag, monkeypatch):
    """The name is kept from when the cluster flags were refused: each now
    parses as the JAX CLI's does, given and left at its default."""
    import paddle_tpu.cli as jcli

    value = {"--front": [], "--host-id": ["h1"], "--lease-ttl": ["5"],
             "--rehome-retries": ["1"]}[flag]
    seen = {}
    for name, module in (("port", cli), ("jax", jcli)):
        monkeypatch.setattr(module, "cmd_serve", lambda args, name=name:
                            seen.setdefault(name, []).append(vars(args)))
        module.main(["serve", "b", flag, *value])
        module.main(["serve", "b"])
    key = flag[2:].replace("-", "_")
    given, default = seen["port"]
    assert given[key] == seen["jax"][0][key] != default[key]
    assert default[key] == seen["jax"][1][key]
    assert default["join"] == seen["jax"][1]["join"] == ""


@pytest.fixture(scope="module")
def fleet_dirs(tmp_path_factory):
    """The small flagship, fp and int8, exported by both packages from the
    same numpy parameters: {kind: (port dir, JAX dir)}."""
    from tests.torch_fleet import FLAGSHIP, FLAGSHIP_BUILDER, export_both

    return {kind: export_both(tmp_path_factory.mktemp("cli_" + kind),
                              FLAGSHIP_BUILDER, FLAGSHIP,
                              quantize=None if kind == "fp" else "int8")
            for kind in ("fp", "int8")}


@pytest.mark.parametrize("extra,message", [
    (["--workers", "2", "--replicas", "2"], "mutually exclusive"),
    (["--workers", "2", "--session-store-addr", "127.0.0.1:9"],
     "cannot combine with --workers")])
def test_serve_refuses_conflicting_data_planes(fleet_dirs, capsys, extra,
                                               message):
    with pytest.raises(SystemExit) as exc_info:
        cli.main(["serve", fleet_dirs["fp"][0], "--device", "cpu", *extra])
    assert exc_info.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--model", "a=DIR", "--selfcheck"], "drop the positional"),
    (["--model", "noequals"], "NAME=DIR[:PRIORITY]"),
    ([], "a bundle directory or --model")])
def test_serve_argument_errors_exit_2(capsys, argv, message):
    assert cli.main(["serve", *argv]) == 2
    assert message in capsys.readouterr().err


def test_serve_models_behind_the_router_with_replicas(fleet_dirs):
    """``cli serve --model a=FP:high --model b=INT8:low --replicas 2`` in
    its own process: answers of both models against the JAX package's
    bundles of the same parameters, two replicas of each, the priorities,
    and SIGTERM exits 0."""
    import signal
    import subprocess
    import urllib.request

    from paddle_tpu.serve import load_bundle as jax_load
    from tests.torch_fleet import (FLAGSHIP_OUT, INT8_TOL, assert_close,
                                   flagship_request)

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
         "--model", "a=%s:high" % fleet_dirs["fp"][0],
         "--model", "b=%s:low" % fleet_dirs["int8"][0],
         "--replicas", "2", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        lines = []
        while not lines or "http://" not in lines[-1]:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
        base = "http://" + lines[-1].split("http://", 1)[1].split(" ", 1)[0]
        assert "['a', 'b']" in lines[-1]

        def get(path):
            return urllib.request.urlopen(base + path, timeout=60)

        import time

        deadline = time.monotonic() + 120
        while True:
            try:
                if get("/readyz").status == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.1)
        for name, kind, tol in (("a", "fp", None), ("b", "int8", INT8_TOL)):
            ref = jax_load(fleet_dirs[kind][1])
            for rows in (1, 3):
                req = flagship_request(rows, seed=80 + rows)
                body = json.dumps({"inputs": {
                    k: v.tolist() for k, v in req.items()}}).encode()
                resp = json.load(urllib.request.urlopen(
                    urllib.request.Request(
                        base + "/infer/" + name, data=body,
                        headers={"Content-Type": "application/json"}),
                    timeout=60))
                got = {FLAGSHIP_OUT: np.asarray(
                    resp["outputs"][FLAGSHIP_OUT], np.float32)}
                assert_close(got, {FLAGSHIP_OUT: np.asarray(
                    ref.infer(req)[FLAGSHIP_OUT])}, tol=tol)
        stats = json.load(get("/stats"))
        assert stats["priorities"] == {"a": "high", "b": "low"}
        assert stats["models"]["a"]["replicas"] == 2
        assert stats["models"]["b"]["replicas"] == 2
        metrics = get("/metrics").read().decode()
        assert 'model="b",replica="1"' in metrics
        assert json.load(get("/manifest/b"))["quantization"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
