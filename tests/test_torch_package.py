"""Package-level contracts of the port: it imports neither JAX nor the JAX
package; its entry points run on the card unless told otherwise and never
move to the CPU on their own; on a CPU tensor the kernel wrapper runs its
plain version and launches nothing; the small copies it keeps agree with
the JAX package's originals."""

import ast
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.ops import lstm_kernels as lk
from paddle_tpu_torch.utils.error import EnforceError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))


def _port_sources():
    paths = [os.path.join(ROOT, name)
             for name in ("chip_smoke.py", "chip_kernel_probe.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "build")]
        paths += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append("%s imports %s" % (os.path.relpath(path, ROOT),
                                              mod))
    assert not bad, bad


@pytest.mark.parametrize("part", ["dataset", "reader", "image.py",
                                  "demo.py"])
def test_import_scan_covers_the_data_side_and_the_demo_runner(part):
    """The scan above reads every file of the data side and the demo
    runner (which names ``paddle_tpu`` only as a string, to bind it)."""
    sources = [os.path.relpath(p, PKG) for p in _port_sources()
               if p.startswith(PKG + os.sep)]
    hits = [p for p in sources if p == part or p.startswith(part + os.sep)]
    want = {"dataset": 14, "reader": 2}.get(part, 1)
    assert len(hits) == want, hits


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_no_card(monkeypatch,
                                                        tmp_path):
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.inference import Inference
    from paddle_tpu_torch.models.text import text_classification_lstm
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve import export_bundle, load_bundle
    from paddle_tpu_torch.serve.export import parse_builder
    from paddle_tpu_torch.topology import Topology

    builder = "paddle_tpu_torch.models.text:text_classification_lstm"
    kw = dict(dict_size=20, emb_size=8, hidden=8)
    out = text_classification_lstm(**kw)
    params = Parameters.create(Topology(out), device="cpu")
    export_bundle(parse_builder(builder, kw), params, str(tmp_path),
                  batch_sizes=(1,), seq_len=4)
    _no_card(monkeypatch)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: Topology(out).init_params(),
                 lambda: Inference(out, params),
                 lambda: load_bundle(str(tmp_path)),
                 lambda: cli.main(["export", "--builder", builder,
                                   "--builder-kwargs", json.dumps(kw),
                                   "-o", str(tmp_path / "cli")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert load_bundle(str(tmp_path), device="cpu").device.type == "cpu"
    # export writes files and runs nothing, so it needs no device at all
    manifest = export_bundle(parse_builder(builder, kw), params,
                             str(tmp_path / "again"), batch_sizes=(1,),
                             seq_len=4)
    assert manifest["outputs"][0]["shape_suffix"] == [2]


def _kernel_args(dtype=torch.float32, steps=5, batch=3, hidden=8):
    rng = np.random.RandomState(0)
    lens = np.array([steps, 0, 2])[:batch]
    return (torch.tensor(rng.randn(steps, batch, 4 * hidden), dtype=dtype),
            torch.tensor((np.arange(steps)[:, None] < lens[None, :]),
                         dtype=torch.float32),
            torch.tensor(rng.randn(hidden, 4 * hidden), dtype=dtype),
            torch.tensor(rng.randn(3, hidden), dtype=torch.float32),
            torch.tensor(rng.randn(batch, hidden), dtype=dtype),
            torch.tensor(rng.randn(batch, hidden), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing(dtype):
    args = _kernel_args(dtype)
    before = lk.launches
    h_seq, c_seq = lk.lstm_seq_fwd(*args)
    assert lk.launches == before
    h_ref, c_ref = lk.lstm_seq_fwd_reference(*args)
    assert h_seq.dtype == c_seq.dtype == dtype
    assert torch.equal(h_seq, h_ref) and torch.equal(c_seq, c_ref)


def test_scan_on_cpu_leaves_the_launch_count_alone():
    from paddle_tpu_torch.ops.rnn import lstm_scan

    gates, mask, w, _, _, _ = _kernel_args()
    before = lk.launches
    h_seq, _ = lstm_scan(gates.transpose(0, 1), mask.T, None, None, w)
    assert lk.launches == before and h_seq.shape == (3, 5, 8)


@pytest.mark.parametrize("index,bad,match", [
    (0, torch.zeros(5, 3, 30), "4H"),
    (2, torch.zeros(8, 16), "w_rec must be"),
    (1, torch.zeros(5, 3, dtype=torch.float64), "mask_tm must be"),
    (3, torch.zeros(3, 8, dtype=torch.bfloat16), "peep must be"),
    (0, torch.zeros(5, 3, 32, dtype=torch.float16), "float32 or bfloat16"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(index, bad, match):
    args = list(_kernel_args())
    args[index] = bad
    with pytest.raises(EnforceError, match=match):
        lk.lstm_seq_fwd(*args)


def test_reset_launches():
    lk.reset_launches()
    assert lk.launches == 0


@pytest.mark.parametrize("value", [1, 3, 8, 9, 32])
def test_bucket_index_matches_the_jax_rule(value):
    from paddle_tpu.data.bucketing import bucket_index as jax_bucket_index
    from paddle_tpu_torch.data.bucketing import bucket_index

    sizes = [1, 8, 32]
    assert bucket_index(value, sizes) == jax_bucket_index(value, sizes)


def test_bucket_index_refuses_oversized_values():
    from paddle_tpu_torch.data.bucketing import bucket_index

    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        bucket_index(33, [1, 8, 32])


def test_max_pooling_matches_jax_including_empty_sequences():
    import jax.numpy as jnp

    from paddle_tpu.pooling import MaxPooling as JaxMaxPooling
    from paddle_tpu_torch.pooling import MaxPooling

    rng = np.random.RandomState(0)
    data = rng.randn(3, 4, 5).astype(np.float32)
    mask = np.arange(4)[None, :] < np.array([4, 0, 2])[:, None]
    want = np.asarray(JaxMaxPooling().reduce(jnp.asarray(data),
                                             jnp.asarray(mask)))
    got = MaxPooling().reduce(torch.from_numpy(data), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1].any()  # the all-empty row pools to 0


def test_avg_pooling_matches_jax_including_empty_sequences():
    import jax.numpy as jnp

    from paddle_tpu.pooling import AvgPooling as JaxAvgPooling
    from paddle_tpu_torch.pooling import AvgPooling, to_pooling

    rng = np.random.RandomState(1)
    data = rng.randn(3, 4, 5).astype(np.float32)
    mask = np.arange(4)[None, :] < np.array([4, 0, 3])[:, None]
    want = np.asarray(JaxAvgPooling().reduce(jnp.asarray(data),
                                             jnp.asarray(mask)))
    got = to_pooling(AvgPooling).reduce(torch.from_numpy(data),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[1].any()  # the all-empty row pools to 0


def test_embedding_clips_ids_like_jax():
    from paddle_tpu_torch import data_type, layer
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.graph import Context

    words = layer.data(name="w", type=data_type.integer_value_sequence(4))
    emb = layer.embedding(input=words, size=2, name="e")
    table = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    ids = SequenceBatch(torch.tensor([[-3, 1, 9]]), torch.tensor([3]))
    out = emb.forward({"e.w0": table}, [ids], Context())
    np.testing.assert_array_equal(out.data[0].numpy(),
                                  [[0, 1], [2, 3], [6, 7]])


def test_import_scan_covers_the_conv_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("ops/conv_kernels.py", "ops/conv.py", "layer/conv.py",
                "models/vision.py"):
        assert os.path.join("paddle_tpu_torch", mod) in names


def test_import_scan_covers_the_int8_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("ops/int8_kernels.py", "serve/quantize.py"):
        assert os.path.join("paddle_tpu_torch", mod) in names


def _conv_args(dtype=torch.float32, k=3, c=8, f=16):
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(2, 5, 7, c), dtype=dtype)
    w = torch.tensor(rng.randn(k, k, c, f) / np.sqrt(k * k * c), dtype=dtype)
    dy = torch.tensor(rng.randn(2, 5, 7, f), dtype=dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_wrappers_on_cpu_run_plain_versions_and_count_nothing(dtype):
    from paddle_tpu_torch.ops import conv_kernels as ck

    x, w, dy = _conv_args(dtype)
    before = (ck.launches, ck.bwdw_launches)
    assert torch.equal(ck.conv2d_same_fwd(x, w),
                       ck.conv2d_same_reference(x, w))
    assert torch.equal(ck.conv2d_same_bwd_filter(x, dy, 3),
                       ck.conv2d_same_bwd_filter_reference(x, dy, 3))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ck.conv_same(xg, wg).float() * dy.float()).sum().backward()
    assert xg.grad.dtype == wg.grad.dtype == dtype
    assert (ck.launches, ck.bwdw_launches) == before
    assert ck.conv2d_same_fwd(x, w).dtype == dtype
    assert ck.conv2d_same_bwd_filter(x, dy, 3).dtype == torch.float32


@pytest.mark.parametrize("case,match", [
    ("float16", "float32 or bfloat16"),
    ("k2", "k in"),
    ("c12", "multiples of 8"),
    ("w_dtype", "w must be"),
    ("w_channels", "input channels"),
    ("x3d", r"\[N, H, W, C\]"),
])
def test_conv_wrappers_refuse_what_the_kernels_do_not_take(case, match):
    from paddle_tpu_torch.ops import conv_kernels as ck

    x, w, _ = _conv_args()
    if case == "float16":
        x, w = x.half(), w.half()
    elif case == "k2":
        w = torch.zeros(2, 2, 8, 16)
    elif case == "c12":
        x, w = torch.zeros(2, 5, 7, 12), torch.zeros(3, 3, 12, 16)
    elif case == "w_dtype":
        w = w.bfloat16()
    elif case == "w_channels":
        w = torch.zeros(3, 3, 16, 16)
    elif case == "x3d":
        x = x[0]
    with pytest.raises(EnforceError, match=match):
        ck.conv2d_same_fwd(x, w)


@pytest.mark.parametrize("case,match", [
    ("dy_shape", "dy must be"),
    ("dy_dtype", "dy must be"),
    ("k5", "k in"),
])
def test_bwd_filter_wrapper_refuses_what_the_kernel_does_not_take(case,
                                                                   match):
    from paddle_tpu_torch.ops import conv_kernels as ck

    x, _, dy = _conv_args()
    k = 3
    if case == "dy_shape":
        dy = dy[:, :4]
    elif case == "dy_dtype":
        dy = dy.bfloat16()
    elif case == "k5":
        k = 5
    with pytest.raises(EnforceError, match=match):
        ck.conv2d_same_bwd_filter(x, dy, k)


def test_bwdw_split_keeps_blocks_and_positions_in_range():
    from paddle_tpu_torch.ops import conv_kernels as ck

    # ResNet-50's stage-2 3x3 at batch 64: 5 row tiles x 1 filter tile
    assert ck.bwdw_splits(64, 57, 57, 64, 64, 3) == 106
    # a small map: at least 256 positions per split
    assert ck.bwdw_splits(1, 8, 8, 512, 512, 3) == 1
    assert ck.bwdw_splits(64, 8, 8, 2048, 512, 1) == 5


def test_resnet_entry_points_without_device_raise_when_no_card(monkeypatch):
    from paddle_tpu_torch.models.vision import resnet
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    topo = Topology(resnet(depth=18, num_classes=10, im_size=32))
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Parameters.create(topo)
    params = Parameters.create(topo, device="cpu")
    assert params.get("res_stem_conv.w0").shape == (7, 7, 3, 64)
    assert np.all(params.get("res_stem_bn.moving_var") == 1.0)


def test_import_scan_covers_the_dropout_and_crf_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("ops/dropout.py", "ops/crf.py", "layer/extra.py"):
        assert os.path.join("paddle_tpu_torch", mod) in names


def test_trainer_of_a_dropout_model_needs_a_card(monkeypatch):
    """trainer.SGD's generator lives on its device: without a card and
    without device="cpu" the trainer raises; on the CPU its generator is
    a CPU one."""
    from paddle_tpu_torch import data_type, layer, optimizer, trainer
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    reset_name_counters()
    x = layer.data(name="x", type=data_type.dense_vector(4))
    h = layer.dropout(input=layer.fc(input=x, size=3), dropout_rate=0.5)
    cost = layer.classification_cost(
        input=h, label=layer.data(name="y", type=data_type.integer_value(3)))
    params = Parameters.create(Topology(cost), device="cpu")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.SGD(cost, params, optimizer.Momentum(learning_rate=0.1))
    sgd = trainer.SGD(cost, params, optimizer.Momentum(learning_rate=0.1),
                      device="cpu")
    assert sgd._generator.device.type == "cpu"
