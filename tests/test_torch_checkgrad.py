"""The port's gradient check (``paddle_tpu_torch/checkgrad.py``) and ``cli
checkgrad``, against the JAX package's (tests/gradcheck.py,
tests/test_layer_grad.py, tests/test_cli.py::test_cli_checkgrad_job).

- ``check_layer_grad`` passes on the layers of this slice and the
  recurrent ones in float64 (central differences against autograd,
  rtol 2e-3, 5e-3 for the recurrent layers as in the JAX suite), where
  the recurrent layers take their step loops and no kernel wrapper runs;
- it fails on a layer whose gradient is wrong;
- ``cli checkgrad`` prints ``checkgrad PASSED`` on the same configs in
  both packages: a v2-style config, and the v1 LSTM config of
  tests/test_torch_cli.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch import layer as L
from paddle_tpu_torch.checkgrad import check_layer_grad, to_f64
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.ops import rnn as rnn_ops

from tests.test_torch_cli import _write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3


def _seq(name, dim, lengths=(3, 5, 2), seed=0):
    rng = np.random.RandomState(seed)
    return {name: SequenceBatch.from_sequences(
        [rng.randn(n, dim) for n in lengths], max_len=8)}


def _dense(name, dim, seed=0):
    return {name: torch.from_numpy(np.random.RandomState(seed).randn(B, dim))}


def _data(name, dim, seq=False):
    dt = paddle.data_type
    return L.data(name=name, type=(dt.dense_vector_sequence(dim) if seq
                                   else dt.dense_vector(dim)))


def _lstm():
    return L.lstmemory(input=L.fc(input=_data("xs", 4, True), size=12,
                                  bias_attr=False), size=3), _seq("xs", 4)


def _lstm_reverse():
    return L.lstmemory(input=L.fc(input=_data("xs", 4, True), size=12,
                                  bias_attr=False), size=3,
                       reverse=True), _seq("xs", 4)


def _gru():
    return L.grumemory(input=L.fc(input=_data("xs", 4, True), size=9,
                                  bias_attr=False), size=3), _seq("xs", 4)


def _recurrent():
    return L.recurrent(input=_data("xs", 5, True)), _seq("xs", 5)


def _seq_ops():
    a, b = _data("a", 3, True), _data("b", 3, True)
    cat = L.seq_concat(a=L.fc(input=a, size=4), b=L.fc(input=b, size=4))
    return L.seq_reshape(input=cat, reshape_size=2), {
        **_seq("a", 3, seed=1), **_seq("b", 3, (1, 2, 4), seed=2)}


def _strided():
    return L.pooling(input=L.fc(input=_data("xs", 3, True), size=4),
                     stride=2, pooling_type=paddle.pooling.AvgPooling()), \
        _seq("xs", 3)


def _nested_group():
    x = L.data(name="nx", type=paddle.data_type.dense_vector_sub_sequence(3))

    def step(sub):
        mem = L.memory(name="acc", size=3)
        h = L.lstmemory(input=L.fc(input=sub, size=12, bias_attr=False),
                        size=3, name="sub_lstm")
        return L.addto(input=[L.last_seq(input=h), mem], name="acc")

    rng = np.random.RandomState(3)
    nested = [[rng.randn(n, 3) for n in subs]
              for subs in ([2, 3], [1], [3, 0, 2])]
    return L.recurrent_group(step=step, input=L.SubsequenceInput(x)), {
        "nx": NestedSequenceBatch.from_nested(nested, max_len=4)}


def _lstm_step_group():
    def step(x_t):
        h_mem = L.memory(name="cell_h", size=3)
        c_mem = L.memory(name="cell_c", size=3)
        gates = L.fc(input=[x_t, h_mem], size=12)
        h = L.lstm_step(input=gates, state=c_mem, size=3, name="cell_h")
        L.get_output(input=h, arg_name="state", name="cell_c")
        return h

    return L.recurrent_group(step=step, input=_data("xs", 4, True)), \
        _seq("xs", 4)


CASES = {"lstm": (_lstm, 5e-3), "lstm_reverse": (_lstm_reverse, 5e-3),
         "gru": (_gru, 5e-3), "recurrent": (_recurrent, 5e-3),
         "seq_concat_reshape": (_seq_ops, 2e-3),
         "strided_pooling": (_strided, 2e-3),
         "nested_group": (_nested_group, 5e-3),
         "lstm_step_group": (_lstm_step_group, 5e-3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_layer_grad_passes_in_float64(monkeypatch, case):
    """Each layer passes; the recurrent ones take their step loops in
    float64, so a kernel wrapper called here would fail the test."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran in float64")

    monkeypatch.setattr(rnn_ops, "lstm_seq", no_kernel)
    monkeypatch.setattr(rnn_ops, "gru_seq", no_kernel)
    reset_name_counters()
    build, rtol = CASES[case]
    out, feed = build()
    assert check_layer_grad(out, feed, rtol=rtol, device="cpu")


def test_check_layer_grad_checks_dense_inputs():
    reset_name_counters()
    x = _data("x", 4)
    out = L.fc(input=[x, L.fc(input=x, size=3)], size=2,
               act=paddle.activation.Tanh())
    assert check_layer_grad(out, _dense("x", 4), check_inputs=True,
                            device="cpu")


def test_check_layer_grad_fails_on_a_wrong_gradient(monkeypatch):
    """A recurrence whose carry is cut from autograd (a detach) has a
    wrong analytic gradient: the check must fail on it."""
    step = rnn_ops.rnn_step
    monkeypatch.setattr(rnn_ops, "rnn_step", lambda carry, *a: step(
        carry.detach(), *a))
    reset_name_counters()
    out, feed = _recurrent()
    with pytest.raises(AssertionError, match="grad mismatch"):
        check_layer_grad(out, feed, rtol=5e-3, device="cpu")


def test_to_f64_keeps_integers():
    feed = to_f64({"ids": torch.tensor([1, 2], dtype=torch.int32),
                   "x": SequenceBatch(torch.ones(1, 2, 2),
                                      torch.tensor([2]))})
    assert feed["ids"].dtype == torch.int32
    assert feed["x"].data.dtype == torch.float64
    assert feed["x"].lengths.dtype == torch.int64


CONFIG = '''
import numpy as np
import {pkg} as paddle
from {pkg} import layer as L, data_type as dt, activation as A

batch_size = 16

def cost():
    x = L.data(name="x", type=dt.dense_vector(6))
    y = L.data(name="y", type=dt.integer_value(3))
    h = L.fc(input=x, size=12, act=A.Tanh())
    out = L.fc(input=h, size=3)
    return L.classification_cost(input=out, label=y)

def train_reader():
    def reader():
        rng = np.random.RandomState(0)
        W = rng.randn(6, 3)
        for _ in range(128):
            x = rng.randn(6).astype(np.float32)
            yield x, int(np.argmax(x @ W))
    return reader
'''


def _jax_cli(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               PADDLE_TPU_LOG_LEVEL="WARNING", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "paddle_tpu.cli"] + args,
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_cli_checkgrad_passes_in_both_packages(tmp_path, capsys):
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        (tmp_path / (pkg + ".py")).write_text(CONFIG.format(pkg=pkg))
    proc = _jax_cli(["checkgrad", "--config",
                     str(tmp_path / "paddle_tpu.py")])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "checkgrad PASSED" in proc.stdout
    assert cli.main(["checkgrad", "--config",
                     str(tmp_path / "paddle_tpu_torch.py"),
                     "--device", "cpu"]) == 0
    assert "checkgrad PASSED" in capsys.readouterr().out


def test_cli_checkgrad_on_the_v1_lstm_config(tmp_path, capsys):
    conf, _ = _write_config(tmp_path, "cfg_checkgrad")
    assert cli.main(["checkgrad", "--config", conf, "--config-args",
                     "hidden_size=4,lstm_num=1,batch_size=3",
                     "--device", "cpu"]) == 0
    assert "checkgrad PASSED" in capsys.readouterr().out
