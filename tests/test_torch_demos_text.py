"""The text demos that the mixed-layer family brings onto the port run
unchanged on it, on the CPU: quick_start ``--model lr`` (a sparse bag of
words into the sparse fc) and ``--model cnn`` (a context window), and
sequence_tagging ``--model linear_crf`` (a context window into a CRF) and
``--model rnn_crf`` (a forward and a reversed LSTM into a CRF):

* each through the runner's entry point (``paddle_tpu_torch.demo.main``
  with ``<script> --quick ... --cpu``, what ``python -m
  paddle_tpu_torch.demo`` calls), the four one after another in one
  subprocess (a process start and its imports cost more than a quick
  run), with the lines tests/test_demos.py asserts of the JAX run;
* one step of each demo's model in both packages, the demo's own
  ``build`` through each package's binding, the same numpy parameters and
  the first minibatch of the port's dataset: the cost within 1e-5
  relative and every gradient within 1e-4 of its largest entry, as
  tests/test_torch_demos.py holds the others.

These live apart from tests/test_torch_demos.py so that the two files'
subprocess runs go to different workers.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_demos import (DEMOS, ROOT, SUBPROCESS_ENV, _both_built,
                              _first, _step_both)

RUNS = {
    "quick_start_lr": ("quick_start/train.py", ["--quick", "--model", "lr"],
                       ("test error", "sample 0:")),
    "quick_start_cnn": ("quick_start/train.py",
                        ["--quick", "--model", "cnn"],
                        ("test error", "sample 0:")),
    "sequence_tagging_linear_crf": ("sequence_tagging/train.py",
                                    ["--quick", "--model", "linear_crf"],
                                    ("token error",)),
    "sequence_tagging_rnn_crf": ("sequence_tagging/train.py",
                                 ["--quick", "--model", "rnn_crf"],
                                 ("token error",)),
}


RUNNER = r"""
import contextlib, io, json, sys, traceback
from paddle_tpu_torch import demo
out = {}
for name, path, args in json.loads(sys.argv[1]):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = demo.main([path] + args + ["--cpu"])
        error = None if rc == 0 else "exit status %r" % rc
    except (Exception, SystemExit):  # a demo's own exit is a failure too
        error = traceback.format_exc()
    out[name] = {"stdout": buf.getvalue(), "error": error}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def demo_runs():
    """{name: {"stdout", "error"}} of the four demo runs, made once."""
    runs = [(name, os.path.join(DEMOS, script), args)
            for name, (script, args, _) in sorted(RUNS.items())]
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(runs)],
                          capture_output=True, text=True, timeout=900,
                          cwd=ROOT, env=SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_text_demo_runs_unchanged_on_the_port(demo_runs, name):
    _, _, lines = RUNS[name]
    run = demo_runs[name]
    assert run["error"] is None, run["error"][-3000:]
    for line in lines:
        assert line in run["stdout"], (line, run["stdout"][-2000:])
    assert "nan" not in run["stdout"].lower(), run["stdout"][-2000:]


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_quick_start_step_matches_jax(model):
    jbuilt, built, mod = _both_built("quick_start/train.py",
                                     lambda m: m.build(model, 5000))
    rows = _first(mod.imdb.train(mod.imdb.word_dict(5000)), 4)
    if model == "lr":
        rows = [mod.to_bow(5000)(r) for r in rows]
    _step_both(jbuilt[2], built[2], rows)


@pytest.mark.parametrize("model", ["linear_crf", "rnn_crf"])
def test_sequence_tagging_step_matches_jax(model):
    def build(m):
        word_dict, _, label_dict = m.conll05.get_dict()
        return m.build(model, len(word_dict), len(label_dict))

    jbuilt, built, mod = _both_built("sequence_tagging/train.py", build)
    _step_both(jbuilt[2], built[2], _first(mod.conll05.train(), 4))
