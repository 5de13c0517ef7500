"""Shared rig of the decode-side parity tests (tests/test_torch_scheduler.py,
test_torch_sessions.py, test_torch_generate.py): the same numpy parameters
exported with ``decode_slots`` by both packages, at the small sizes of
tests/test_scheduler.py (tagger hidden 12, slots 2, window 4, seq_len 32).

Models are named by builder strings (``"module:function"``) and built by
``port_model`` (the port's output layer) and ``jax_model`` (the JAX
package's twin, by the same names); the test topologies the port has no
model for are builders here: ``lstm_tagger`` (a per-position LSTM head,
two carry leaves), ``reverse_gru_tagger`` (not streamable) and
``embedding_tagger`` (no carry).
"""

import json
import os

import numpy as np
import torch

GRU_BUILDER = "paddle_tpu_torch.models.text:sequence_tagging_gru"
LSTM_BUILDER = "tests.torch_decode:lstm_tagger"
SMALL = dict(dict_size=50, label_size=5, emb_size=8, hidden=12)
LM = dict(dict_size=16, label_size=16, emb_size=8, hidden=12)
SLOTS, WINDOW, SEQ_LEN = (2,), 4, 32
OUTPUT = {"gru": "gru_tag_out", "lstm": "lstm_tag_out"}
MODELS = {"gru": (GRU_BUILDER, SMALL), "lstm": (LSTM_BUILDER, SMALL),
          "lm": (GRU_BUILDER, LM)}


def _per_position(pkg, cell, dict_size, label_size, emb_size, hidden,
                  name, reverse=False, window=False):
    words = pkg.layer.data(
        name="word", type=pkg.data_type.integer_value_sequence(dict_size))
    t = pkg.layer.embedding(input=words, size=emb_size, name=name + "_emb")
    if window:  # a context window of 3 steps: it reads the next step
        t = pkg.layer.context_projection_layer(
            input=t, context_start=-1, context_len=3, name=name + "_ctx")
    if cell is not None:
        t = cell(input=t, size=hidden, name=name + "_rnn", reverse=reverse)
    return pkg.layer.fc(input=t, size=label_size,
                        act=pkg.activation.Softmax(), name=name + "_out")


def _port():
    import paddle_tpu_torch as pkg

    return pkg


def lstm_tagger(dict_size, label_size, emb_size, hidden):
    pkg = _port()
    return _per_position(pkg, pkg.networks.simple_lstm, dict_size,
                         label_size, emb_size, hidden, "lstm_tag")


def reverse_gru_tagger(dict_size, label_size, emb_size, hidden):
    pkg = _port()
    return _per_position(pkg, pkg.networks.simple_gru, dict_size,
                         label_size, emb_size, hidden, "rev_tag",
                         reverse=True)


def context_tagger(dict_size, label_size, emb_size, hidden):
    pkg = _port()
    return _per_position(pkg, pkg.networks.simple_gru, dict_size,
                         label_size, emb_size, hidden, "ctx_tag",
                         window=True)


def embedding_tagger(dict_size, label_size, emb_size, hidden):
    return _per_position(_port(), None, dict_size, label_size, emb_size,
                         hidden, "emb_tag")


def jax_model(builder, **kwargs):
    """The JAX package's output layer for a port builder string, built
    with fresh name counters."""
    import paddle_tpu as jpkg
    from paddle_tpu.graph import reset_name_counters
    from paddle_tpu.models import text, vision

    reset_name_counters()
    function = builder.partition(":")[2]
    if builder.startswith("tests.torch_decode:"):
        cell, reverse = {
            "lstm_tagger": (jpkg.networks.simple_lstm, False),
            "reverse_gru_tagger": (jpkg.networks.simple_gru, True),
            "context_tagger": (jpkg.networks.simple_gru, False),
            "embedding_tagger": (None, False)}[function]
        name = {"lstm_tagger": "lstm_tag", "reverse_gru_tagger": "rev_tag",
                "context_tagger": "ctx_tag",
                "embedding_tagger": "emb_tag"}[function]
        return _per_position(jpkg, cell, name=name, reverse=reverse,
                             window=function == "context_tagger", **kwargs)
    module = text if ".text:" in builder else vision
    return getattr(module, function)(**kwargs)


def port_model(builder, **kwargs):
    """The port's output layer for a builder string, built with fresh
    name counters."""
    import importlib

    from paddle_tpu_torch.graph import reset_name_counters

    module, _, function = builder.partition(":")
    reset_name_counters()
    return getattr(importlib.import_module(module), function)(**kwargs)


def port_topology(builder, **kwargs):
    from paddle_tpu_torch.topology import Topology

    return Topology(port_model(builder, **kwargs))


def numpy_params(specs, seed=0):
    """Weights N(0, 1/fan_in), biases N(0, 0.1^2), from a numpy seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = spec.shape
        scale = 0.1 if len(shape) < 2 else 1.0 / np.sqrt(shape[0])
        out[name] = (rng.randn(*shape) * scale).astype(np.float32)
    return out


def port_parameters(topology, arrays):
    """The numpy arrays as the port's Parameters (params_from_numpy checks
    every name and shape)."""
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parameters import Parameters

    return Parameters(params_from_numpy(arrays, topology, device="cpu"),
                      topology.param_specs())


def jax_parameters(jout, arrays):
    import jax.numpy as jnp

    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu.topology import Topology as JaxTopology

    jparams = JaxParameters()
    jparams._specs = JaxTopology(jout).param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jparams


def export_pair(tmp, builder, kwargs, seed=7, quantize=None, slots=SLOTS,
                window=WINDOW, seq_len=SEQ_LEN):
    """The same numpy parameters exported with a decoder by both packages.
    Returns (port manifest, port dir, JAX manifest, JAX dir)."""
    from paddle_tpu.serve.export import export_bundle as jax_export
    from paddle_tpu_torch.serve.export import export_bundle

    topology = port_topology(builder, **kwargs)
    arrays = numpy_params(topology.param_specs(), seed)
    jout = jax_model(builder, **kwargs)
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    manifest = export_bundle(topology.outputs,
                             port_parameters(topology, arrays), port_dir,
                             batch_sizes=(1,), seq_len=seq_len,
                             decode_slots=slots, decode_window=window,
                             quantize=quantize)
    jmanifest = jax_export(jout, jax_parameters(jout, arrays), jax_dir,
                           batch_sizes=(1,), seq_len=seq_len,
                           decode_slots=slots, decode_window=window,
                           quantize=quantize)
    return manifest, port_dir, jmanifest, jax_dir


def load_pair(tmp, model, quantize=None, **kw):
    """(port bundle on the CPU, JAX bundle) of ``MODELS[model]``."""
    from paddle_tpu.serve import load_bundle as jax_load
    from paddle_tpu_torch.serve import load_bundle

    builder, kwargs = MODELS[model]
    _, port_dir, _, jax_dir = export_pair(tmp, builder, kwargs,
                                          quantize=quantize, **kw)
    return load_bundle(port_dir, device="cpu"), jax_load(jax_dir)


def sequences(lengths, vocab=50, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n in lengths]


def per_request(bundle, seq, output):
    """The whole-request answer of either package's bundle for one
    sequence: padded to seq_len, the batch bucket, the valid prefix."""
    ids = np.zeros((1, bundle.seq_len), np.int32)
    ids[0, :len(seq)] = seq
    out = bundle.infer({"word": ids,
                        "word:lens": np.array([len(seq)], np.int32)})
    return np.asarray(out[output])[0, :len(seq)]


def as_numpy(tree):
    """{layer: [leaf, ...]} of either package's tensors as numpy."""
    return {k: [np.asarray(leaf.numpy() if torch.is_tensor(leaf) else leaf)
                for leaf in v] for k, v in tree.items()}


def schema_valid(records):
    """Every step-log record of a known type with its required fields and
    no field tests/golden/steplog_schema.json does not declare (the meta
    line's extras are outside the contract)."""
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "steplog_schema.json")) as fh:
        schema = json.load(fh)
    for rec in records:
        spec = schema["record_types"][rec["type"]]
        keys = set(rec)
        assert not set(spec["required"]) - keys, rec
        if rec["type"] != "meta":
            assert not keys - set(spec["required"]) - set(spec["optional"]), \
                rec


def read_records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
