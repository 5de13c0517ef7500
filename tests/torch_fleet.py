"""Shared rig of the serving-fleet tests (tests/test_torch_router.py,
test_torch_fleet.py, test_torch_workers.py, test_torch_remote_store.py):
the same numpy parameters exported by both packages at small sizes — the
flagship text classifier with 2 LSTM layers of hidden 32 (fp and int8),
the GRU tagger at hidden 32 with decode slots, and the mlp — plus the
request makers and the answer checks.

Tolerances: a port answer within ``rtol=1e-5, atol=1e-6`` of the JAX
bundle's (float32 sums in another order); int8 within the JAX package's
accuracy gate against the JAX int8 bundle (``INT8_TOL``); answers within
the port (fleet against one engine, migrated against uninterrupted)
bitwise.
"""

import numpy as np

from tests.torch_decode import (SMALL, export_pair, jax_parameters,
                                numpy_params, port_parameters)

FLAGSHIP = dict(dict_size=50, emb_size=16, hidden=32, num_classes=3,
                num_layers=2)
FLAGSHIP_BUILDER = "paddle_tpu_torch.models.text:text_classification_lstm"
MLP_BUILDER = "paddle_tpu_torch.models.vision:mlp"
MLP = dict(hidden=(16, 8))
TAGGER = dict(SMALL, hidden=32)
SEQ_LEN = 8
BUCKETS = (1, 4)
RTOL, ATOL = 1e-5, 1e-6
# int8 answers against the JAX int8 bundle of the same parameters: both
# dequantize the same int8 weights, so within 1e-5 (tighter than the JAX
# package's accuracy gate of int8 against fp, a drift of 0.05)
INT8_TOL = 1e-5
FLAGSHIP_OUT = "lstm_out"
TAGGER_OUT = "gru_tag_out"


def export_both(tmp, builder, kwargs, quantize=None, seed=21,
                batch_sizes=BUCKETS, seq_len=SEQ_LEN, decode=False):
    """``builder`` exported by both packages from the same numpy
    parameters; returns (port dir, JAX dir)."""
    from paddle_tpu.serve.export import export_bundle as jax_export
    from paddle_tpu_torch.serve.export import export_bundle
    from tests.torch_decode import jax_model, port_topology

    if decode:
        _, port_dir, _, jax_dir = export_pair(tmp, builder, kwargs,
                                              seed=seed, quantize=quantize)
        return port_dir, jax_dir
    topology = port_topology(builder, **kwargs)
    arrays = numpy_params(topology.param_specs(), seed)
    jout = jax_model(builder, **kwargs)
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    export_bundle(topology.outputs, port_parameters(topology, arrays),
                  port_dir, batch_sizes=batch_sizes, seq_len=seq_len,
                  quantize=quantize)
    jax_export(jout, jax_parameters(jout, arrays), jax_dir,
               batch_sizes=batch_sizes, seq_len=seq_len, quantize=quantize)
    return port_dir, jax_dir


def flagship_request(rows, seed=0):
    rng = np.random.RandomState(seed)
    return {"word": rng.randint(0, FLAGSHIP["dict_size"],
                                (rows, SEQ_LEN)).astype(np.int32),
            "word:lens": rng.randint(1, SEQ_LEN + 1, rows).astype(np.int32)}


def mlp_request(rows, seed=0):
    return {"pixel": np.random.RandomState(seed).randn(rows, 784)
            .astype(np.float32)}


def tagger_sequence(n, seed=0):
    return (np.random.RandomState(seed)
            .randint(0, TAGGER["dict_size"], size=(n,)).astype(np.int32))


def assert_close(got, want, tol=None):
    """Every output of ``got`` against ``want`` (RTOL/ATOL, or an absolute
    ``tol``)."""
    assert sorted(got) == sorted(want)
    for key in want:
        if tol is None:
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(want[key]), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(want[key]), atol=tol,
                                       err_msg=key)


def assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
