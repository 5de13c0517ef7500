"""The flagship text classifier in both packages: the same numpy
parameters carried into the port by ``params_from_numpy``, the same feed,
class probabilities within 1e-5 (float32, CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import text_classification_lstm as jax_model
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.error import EnforceError

SMALL = dict(dict_size=50, emb_size=16, hidden=32, num_classes=2,
             num_layers=2)


def _both(**kw):
    cfg = dict(SMALL, **kw)
    jax_reset_names()
    jax_out = jax_model(**cfg)
    reset_name_counters()
    out = text_classification_lstm(**cfg)
    return (JaxTopology(jax_out), jax_out), (Topology(out), out)


def _numpy_params(specs, seed=0):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(specs.items())}


def _feed(seed=0, rows=5, t=9):
    rng = np.random.RandomState(seed)
    # ids past the vocabulary clip to its last row, as in the JAX layer
    ids = rng.randint(0, 60, (rows, t)).astype(np.int32)
    lens = np.array([t, 0, 1, 4, 7][:rows], np.int32)
    return ids, lens


@pytest.mark.parametrize("num_layers", [1, 2])
def test_flagship_forward_matches_jax(num_layers):
    (jtopo, jout), (topo, out) = _both(num_layers=num_layers)
    jspecs, specs = jtopo.param_specs(), topo.param_specs()
    assert sorted(jspecs) == sorted(specs)
    assert all(jspecs[k].shape == specs[k].shape for k in specs)
    np_params = _numpy_params(specs)
    ids, lens = _feed()
    want = jtopo.apply({k: jnp.asarray(v) for k, v in np_params.items()},
                       {"word": JaxSequenceBatch(jnp.asarray(ids),
                                                 jnp.asarray(lens))},
                       mode="test")[0][jout.name]
    params = params_from_numpy(np_params, topo, device="cpu")
    got = topo.apply(params, {"word": SequenceBatch(
        torch.from_numpy(ids), torch.from_numpy(lens))},
        mode="test")[0][out.name]
    assert got.shape == (5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flagship_names_match_the_jax_builder():
    (jtopo, jout), (topo, out) = _both()
    assert [n.name for n in topo.nodes] == [n.name for n in jtopo.nodes]
    assert out.name == jout.name == "lstm_out"
    assert topo.param_specs()["lstm0.wbias"].shape == (7 * 32,)
    assert topo.param_specs()["lstm0.w0"].shape == (32, 4 * 32)


def test_params_from_numpy_refuses_name_or_shape_differences():
    _, (topo, _) = _both()
    np_params = _numpy_params(topo.param_specs())
    extra = dict(np_params, stray=np.zeros(3, np.float32))
    with pytest.raises(EnforceError, match="unexpected"):
        params_from_numpy(extra, topo, device="cpu")
    missing = dict(np_params)
    del missing["lstm1.w0"]
    with pytest.raises(EnforceError, match="missing"):
        params_from_numpy(missing, topo, device="cpu")
    wrong = dict(np_params, **{"lstm_out.w0": np.zeros((2, 32), np.float32)})
    with pytest.raises(EnforceError, match="shape"):
        params_from_numpy(wrong, topo, device="cpu")


def test_jax_parameters_npz_round_trips_into_the_port(tmp_path):
    """A JAX ``Parameters.to_npz`` payload loads into the port and gives the
    same probabilities through the port's ``infer``."""
    import jax

    from paddle_tpu.inference import infer as jax_infer
    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu_torch.inference import infer

    (jtopo, jout), (topo, out) = _both()
    jparams = JaxParameters()
    jparams._specs = jtopo.param_specs()
    jparams._values = jtopo.init_params(jax.random.PRNGKey(3))
    path = tmp_path / "params.npz"
    with open(path, "wb") as fh:
        jparams.to_npz(fh)
    params = Parameters.from_npz(str(path))
    batch = [([1, 4, 9, 2],), ([7],), ([3, 3, 3, 3, 3, 3],)]
    want = jax_infer(jout, jparams, batch)
    got = infer(out, params, batch, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seeded_init_is_deterministic_and_xavier_scaled():
    _, (topo, _) = _both()
    a = topo.init_params(seed=7, device="cpu")
    b = topo.init_params(seed=7, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["lstm0.wbias"].abs().max()) == 0.0
    std = float(a["lstm0_transform.w0"].std())
    assert 0.5 / np.sqrt(16) < std < 1.5 / np.sqrt(16)


def test_bf16_compute_policy_tracks_f32():
    """``set_mixed_precision("bfloat16")`` casts the float32 parameters and
    activations at the topology boundary; the kernel's plain version then
    runs in bfloat16 with c carried in float32, close to the f32 run."""
    from paddle_tpu_torch.core import dtype as dtype_mod

    _, (topo, out) = _both()
    params = params_from_numpy(_numpy_params(topo.param_specs()), topo,
                               device="cpu")
    ids, lens = _feed()
    feed = {"word": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    f32 = topo.apply(params, feed, mode="test")[0][out.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed, mode="test")[0][out.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert bf16.dtype == torch.bfloat16 and dtype_mod.compute_dtype() is None
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=3e-2)
