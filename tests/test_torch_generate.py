"""Streaming generation (``serve.generate``) and the decode CLI of the port
against the JAX package, on the CPU.

The next-token model is tests/test_generate.py's: the GRU tagger with its
label space equal to the input vocabulary (16), hidden 12, 2 slots,
window 4, seq_len 32, both packages exporting the same numpy parameters
(tests/torch_decode.py). Greedy and seeded sampled tokens equal JAX's
``generate``; the feedback chain (argmax of out[t] is token[t+1] from the
last prime position on) holds in the port bundle's whole-request forward
of the full sequence. The CLI: ``export --decode-slots``, ``serve
--continuous --selfcheck``, ``generate --json`` equal to the JAX CLI's
tokens, and the refusals.
"""

import json

import numpy as np
import pytest

from paddle_tpu_torch import cli
from paddle_tpu_torch.serve import generate
from tests.torch_decode import (GRU_BUILDER, LM, SMALL, export_pair,
                                load_pair)


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    return load_pair(tmp_path_factory.mktemp("lm_pair"), "lm")


def _feedback_chain(bundle, got):
    out_name = bundle.outputs[0]["name"]
    full = np.array(got["prime"] + got["generated"], np.int32)
    ids = np.zeros((1, bundle.seq_len), np.int32)
    ids[0, :len(full)] = full
    outs = bundle.infer({"word": ids,
                         "word:lens": np.array([len(full)], np.int32)})
    for i in range(len(got["prime"]) - 1, len(full) - 1):
        assert int(outs[out_name][0, i].argmax()) == int(full[i + 1]), i


@pytest.mark.parametrize("prime,steps", [([1, 2, 3], 8),
                                         ([3, 1, 4, 1, 5, 9, 2, 6, 5], 5),
                                         ([7], 1), ([4, 4], 0)])
def test_greedy_generation_matches_jax_and_its_chain(lm_pair, prime, steps):
    from paddle_tpu.serve import generate as jax_generate

    port, ref = lm_pair
    got = generate(port, prime, steps)
    assert got == jax_generate(ref, prime, steps)
    assert got["prime"] == prime and len(got["generated"]) == steps
    assert got["vocab"] == LM["dict_size"]
    assert generate(port, prime, steps) == got  # greedy is deterministic
    _feedback_chain(port, got)


@pytest.mark.parametrize("seed", [42, 43])
def test_sampled_generation_matches_jax(lm_pair, seed):
    from paddle_tpu.serve import generate as jax_generate

    port, ref = lm_pair
    got = generate(port, [2, 7], 10, temperature=0.8, seed=seed)
    assert got == jax_generate(ref, [2, 7], 10, temperature=0.8, seed=seed)
    assert got == generate(port, [2, 7], 10, temperature=0.8, seed=seed)


def test_generation_refuses_a_non_feedback_head(tmp_path):
    from paddle_tpu.serve import generate as jax_generate

    port, ref = load_pair(tmp_path, "gru")
    with pytest.raises(ValueError, match="next-token head") as port_exc:
        generate(port, [1, 2], 4)
    with pytest.raises(ValueError) as jax_exc:
        jax_generate(ref, [1, 2], 4)
    assert str(port_exc.value) == str(jax_exc.value)


@pytest.mark.parametrize("prime,steps,match", [
    ([], 4, "at least one token"), ([99], 4, "vocab"), ([1], -1, "steps")])
def test_generation_input_validation(lm_pair, prime, steps, match):
    from paddle_tpu.serve import generate as jax_generate

    port, ref = lm_pair
    with pytest.raises(ValueError, match=match) as port_exc:
        generate(port, prime, steps)
    with pytest.raises(ValueError) as jax_exc:
        jax_generate(ref, prime, steps)
    assert str(port_exc.value) == str(jax_exc.value)


def test_generation_needs_a_decoder(tmp_path):
    from paddle_tpu_torch.serve import export_bundle, load_bundle
    from tests.torch_decode import (numpy_params, port_parameters,
                                    port_topology)

    topo = port_topology(GRU_BUILDER, **LM)
    export_bundle(topo.outputs,
                  port_parameters(topo, numpy_params(topo.param_specs())),
                  str(tmp_path), batch_sizes=(1,), seq_len=8)
    with pytest.raises(ValueError, match="decode artifacts"):
        generate(load_bundle(str(tmp_path), device="cpu"), [1], 4)


def test_cli_generate_json_equals_the_jax_cli(tmp_path, capsys):
    from paddle_tpu import cli as jax_cli

    _, port_dir, _, jax_dir = export_pair(tmp_path, GRU_BUILDER, LM)
    argv = ["--prime", "1,2,3", "--steps", "6", "--temperature", "0.7",
            "--seed", "5"]
    assert cli.main(["generate", port_dir, *argv, "--json",
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["generate", jax_dir, *argv]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and len(got["generated"]) == 6


def test_cli_export_decode_slots_and_serve_continuous(tmp_path, capsys):
    out_dir = str(tmp_path / "bundle")
    assert cli.main(["export", "--builder", GRU_BUILDER,
                     "--builder-kwargs", json.dumps(SMALL),
                     "--device", "cpu", "--seq-len", "16",
                     "--batch-sizes", "1,4", "--decode-slots", "2,4",
                     "--decode-window", "3", "-o", out_dir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["decode_slots"] == [2, 4]
    assert summary["decode_window"] == 3
    assert cli.main(["serve", out_dir, "--continuous", "--selfcheck",
                     "--device", "cpu", "--session-store", "8",
                     "--idle-spill-ms", "5", "--session-slo-ms", "10",
                     "--session-ttl-ms", "1000"]) == 0
    check = json.loads(capsys.readouterr().out)
    assert check["ok"] and check["outputs"] == {"gru_tag_out": [16, 5]}
    assert check["stats"]["slots"] == 4 and check["stats"]["window"] == 3
    assert check["stats"]["requests"] == 1


def test_cli_continuous_refuses_a_bundle_without_decoder(tmp_path, capsys):
    out_dir = str(tmp_path / "plain")
    assert cli.main(["export", "--builder", GRU_BUILDER,
                     "--builder-kwargs", json.dumps(SMALL),
                     "--device", "cpu", "--seq-len", "8",
                     "--batch-sizes", "1", "-o", out_dir]) == 0
    capsys.readouterr()
    assert cli.main(["serve", out_dir, "--continuous", "--selfcheck",
                     "--device", "cpu"]) == 2
    assert ("--continuous: bundle 'gru_tag_out' has no decode artifacts; "
            "re-export with --decode-slots") in capsys.readouterr().err
