"""Streaming generation over a bundle's decode step: feed y_t back as
x_{t+1} (paddle_tpu/serve/generate.py).

A small host-side loop runs the bundle's decode step
(``export_bundle(decode_slots=...)``) one window at a time, picks the next
token from the last emitted distribution and feeds it straight back as the
next input; the carry threads across windows on the device, and only the
one distribution a window comes back to the host.

Generation needs exactly one ``seq_index`` input (sampled token ids must
be feedable) and one per-timestep output whose class dimension equals the
input vocabulary, a next-token head; anything else is refused up front
with the reason. ``temperature`` 0 (default) is greedy argmax; above 0 it
samples from the sharpened or flattened distribution with a fixed seed
(``_pick``, numpy on the host, as in the JAX package).
``paddle_tpu_torch.cli generate <bundle> --prime 5,17,3 --steps 32`` is
the command-line surface.
"""

import numpy as np

from paddle_tpu_torch.serve.bundle import SEQ_KINDS


def _pick(dist, temperature, rng):
    """Next token id from one output distribution: greedy argmax at
    temperature 0, else a sample from p ** (1/T) renormalized (computed
    in log space so tiny probabilities survive the sharpening)."""
    p = np.asarray(dist, np.float64).reshape(-1)
    if temperature <= 0.0:
        return int(p.argmax())
    logp = np.log(np.maximum(p, 1e-30)) / float(temperature)
    logp -= logp.max()
    q = np.exp(logp)
    q /= q.sum()
    return int(rng.choice(len(q), p=q))


def generate(bundle, prime, steps, slots=None, temperature=0.0, seed=0):
    """Generate ``steps`` tokens after ``prime`` (a list of token ids)
    by looping the bundle's decode step host-side, feeding each sampled
    y_t back as x_{t+1}. Returns ``{"prime", "generated", "steps",
    "vocab"}`` with plain-int token ids.

    ``bundle`` is a :class:`~paddle_tpu_torch.serve.bundle.Bundle`.
    ``slots`` picks the decode slot capacity (default: the largest
    exported); generation occupies slot 0 only — the other slots idle
    under the length mask, exactly like a lightly-loaded scheduler
    iteration.
    """
    if not bundle.has_decoder():
        raise ValueError(
            "bundle %r has no decode artifacts; re-export with "
            "decode_slots= to generate" % bundle.name)
    seq_specs = [s for s in bundle.inputs if s["kind"] in SEQ_KINDS]
    if len(seq_specs) != 1 or seq_specs[0]["kind"] != "seq_index":
        raise ValueError(
            "generation feeds sampled token ids back as the next input: "
            "the bundle needs exactly ONE seq_index input, got %s"
            % [(s["name"], s["kind"]) for s in seq_specs])
    if len(bundle.outputs) != 1:
        raise ValueError(
            "generation needs exactly one output head to sample from, "
            "got %s" % [o["name"] for o in bundle.outputs])
    spec, out_spec = seq_specs[0], bundle.outputs[0]
    vocab = int(spec["dim"])
    suffix = out_spec.get("shape_suffix") or []
    out_dim = int(suffix[-1]) if suffix else 0
    if out_dim != vocab:
        raise ValueError(
            "output %r distributes over %d classes but input %r has a "
            "%d-id vocabulary — y_t cannot feed back as x_{t+1}; "
            "generation needs a next-token head (label space == input "
            "vocabulary)" % (out_spec["name"], out_dim, spec["name"],
                             vocab))
    prime = np.asarray(prime, np.int32).reshape(-1)
    if prime.size < 1:
        raise ValueError("prime must carry at least one token id")
    if prime.min() < 0 or prime.max() >= vocab:
        raise ValueError(
            "prime ids must be in [0, vocab=%d), got [%d, %d]"
            % (vocab, int(prime.min()), int(prime.max())))
    steps = int(steps)
    if steps < 0:
        raise ValueError("steps must be >= 0, got %d" % steps)

    slot_count = int(bundle._decode_bucket(slots)["slots"])
    window = int(bundle.decode_window)
    name, out_name = spec["name"], out_spec["name"]
    rng = np.random.RandomState(seed)

    def dispatch(tokens, reset, carry):
        """One decode window over slot 0: ``tokens`` (1..window ids) in,
        (carry', per-token distributions) out."""
        flat = bundle.dummy_decode_flat(slot_count, window)
        k = len(tokens)
        flat[name][0, :k] = tokens
        flat["lens"][0] = k
        if reset:
            flat["reset"][0] = 1.0
        carry, outs = bundle.decode_step(carry, flat, slot_count)
        return carry, outs[out_name][0, :k].float().cpu().numpy()

    carry = bundle.zero_carry(slot_count)
    dist = None
    first = True
    # prime the carry window-by-window; the LAST distribution seeds the
    # autoregressive loop
    for pos in range(0, int(prime.size), window):
        carry, ys = dispatch(prime[pos:pos + window], first, carry)
        first = False
        dist = ys[-1]
    generated = []
    for k in range(steps):
        token = _pick(dist, temperature, rng)
        generated.append(token)
        if k + 1 < steps:  # the final token needs no further dispatch
            carry, ys = dispatch(np.asarray([token], np.int32), False,
                                 carry)
            dist = ys[-1]
    return {"prime": [int(t) for t in prime], "generated": generated,
            "steps": steps, "vocab": vocab}
