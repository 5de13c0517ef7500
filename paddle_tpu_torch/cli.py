"""Command-line entry of the port (the export and serve commands of
paddle_tpu/cli.py):

    python -m paddle_tpu_torch.cli export \\
        --builder paddle_tpu_torch.models.text:text_classification_lstm \\
        --builder-kwargs '{"hidden": 256, "num_layers": 2}' \\
        [--params params.npz | --seed 0 [--device cpu]] [--quantize int8] \
        -o BUNDLE_DIR
    python -m paddle_tpu_torch.cli serve BUNDLE_DIR [--selfcheck] [--port N]

``--params`` takes an npz written by either package's
``Parameters.to_npz`` (a JAX bundle's params.npz included); without it the
parameters are initialised from ``--seed`` on the card (or ``--device
cpu``). ``--quantize int8`` writes a quantized bundle (serve/quantize.py),
which ``serve`` runs unchanged. ``serve`` runs on the card unless
``--device cpu``.
"""

import argparse
import json
import sys


def cmd_export(args):
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve.bundle import build_outputs
    from paddle_tpu_torch.serve.export import export_bundle, parse_builder
    from paddle_tpu_torch.topology import Topology

    builder = parse_builder(args.builder, json.loads(args.builder_kwargs))
    if args.params:
        params = Parameters.from_npz(args.params)
    else:
        params = Parameters.create(Topology(build_outputs(builder)),
                                   seed=args.seed,
                                   device=args.device or None)
    manifest = export_bundle(
        builder, params, args.output,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",") if b],
        seq_len=args.seq_len, name=args.name or None,
        quantize=args.quantize or None)
    summary = {"bundle": args.output, "name": manifest["name"],
               "buckets": [b["batch"] for b in manifest["buckets"]],
               "inputs": [i["name"] for i in manifest["inputs"]],
               "outputs": manifest["outputs"]}
    if manifest.get("quantization"):
        summary["quantization"] = manifest["quantization"]["scheme"]
    print(json.dumps(summary))
    return 0


def cmd_serve(args):
    from paddle_tpu_torch.serve.bundle import load_bundle
    from paddle_tpu_torch.serve.engine import InferenceEngine
    from paddle_tpu_torch.serve.server import make_server

    bundle = load_bundle(args.bundle, device=args.device or None)
    # selfcheck warms synchronously (it IS the warmth gate); serving warms
    # on a thread so /readyz honestly answers 503 until every bucket ran
    engine = InferenceEngine(bundle, max_batch_size=args.max_batch_size,
                             max_latency_ms=args.max_latency_ms,
                             warmup=True if args.selfcheck else "async")
    try:
        if args.selfcheck:
            out = engine.infer(bundle.dummy_inputs(rows=1), timeout=300.0)
            print(json.dumps({
                "ok": True, "bundle": bundle.name,
                "device": str(bundle.device),
                "buckets": bundle.batch_sizes(),
                "outputs": {k: list(v.shape) for k, v in out.items()},
                "stats": {k: v for k, v in engine.stats().items()
                          if isinstance(v, int)}}))
            return 0
        server = make_server(bundle, engine, host=args.host, port=args.port)
        print("serving %r on http://%s:%d (POST /infer; GET /healthz "
              "/readyz)" % (bundle.name, *server.server_address), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    finally:
        engine.stop()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("train", "test", "time"):
        # the JAX package's training commands read a trainer config
        raise NotImplementedError(
            "cli %s is not ported yet: it needs the trainer config "
            "(config.py); train from Python with trainer.SGD" % argv[0])
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("export", help="write a serving bundle")
    p.add_argument("--builder", required=True,
                   help="module.path:function returning the output layer")
    p.add_argument("--builder-kwargs", default="{}",
                   help="JSON object of keyword arguments for the builder")
    p.add_argument("--params", default="",
                   help="parameter npz (Parameters.to_npz of either package)")
    p.add_argument("--seed", type=int, default=0,
                   help="initialisation seed when --params is not given")
    p.add_argument("--device", default="",
                   help="torch device that initialises the parameters "
                        "(default: the card)")
    p.add_argument("-o", "--output", required=True,
                   help="bundle directory to write")
    p.add_argument("--batch-sizes", default="1,8,32",
                   help="comma-separated batch buckets")
    p.add_argument("--seq-len", type=int, default=None,
                   help="padded time dim for sequence inputs (default 64)")
    p.add_argument("--name", default="")
    p.add_argument("--quantize", default="", choices=("", "int8"),
                   help="weight-only quantization: int8 stores matmul/conv "
                        "weights per-output-channel symmetric int8 with "
                        "float32 scale sidecars (biases, norm and embedding "
                        "tables and recurrent cells stay fp)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve", help="serve a bundle over HTTP")
    p.add_argument("bundle")
    p.add_argument("--selfcheck", action="store_true",
                   help="load, warm, run one batch, exit (smoke gate)")
    p.add_argument("--device", default="",
                   help="torch device (default: the card)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8866)
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--max-latency-ms", type=float, default=5.0)
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
