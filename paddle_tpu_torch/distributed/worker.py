"""Cluster worker: one rank of a multi-process data-parallel training job
(paddle_tpu/distributed/worker.py).

Reference role: the per-host trainer process the cluster launcher started
(paddle/scripts/cluster_train/paddle.py job_trainer, each host running
``paddle train`` with trainer_id/num_gradient_servers set). A worker:

1. joins the process group (distributed/multihost.py; gloo on the CPU and
   where ranks share a card, NCCL where each rank has its own card),
2. builds the config's topology and a DataParallel plan over the whole
   group times its ``--devices-per-process`` local replicas
   (parallel/mesh.py): gradients are summed over the replicas and then
   with all_reduce, with no parameter server,
3. runs the standard SGD loop; every rank reads the identical batch
   stream (same reader seed) and trains its share of each batch's rows,
4. prints its per-pass costs and a final ``CLUSTER_RESULT`` line, which
   the launcher collects.

Run as ``python -m paddle_tpu_torch.distributed.worker ...`` (the launcher
does). ``--use-tpu`` trains on the card, ``--no-use-tpu`` on the CPU;
neither: the card.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.worker")
    ap.add_argument("--config", required=True)
    ap.add_argument("--config-args", default="")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="host:port of the process group's store (rank 0 "
                         "hosts it)")
    ap.add_argument("--num-passes", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="local devices this worker drives, a replica "
                         "each (they share the cards where there are "
                         "fewer)")
    ap.add_argument("--use-tpu", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="train on the card (--no-use-tpu: the CPU)")
    ap.add_argument("--feed-pipeline", type=int, default=0,
                    help="pipelined input feed depth (data/feeder.py): this "
                         "rank's share of each batch is converted and "
                         "copied on a background thread; 0 = synchronous")
    ap.add_argument("--steps-per-call", type=int, default=0,
                    help="fuse K optimizer steps per captured CUDA graph "
                         "(NCCL only; 0 = one step per dispatch)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="durable training-state checkpoints "
                         "(distributed/checkpoint.py)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in global steps (0 = off)")
    ap.add_argument("--resume", nargs="?", const="exact", default=None,
                    choices=["exact", "pass"],
                    help="restore the newest valid checkpoint: bare "
                         "--resume continues the same trajectory at the "
                         "saved batch cursor (the same worker set came "
                         "back); '--resume pass' restarts the interrupted "
                         "pass from its first batch (a smaller group)")
    ap.add_argument("--task-coordinator", default="",
                    help="host:port of the task coordinator "
                         "(distributed/client.py): this worker holds a TTL "
                         "membership lease, renewed from the "
                         "coord-heartbeat thread")
    ap.add_argument("--lease-ttl", type=float, default=10.0)
    args = ap.parse_args(argv)

    # the training-fleet identity (observe/trainview.py), stamped before
    # any telemetry opens, so the steplog, the sentinel and the metric
    # labels name this worker
    os.environ["PADDLE_TPU_TORCH_TRAIN_WORKER"] = "trainer-%d" \
        % args.process_id

    import paddle_tpu_torch as paddle

    if args.use_tpu is not None:
        paddle.init(use_tpu=args.use_tpu)

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.multihost import initialize_multihost
    from paddle_tpu_torch.utils.error import enforce

    from paddle_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV

    k = args.devices_per_process
    enforce(k >= 1, "--devices-per-process %d: at least 1", k)
    # this process names k devices, as the JAX launcher's XLA_FLAGS give
    # each worker k (the backend's choice counts them)
    os.environ[VIRTUAL_DEVICES_ENV] = str(k)
    initialize_multihost(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)
    enforce(dist.is_initialized(), "torch.distributed initialization failed")

    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.cli import _build, _load_config
    from paddle_tpu_torch.parallel.mesh import (DataParallel, build_mesh,
                                                rank_devices)

    cfg = _load_config(args.config, args.config_args)
    # the mesh spans every rank's k replicas; the trainer broadcasts rank
    # 0's parameters when it is built
    mesh = build_mesh({"data": dist.get_world_size() * k},
                      devices=rank_devices())
    cost, params, trainer = _build(cfg, parallelism=DataParallel(mesh))

    # the config's batch_size wins, as in the train job (cmd_train)
    batch_size = getattr(cfg, "batch_size", None) or args.batch_size or 64
    reader = minibatch.batch(cfg.train_reader(), batch_size)
    costs = []
    heartbeat = None
    if args.task_coordinator:
        # the membership lease: how peers and the launcher learn that this
        # worker died (kill -9 included: the lease just lapses)
        from paddle_tpu_torch.distributed.elastic import HeartbeatThread

        heartbeat = HeartbeatThread(
            args.task_coordinator,
            "trainer-%d" % args.process_id, ttl=args.lease_ttl).start()

    def handler(e):
        if getattr(e, "cost", None) is not None:
            costs.append(float(e.cost))
            # self-lapse gate (elastic.SelfLeaseLost): once the lease
            # lapsed the launcher counts this worker dead
            if heartbeat is not None and heartbeat.lease_lapsed():
                from paddle_tpu_torch.distributed.elastic import \
                    SelfLeaseLost

                raise SelfLeaseLost(
                    "trainer-%d: own lease lapsed (no successful renewal "
                    "within ttl=%.1fs); exiting for the relaunch"
                    % (args.process_id, heartbeat.ttl))

    try:
        trainer.train(reader, num_passes=args.num_passes,
                      event_handler=handler,
                      feed_pipeline=args.feed_pipeline or False,
                      steps_per_call=args.steps_per_call or None,
                      checkpoint_dir=args.checkpoint_dir or None,
                      checkpoint_every=args.checkpoint_every,
                      resume={"exact": True, "pass": "pass"}.get(
                          args.resume, False))
    finally:
        if heartbeat is not None:
            heartbeat.stop()

    final = {"process_id": args.process_id,
             "processes": dist.get_world_size(),
             "global_devices": dist.get_world_size() * k,
             "backend": dist.get_backend(),
             "device": str(trainer.device),
             "first_cost": costs[0] if costs else None,
             "final_cost": costs[-1] if costs else None}
    print("CLUSTER_RESULT " + json.dumps(final), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
