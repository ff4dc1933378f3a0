#!/usr/bin/env python
"""Control-plane coordinator of a multi-process run
(``tnn_tpu.cli.dist_coordinator``; parity: examples/tcp_coordinator.cpp).

    python -m tnn_tpu_torch.cli.dist_coordinator --num-workers 2 \\
        --port 5555 --config '{"model_name": "flash_vit", "epochs": 2}'

Waits for the workers (``cli.dist_worker``, of either package: the wire
format is the JAX package's), deploys the config, starts profiling,
releases the "start" barrier, waits for the "done" barrier, collects the
workers' profiles onto one timeline (``--profile-out`` writes it as a
Chrome trace) and shuts everyone down. It moves no tensors.
"""
import argparse
import json

from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.distributed import Coordinator
from tnn_tpu_torch.utils.platform import apply_env_platform


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-workers", type=int, required=True)
    ap.add_argument("--port", type=int, default=5555)
    ap.add_argument("--bind", default="")
    ap.add_argument("--config", default="{}",
                    help="JSON string or @file.json to deploy to workers")
    ap.add_argument("--profile-out", default="",
                    help="write merged Chrome trace here at the end")
    args = ap.parse_args(argv)
    apply_env_platform()    # TNN_PLATFORM=cpu, or the card

    cfg = args.config
    if cfg.startswith("@"):
        with open(cfg[1:]) as f:
            cfg = f.read()
    config = json.loads(cfg)

    def on_failure(rank):
        print(f"WORKER {rank} FAILED — remaining workers keep running; restart "
              f"it with --rank {rank} to rejoin (the coordinator re-admits a "
              f"failed rank's handshake)")

    with Coordinator(args.num_workers, bind=args.bind, port=args.port,
                     on_failure=on_failure) as coord:
        print(f"coordinator listening on port {coord.port()}", flush=True)
        ranks = coord.wait_for_workers(timeout=600)
        print(f"workers joined: {ranks}")
        coord.deploy_config(config)
        coord.start_profiling()
        coord.barrier("start", timeout=600)
        print("training started; waiting for done barrier")
        coord.barrier("done", timeout=24 * 3600)
        prof = coord.collect_profiles()
        if args.profile_out:
            prof.to_chrome_trace(args.profile_out)
            print(f"merged profile -> {args.profile_out}")
        coord.shutdown()
        print("all workers shut down")


cli = console_entry(main)


if __name__ == "__main__":
    main()
