"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --corpus /data/corpus --steps 1000 [--device cuda|cpu] [--mesh none]

Port of `repro/launch/train.py`: `--mesh none` (the default) trains on one
`--device` (the card unless asked for the CPU); `--mesh single|multi`
trains under the production mesh (`launch.mesh.production_ctx`: (data 16,
model 16) or (pod 2, data 16, model 16)), one rank a card, which needs 256
or 512 ranks in the process group and raises `RuntimeError` otherwise, as
the reference raises without that many devices.  A process started with a
launcher's environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`, ...) joins its
process group first.  The reference's `XLA_FLAGS` line for 512 fake devices
has no counterpart here.  `--smoke` swaps in the reduced config.
"""

import argparse
import dataclasses
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mode", default="fused", choices=["fused", "engine", "host"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.compat import BACKENDS
    from repro_torch.distributed.sharding import local_ctx
    from repro_torch.launch.mesh import production_ctx
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import OptConfig

    ctx = local_ctx()
    if args.mesh != "none":
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            dist.init_process_group(BACKENDS[args.device])
        ctx = production_ctx(multi_pod=args.mesh == "multi", device=args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.microbatches > 1:
        cfg = dataclasses.replace(cfg, microbatches=args.microbatches)

    paths = [os.path.join(args.corpus, f) for f in sorted(os.listdir(args.corpus))
             if f.endswith(".lake")]
    pipe = TokenPipeline(paths, args.batch, args.seq, mode=args.mode, device=args.device)
    optcfg = OptConfig(
        name="adafactor" if cfg.n_params() > 5e10 else "adamw",
        lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )
    out = train(cfg, optcfg, pipe, steps=args.steps, ctx=ctx, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=args.device)
    print(f"[launch.train] done: {len(out['losses'])} steps, "
          f"final loss {out['losses'][-1]:.4f}, stragglers: {out['stragglers']}")


if __name__ == "__main__":
    main()
