"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --corpus /data/corpus --steps 1000 [--device cuda|cpu] [--mesh none]

Port of `repro/launch/train.py` for one device: `--mesh none` (the
default) trains on `--device` (the card unless asked for the CPU); the
production meshes (`--mesh single|multi`) wait for ROADMAP.md item A.6b.
`--smoke` swaps in the reduced config.
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

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import TRAINING_MESH
    from repro_torch.models.config import not_ported
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import OptConfig

    if args.mesh != "none":
        raise not_ported(f"--mesh {args.mesh} (the production meshes)", TRAINING_MESH)
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
    out = train(cfg, optcfg, pipe, steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=args.device)
    print(f"[launch.train] done: {len(out['losses'])} steps, "
          f"final loss {out['losses'][-1]:.4f}, stragglers: {out['stragglers']}")


if __name__ == "__main__":
    main()
