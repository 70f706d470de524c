"""Serving launcher: restore a checkpoint (or init) and serve a synthetic
request stream through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --smoke \
        --requests 16 [--device cuda|cpu]

Port of `repro/launch/serve.py` with its options, plus `--device`: the
engine runs on the card unless the caller asks for the CPU.  Parameters are
drawn from seed 0 on the device (`models.model.init_params`), or restored
from `--ckpt-dir`'s newest readable step.  The requests are the
reference's: prompts of 8 + i % 24 ids from numpy's generator at seed 0.
"""

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.checkpoint import CheckpointManager

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.serve --device cuda: no CUDA card is available")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, 0, device=args.device)
    if args.ckpt_dir:
        m = CheckpointManager(args.ckpt_dir)
        restored, manifest = m.restore_latest({"params": params})
        if restored is not None:
            params = restored["params"]
            print(f"[serve] restored step {manifest['meta'].get('step')}")

    eng = ServeEngine(params, cfg, n_slots=args.slots, max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, (8 + i % 24,)),
                           max_new_tokens=args.max_new))
    done = eng.run_until_drained()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens, {dt:.1f}s "
          f"({toks/dt:.1f} tok/s), {eng.steps} ticks")
    return {"requests": len(done), "tokens": toks, "seconds": dt, "tokens_per_s": toks / dt,
            "ticks": eng.steps}


if __name__ == "__main__":
    main()
