"""Pre-generate a `train_stream` pool-cache entry on the host CPU.

    python -m sound_bubble_tpu_torch.pregen_pool --n 4000 --seed 49 \
        --tag train --bg
    python -m sound_bubble_tpu_torch.pregen_pool --n 180 --seed 549 \
        --tag val --bg

The counterpart of the repo's `tools/pregen_pool.py`: the campaign trainer
builds a missing pool inside its own run; this writes the same cache file
ahead of it (the same key scheme, `{tag}_{n}_{seed}.npz` under `--cache_dir`
with a `bg` prefix for `--bg`, the same `_meta` [sr, rir_len, max_order] and
the same arrays, RIRs by `campaign.rirs_host_fast`), so
`train_stream.host_pool` loads it.
"""
import argparse
from pathlib import Path

import numpy as np

from sound_bubble_tpu_torch.datagen import campaign


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--tag", default="train")
    p.add_argument("--bg", action="store_true")
    p.add_argument("--cache_dir", default="runs/pool_cache")
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--rir_len", type=int, default=12000)
    p.add_argument("--max_order", type=int, default=32)
    return p


def main(args: argparse.Namespace):
    tag = ("bg" if args.bg else "") + args.tag
    out = Path(args.cache_dir) / f"{tag}_{args.n}_{args.seed}.npz"
    if out.exists():
        print(f"already cached: {out}")
        return
    pool, _ = campaign.build_pool(
        args.n, seed=args.seed, sr=args.sr, rir_len=args.rir_len,
        order_range=(min(10, args.max_order), args.max_order),
        bg_noise=args.bg)
    out.parent.mkdir(parents=True, exist_ok=True)
    # _meta pins the acoustic params the filename doesn't encode;
    # train_stream.host_pool validates it on load
    np.savez(out, _meta=np.asarray([args.sr, args.rir_len, args.max_order]),
             **pool)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(parser().parse_args())
