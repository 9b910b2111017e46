"""Checkpoint averaging (port of ``wenet_celoss_tpu/bin/average_model.py``).

    python -m wenet_celoss_tpu_torch.bin.average_model \\
        --dst_model avg.pt --src_path exp/m --num 5 [--val_best]

Averages the last N epoch files ``<src_path>/[0-9]*.pt`` (or the N best
by their infos' ``cv_loss`` with ``--val_best``) uniformly in float64 and
writes a ``.pt`` with infos {averaged_from}.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="average model")
    parser.add_argument("--dst_model", required=True)
    parser.add_argument("--src_path", required=True,
                        help="model dir with N.pt + N.pt.yaml files")
    parser.add_argument("--val_best", action="store_true")
    parser.add_argument("--num", type=int, default=5)
    parser.add_argument("--min_epoch", type=int, default=0)
    parser.add_argument("--max_epoch", type=int, default=65536)
    args = parser.parse_args(argv)

    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt

    paths = ckpt.select_checkpoints(args.src_path, args.num, args.val_best,
                                    args.min_epoch, args.max_epoch)
    print(f"averaging {len(paths)} checkpoints: {paths}")
    if not paths:
        raise ValueError(f"no checkpoints matched in {args.src_path}")
    ckpt.save_checkpoint(ckpt.average_checkpoints(paths), args.dst_model,
                         {"averaged_from": [str(p) for p in paths]})


if __name__ == "__main__":
    main()
