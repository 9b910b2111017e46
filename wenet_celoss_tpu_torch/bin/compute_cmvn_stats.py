"""Global CMVN statistics (port of
``wenet_celoss_tpu/bin/compute_cmvn_stats.py``): fbank sums over a
wav.scp → the JSON stats file that ``--cmvn`` reads.

    python -m wenet_celoss_tpu_torch.bin.compute_cmvn_stats \\
        --train_config conf.yaml --in_scp wav.scp --out_cmvn global_cmvn

The float64 sums of each mel bin and of its square, and the frame count,
with dither 0; an utterance that cannot be read is skipped, and no frame
at all raises. The config is read by the port's YAML reader (no PyYAML).
"""

from __future__ import annotations

import argparse
import json
import struct
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="compute global cmvn")
    parser.add_argument("--num_workers", type=int, default=1,
                        help="accepted for the JAX CLI's flags; one process")
    parser.add_argument("--train_config", required=True,
                        help="yaml with dataset_conf.fbank_conf")
    parser.add_argument("--in_scp", required=True, help="wav.scp")
    parser.add_argument("--out_cmvn", default="global_cmvn")
    parser.add_argument("--log_interval", type=int, default=1000)
    args = parser.parse_args(argv)

    from wenet_celoss_tpu_torch.data.wav import read_audio
    from wenet_celoss_tpu_torch.ops.fbank import FbankConfig, compute_fbank_np
    from wenet_celoss_tpu_torch.utils.config import load_config

    fbank_conf = load_config(args.train_config)["dataset_conf"]["fbank_conf"]
    mel = fbank_conf.get("num_mel_bins", 80)

    mean_stat = np.zeros(mel, np.float64)
    var_stat = np.zeros(mel, np.float64)
    frames = 0
    with open(args.in_scp) as f:
        for i, line in enumerate(f):
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            try:
                wav, sr = read_audio(parts[1])
            except (OSError, ValueError, struct.error):
                continue  # unreadable: skipped, as in the JAX tool
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            cfg = FbankConfig(
                sample_rate=sr, num_mel_bins=mel,
                frame_length_ms=fbank_conf.get("frame_length", 25),
                frame_shift_ms=fbank_conf.get("frame_shift", 10),
                dither=0.0)
            feat = compute_fbank_np(wav, cfg)
            mean_stat += feat.sum(axis=0)
            var_stat += (feat ** 2).sum(axis=0)
            frames += feat.shape[0]
            if i % args.log_interval == 0:
                print(f"processed {i} utts, {frames} frames")
    # No frame means no utterance could be read: a NaN global CMVN would
    # poison training.
    if frames == 0:
        raise ValueError(f"no frames accumulated from {args.in_scp}")
    with open(args.out_cmvn, "w") as f:
        json.dump({"mean_stat": mean_stat.tolist(),
                   "var_stat": var_stat.tolist(),
                   "frame_num": frames}, f)


if __name__ == "__main__":
    main()
