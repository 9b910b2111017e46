"""CTC forced-alignment CLI of the port (the flags of
``wenet_celoss_tpu/bin/alignment.py``, plus ``--device``).

    python -m wenet_celoss_tpu_torch.bin.alignment --config train.yaml \\
        --input_data data.list --checkpoint final.pt \\
        --symbol_table units.txt --result_file ali/ali.txt --gen_praat

Reads a data list through the test-time data pipeline (no filter,
augmentation, shuffle or sort; static batches of ``--batch_size``; fbank
dither 0), loads a checkpoint (a JAX ``<n>.ckpt`` or the port's ``.pt``)
into the model the config builds, and aligns each utterance's labels to
its CTC log-probs by the batched Viterbi (``ops/ctc_loss.py
ctc_forced_align``): one line "<key> <state symbol a frame...>" in
``--result_file`` and, with ``--gen_praat``, a Praat TextGrid per
utterance beside it (one interval a run of a non-blank symbol). Runs on
the card; ``--device cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import numpy as np
import torch


def generator_textgrid(maxtime, lines, output):
    """Write a Praat TextGrid (reference `alignment.py:37-76`)."""
    intervals = []
    for line in lines:
        start, end, label = line.split()
        intervals.append((float(start), float(end), label))
    with open(output, "w", encoding="utf8") as f:
        f.write('File type = "ooTextFile"\nObject class = "TextGrid"\n\n')
        f.write(f"xmin = 0\nxmax = {maxtime}\n")
        f.write("tiers? <exists>\nsize = 1\nitem []:\n")
        f.write('    item [1]:\n        class = "IntervalTier"\n')
        f.write('        name = "token"\n')
        f.write(f"        xmin = 0\n        xmax = {maxtime}\n")
        f.write(f"        intervals: size = {len(intervals)}\n")
        for i, (s, e, lab) in enumerate(intervals, 1):
            f.write(f"        intervals [{i}]:\n")
            f.write(f"            xmin = {s}\n            xmax = {e}\n")
            f.write(f'            text = "{lab}"\n')


def get_frames_timestamp(alignment, blank: int = 0):
    """Frame path → [start, end) frame spans per emitted token
    (reference `alignment.py:79-113` semantics)."""
    spans = []
    t = 0
    n = len(alignment)
    while t < n:
        if alignment[t] == blank:
            t += 1
            continue
        tok = alignment[t]
        start = t
        while t < n and alignment[t] == tok:
            t += 1
        spans.append((start, t, int(tok)))
    return spans


def get_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="ctc forced alignment")
    parser.add_argument("--config", required=True)
    parser.add_argument("--data_type", default="raw")
    parser.add_argument("--input_data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--symbol_table", required=True)
    parser.add_argument("--bpe_model", default=None)
    parser.add_argument("--non_lang_syms", default=None)
    parser.add_argument("--result_file", required=True)
    parser.add_argument("--gen_praat", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device; the card by default, 'cpu' "
                             "for the plain PyTorch versions")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.models.factory import (init_model,
                                                       resolve_device)
    from wenet_celoss_tpu_torch.ops.ctc_loss import ctc_forced_align
    from wenet_celoss_tpu_torch.utils.checkpoint import load_into
    from wenet_celoss_tpu_torch.utils.config import load_config
    from wenet_celoss_tpu_torch.utils.file_utils import (
        read_non_lang_symbols, read_symbol_table)

    device = resolve_device(args.device)
    configs = load_config(args.config)
    symbol_table = read_symbol_table(args.symbol_table)
    id2sym = {v: k for k, v in symbol_table.items()}
    conf = dict(configs["dataset_conf"])
    conf.update(filter=False, speed_perturb=False, spec_aug=False,
                spec_sub=False, shuffle=False, sort=False,
                batch_conf={"batch_type": "static",
                            "batch_size": args.batch_size})
    conf["fbank_conf"] = dict(conf.get("fbank_conf", {}), dither=0.0)
    dataset = Dataset(args.data_type, args.input_data, symbol_table, conf,
                      args.bpe_model,
                      read_non_lang_symbols(args.non_lang_syms),
                      partition=False)

    configs.setdefault("input_dim",
                       conf["fbank_conf"].get("num_mel_bins", 80))
    configs.setdefault("output_dim", len(symbol_table))
    model = init_model(configs, device=device)
    load_into(model, args.checkpoint)

    subsample = model.encoder.subsampling_rate
    frame_shift_s = conf["fbank_conf"].get("frame_shift", 10) / 1000.0
    out_dir = os.path.dirname(args.result_file) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.result_file, "w", encoding="utf8") as fout, \
            torch.no_grad():
        for batch in iter(dataset):
            _, mask, ctc_lp = model.encode_ctc(
                torch.as_tensor(batch["feats"], device=device),
                torch.as_tensor(batch["feat_lengths"], dtype=torch.long,
                                device=device))
            enc_lens = mask.long().sum(dim=1)
            path = ctc_forced_align(
                ctc_lp, torch.as_tensor(np.maximum(batch["labels"], 0),
                                        dtype=torch.long, device=device),
                enc_lens, torch.as_tensor(batch["label_lengths"],
                                          dtype=torch.long, device=device))
            path, enc_lens = path.cpu().numpy(), enc_lens.cpu().numpy()
            for i, key in enumerate(batch["keys"]):
                ali = path[i, :int(enc_lens[i])]
                fout.write(f"{key} {' '.join(str(int(x)) for x in ali)}\n")
                if args.gen_praat:
                    lines = []
                    for s, e, tok in get_frames_timestamp(ali):
                        t0 = s * subsample * frame_shift_s
                        t1 = e * subsample * frame_shift_s
                        lines.append(
                            f"{t0:.3f} {t1:.3f} {id2sym.get(tok, '<unk>')}")
                    maxtime = float(enc_lens[i]) * subsample * frame_shift_s
                    generator_textgrid(
                        maxtime, lines,
                        os.path.join(out_dir, f"{key}.TextGrid"))


if __name__ == "__main__":
    main()
