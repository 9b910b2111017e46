"""Check transcription labels against audio (the port of the root script
``tools/label_checker.py``, plus ``--device``): decode each utterance's
CTC posteriors through a constrained edit-alignment (correct / <del> /
<is>...</is> filler with penalties; ``decode/label_check.py``) and write
the annotated labels plus per-unit timestamps.

    python -m wenet_celoss_tpu_torch.bin.label_checker --config train.yaml \\
        --checkpoint final.pt --symbol_table units.txt --wav_scp wav.scp \\
        --text text --result result.txt [--timestamp ts.txt] \\
        [--is_penalty 2.3]

Runs the encoder on the card; ``--device cpu`` runs the plain PyTorch
versions on the CPU. The alignment search runs on the host over each
utterance's float32 log-probs.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import List, Optional

import torch


def get_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--symbol_table", required=True)
    parser.add_argument("--wav_scp", required=True)
    parser.add_argument("--text", required=True,
                        help="kaldi-style text: key transcript...")
    parser.add_argument("--result", required=True)
    parser.add_argument("--timestamp", default=None)
    parser.add_argument("--is_penalty", type=float, default=2.3,
                        help="per-unit insertion/substitution penalty "
                             "(natural log)")
    parser.add_argument("--del_penalty", type=float, default=2.3)
    parser.add_argument("--beam", type=int, default=200)
    parser.add_argument("--device", default=None,
                        help="torch device; the card by default, 'cpu' "
                             "for the plain PyTorch versions")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.decode.label_check import (check_labels,
                                                           render)
    from wenet_celoss_tpu_torch.models.factory import (init_model,
                                                       resolve_device)
    from wenet_celoss_tpu_torch.utils.checkpoint import load_into
    from wenet_celoss_tpu_torch.utils.config import load_config
    from wenet_celoss_tpu_torch.utils.file_utils import read_symbol_table

    device = resolve_device(args.device)
    configs = load_config(args.config)
    symbol_table = read_symbol_table(args.symbol_table)
    id2sym = {v: k for k, v in symbol_table.items()}

    # Reference MapToLabel (label_checker_main.cc:41-58): char-split, space
    # → ▁, silently drop unknown units.
    def to_labels(text: str):
        out = []
        for ch in text:
            sym = "▁" if ch == " " else ch
            if sym in symbol_table:
                out.append(symbol_table[sym])
        return out

    texts = {}
    with open(args.text, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                texts[parts[0]] = parts[1]

    # wav.scp → raw jsonl data.list for the standard pipeline.
    tmp = tempfile.NamedTemporaryFile("w", suffix=".list", delete=False)
    n_utts = 0
    with open(args.wav_scp, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2 and parts[0] in texts:
                tmp.write(json.dumps({"key": parts[0], "wav": parts[1],
                                      "txt": texts[parts[0]]}) + "\n")
                n_utts += 1
    tmp.close()
    logging.info("checking %d utterances", n_utts)

    conf = dict(configs["dataset_conf"])
    conf.update(filter=False, speed_perturb=False, spec_aug=False,
                spec_sub=False, shuffle=False, sort=False,
                batch_conf={"batch_type": "static", "batch_size": 1})
    conf["fbank_conf"] = dict(conf.get("fbank_conf", {}), dither=0.0)
    dataset = Dataset("raw", tmp.name, symbol_table, conf, partition=False)

    configs.setdefault("input_dim",
                       conf["fbank_conf"].get("num_mel_bins", 80))
    configs.setdefault("output_dim", len(symbol_table))
    model = init_model(configs, device=device)
    load_into(model, args.checkpoint)

    subsample = model.encoder.subsampling_rate
    frame_shift = conf["fbank_conf"].get("frame_shift", 10)
    os.makedirs(os.path.dirname(args.result) or ".", exist_ok=True)
    ts_out = open(args.timestamp, "w", encoding="utf8") \
        if args.timestamp else None
    try:
        with open(args.result, "w", encoding="utf8") as fout, \
                torch.no_grad():
            for batch in iter(dataset):
                key = batch["keys"][0]
                _, mask, ctc_lp = model.encode_ctc(
                    torch.as_tensor(batch["feats"], device=device),
                    torch.as_tensor(batch["feat_lengths"],
                                    dtype=torch.long, device=device))
                n = int(mask[0].sum())
                logp = ctc_lp[0, :n].float().cpu().numpy()
                items = check_labels(logp, to_labels(texts[key]),
                                     is_penalty=args.is_penalty,
                                     del_penalty=args.del_penalty,
                                     beam=args.beam)
                if items is None:
                    logging.warning("%s: no alignment found", key)
                    fout.write(f"{key}\n")
                    continue
                text, ts = render(items, id2sym, frame_shift_ms=frame_shift,
                                  subsampling=subsample)
                fout.write(f"{key} {text}\n")
                if ts_out:
                    ts_out.write(f"{key} {ts}\n")
    finally:
        if ts_out:
            ts_out.close()
        os.unlink(tmp.name)


if __name__ == "__main__":
    main()
