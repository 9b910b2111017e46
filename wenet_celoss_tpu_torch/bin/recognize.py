"""Batch decoding CLI of the port (the flags of
``wenet_celoss_tpu/bin/recognize.py``, plus ``--device``).

    python -m wenet_celoss_tpu_torch.bin.recognize --config train.yaml \\
        --test_data data.list --checkpoint final.ckpt \\
        --symbol_table units.txt --result_file text \\
        --mode rnnt_greedy_search,attention_rescoring

Reads a data list (raw jsonl or tar shards) through the test-time data
pipeline (no filter, augmentation, shuffle or sort; static batches of
``--batch_size``; fbank dither 0), loads a checkpoint (a JAX
``<n>.ckpt`` or the port's ``.pt``) into the model the config builds, and
writes one line "<key> <text>" per utterance for each decode mode. A
comma list of modes runs in one process, into ``<result_file>.<mode>``.
Context modes: 2 and 3 read ``--context_list_file`` (one phrase of token
ids a line; row 0 of the list is the no-bias sentinel [0]); 3 also
labels each token of the references with the hotwords and, for
``rnnt_greedy_search``, writes the summed edit distance between those
labels and the decoded gates to ``<result_file>.gate_dist``; 4 reads a
pickled {key: [phrase, ...]} dict (only from a trusted source: unpickling
runs code) and decodes each batch with its first utterance's list.

Runs on the card; ``--device cpu`` runs the plain PyTorch versions on
the CPU. The yaml's top-level ``rnnt_impl`` is not read, as in the JAX
package's factory.

``--sharded`` decodes every batch split over the ranks of a process
group (``decode/sharded.py``; the processes torchrun starts, as the
train CLI's ``--distributed`` joins them): every rank reads the same
list, decodes its share and receives every result; rank 0 alone writes
the result files and the ``.gate_dist`` sidecar. ``"exact"`` gating runs
the whole batch on every rank.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

MODES = [
    "attention", "ctc_greedy_search", "ctc_prefix_beam_search",
    "attention_rescoring", "rnnt_greedy_search", "rnnt_beam_search",
    "rnnt_beam_attn_rescoring", "ctc_beam_td_attn_rescoring",
]


def get_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="recognize with your model")
    parser.add_argument("--config", required=True)
    parser.add_argument("--data_type", default="raw",
                        choices=["raw", "shard"])
    parser.add_argument("--test_data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--symbol_table", required=True)
    parser.add_argument("--bpe_model", default=None)
    parser.add_argument("--non_lang_syms", default=None)
    parser.add_argument("--result_file", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--mode", default="attention_rescoring",
                        help="decode mode, or a comma-separated list of "
                             "modes decoded in one process (one dataset "
                             "pass); with a list, per-mode files are "
                             "written at <result_file>.<mode>")
    parser.add_argument("--beam_size", type=int, default=10)
    parser.add_argument("--decoding_chunk_size", type=int, default=-1)
    parser.add_argument("--num_decoding_left_chunks", type=int, default=-1)
    parser.add_argument("--simulate_streaming", action="store_true",
                        help="decode chunk-by-chunk with bounded caches "
                             "(requires --decoding_chunk_size > 0)")
    parser.add_argument("--ctc_weight", type=float, default=0.0)
    parser.add_argument("--transducer_weight", type=float, default=1.0)
    parser.add_argument("--attn_weight", type=float, default=1.0)
    parser.add_argument("--search_ctc_weight", type=float, default=0.3)
    parser.add_argument("--reverse_weight", type=float, default=0.0)
    parser.add_argument("--override_config", action="append", default=[])
    parser.add_argument("--context_mode", type=int, default=0)
    parser.add_argument("--context_list_file", default=None)
    parser.add_argument("--context_dict", default=None,
                        help="pickled per-utterance hotword dict (mode 4)")
    parser.add_argument("--context_filter_state", default="off",
                        choices=["on", "off", "exact"],
                        help="'on': the per-frame gate picks the stream; "
                             "'exact': the backtracking repair loop, one "
                             "utterance at a time")
    parser.add_argument("--sharded", action="store_true",
                        help="decode each batch split over the ranks torchrun "
                             "starts, results all-gathered")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="--sharded's backend (default: nccl on the "
                             "card, gloo on the CPU)")
    parser.add_argument("--ddp.init_method", dest="init_method",
                        default=None,
                        help="--sharded's init method (default env://)")
    parser.add_argument("--device", default=None,
                        help="torch device; the card by default, 'cpu' "
                             "for the plain PyTorch versions")
    return parser.parse_args(argv)


def _phrase_array(rows: List[List[int]]):
    """Phrases → (context_list [N, L] padded with -1, lengths [N])."""
    l_max = max(len(r) for r in rows)
    ctx = np.full((len(rows), l_max), -1, np.int32)
    lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        ctx[i, :len(r)] = r
        lens[i] = len(r)
    return ctx, lens


def eval_dataset_conf(configs: Dict[str, Any], batch_size: int):
    """The config's ``dataset_conf`` for decoding: no filter,
    augmentation, shuffle or sort, static batches, fbank dither 0."""
    conf = dict(configs["dataset_conf"])
    conf.update(filter=False, speed_perturb=False, spec_aug=False,
                spec_sub=False, shuffle=False, sort=False,
                batch_conf={"batch_type": "static",
                            "batch_size": batch_size})
    conf["fbank_conf"] = dict(conf.get("fbank_conf", {}), dither=0.0)
    return conf


def hyp_text(hyp: List[int], id2sym: Dict[int, str]) -> str:
    """Token ids → the result line's text (``▁`` as a space)."""
    content = "".join(id2sym.get(t, "<unk>") for t in hyp)
    return content.replace("▁", " ").strip()


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import (init_model,
                                                       resolve_device)
    from wenet_celoss_tpu_torch.utils.checkpoint import load_into
    from wenet_celoss_tpu_torch.utils.config import (load_config,
                                                     override_config)
    from wenet_celoss_tpu_torch.utils.file_utils import (
        read_non_lang_symbols, read_symbol_table)
    from wenet_celoss_tpu_torch.utils.wer import edit_distance

    group = None
    if args.sharded:
        from wenet_celoss_tpu_torch.parallel import dist
        group = dist.init_distributed(args.dist_backend, args.init_method,
                                      device=args.device)
        device = group.device
    else:
        device = resolve_device(args.device)
    writer = group is None or group.rank == 0
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m!r}; choices: {MODES}")

    configs = load_config(args.config)
    if args.override_config:
        configs = override_config(configs, args.override_config)
    symbol_table = read_symbol_table(args.symbol_table)
    id2sym = {v: k for k, v in symbol_table.items()}
    non_lang_syms = read_non_lang_symbols(args.non_lang_syms)

    test_conf = eval_dataset_conf(configs, args.batch_size)
    # The context list is read before the dataset, so that mode 3 can
    # label the references' tokens with the hotwords (hw_labels) for the
    # gate sidecar.
    context_list = context_lengths = None
    context_dict = None
    file_rows = []
    if args.context_mode in (2, 3) and args.context_list_file:
        with open(args.context_list_file) as f:
            for line in f:
                ids = [int(x) for x in line.split()]
                if ids:
                    file_rows.append(ids)
        context_list, context_lengths = _phrase_array([[0]] + file_rows)
    elif args.context_mode == 4 and args.context_dict:
        with open(args.context_dict, "rb") as f:
            context_dict = pickle.load(f)
    if args.context_mode == 3 and file_rows:
        test_conf["context_mode"] = 3
        pad_conf = dict(test_conf.get("pad_conf", {}))
        pad_conf["file_list"] = file_rows
        test_conf["pad_conf"] = pad_conf
    else:
        test_conf["context_mode"] = 0   # context handled at decode time

    dataset = Dataset(args.data_type, args.test_data, symbol_table,
                      test_conf, args.bpe_model, non_lang_syms,
                      partition=False)

    configs.setdefault("input_dim",
                       test_conf["fbank_conf"].get("num_mel_bins", 80))
    configs.setdefault("output_dim", len(symbol_table))
    model = init_model(configs, device=device)
    load_into(model, args.checkpoint)
    decoder = Decoder(model, device=device)
    if group is not None:
        from wenet_celoss_tpu_torch.decode.sharded import ShardedDecoder
        logging.info("sharded decode over %d ranks (results all-gathered)",
                     group.world)
        decoder = ShardedDecoder(model, group)   # every mode of MODES
        if ("rnnt_greedy_search" in modes
                and args.context_filter_state == "exact"):
            logging.warning(
                "--sharded: context_filter_state=exact is a host-driven "
                "per-utterance repair loop; running it on the whole batch "
                "on every rank")

    if writer:
        os.makedirs(os.path.dirname(args.result_file) or ".", exist_ok=True)
    gate_dists = []

    def decode_batch(mode, feats, feat_lens, ctx, ctx_lens, kw):
        hot = dict(context_list=ctx, context_lengths=ctx_lens)
        if mode == "attention":
            return decoder.attention(feats, feat_lens,
                                     beam=args.beam_size, **kw)
        if mode == "ctc_greedy_search":
            return decoder.ctc_greedy_search(feats, feat_lens, **kw)
        if mode == "ctc_prefix_beam_search":
            hyps, _, _, _ = decoder.ctc_prefix_beam_search(
                feats, feat_lens, beam=args.beam_size, **kw)
            return [h[0] for h in hyps]
        if mode == "attention_rescoring":
            return decoder.attention_rescoring(
                feats, feat_lens, beam=args.beam_size,
                ctc_weight=args.ctc_weight,
                reverse_weight=args.reverse_weight, **kw)
        if mode == "rnnt_greedy_search":
            return decoder.rnnt_greedy_search(
                feats, feat_lens,
                context_filter_state=args.context_filter_state, **hot)
        if mode == "rnnt_beam_search":
            res, _, _ = decoder.rnnt_beam_search(
                feats, feat_lens, beam=args.beam_size,
                ctc_weight=args.search_ctc_weight,
                transducer_weight=args.transducer_weight, **hot)
            return decoder.rnnt_beam_to_lists(res)
        if mode == "ctc_beam_td_attn_rescoring":
            return decoder.ctc_beam_td_attn_rescoring(
                feats, feat_lens, beam=args.beam_size,
                ctc_weight=args.ctc_weight,
                transducer_weight=args.transducer_weight,
                attn_weight=args.attn_weight,
                reverse_weight=args.reverse_weight, **kw)
        if mode == "rnnt_beam_attn_rescoring":
            return decoder.rnnt_beam_attn_rescoring(
                feats, feat_lens, beam=args.beam_size,
                attn_weight=args.attn_weight,
                transducer_weight=args.transducer_weight,
                search_ctc_weight=args.search_ctc_weight,
                reverse_weight=args.reverse_weight, **hot)
        raise ValueError(mode)

    def out_path(mode):
        return args.result_file if len(modes) == 1 \
            else f"{args.result_file}.{mode}"

    fouts = {m: open(out_path(m), "w", encoding="utf8") for m in modes} \
        if writer else {}
    try:
        for batch in iter(dataset):
            feats = torch.as_tensor(batch["feats"], device=device)
            feat_lens = torch.as_tensor(batch["feat_lengths"],
                                        dtype=torch.long, device=device)
            ctx, ctx_lens = context_list, context_lengths
            if context_dict is not None:
                ctx, ctx_lens = _phrase_array(
                    [[0]] + [list(r) for r in
                             context_dict.get(batch["keys"][0], [])])
            kw = {}
            if args.decoding_chunk_size > 0:
                kw = dict(
                    decoding_chunk_size=args.decoding_chunk_size,
                    num_decoding_left_chunks=args.num_decoding_left_chunks,
                    simulate_streaming=args.simulate_streaming)
            for mode in modes:
                hyps = decode_batch(mode, feats, feat_lens, ctx, ctx_lens,
                                    kw)
                for key, hyp in zip(batch["keys"], hyps):
                    content = hyp_text(hyp, id2sym)
                    logging.info("[%s] %s %s", mode, key, content)
                    if writer:
                        fouts[mode].write(f"{key} {content}\n")
                # The hotword-gate edit distance sidecar.
                if (mode == "rnnt_greedy_search"
                        and decoder.last_gates is not None
                        and "hw_labels" in batch):
                    gates, glens = (np.asarray(torch.as_tensor(x).cpu())
                                    for x in decoder.last_gates)
                    for i in range(gates.shape[0]):
                        ref = [x for x in batch["hw_labels"][i] if x >= 0]
                        hyp_g = list(gates[i, :glens[i]])
                        gate_dists.append(edit_distance(ref, hyp_g))
    finally:
        for f in fouts.values():
            f.close()
    if gate_dists and writer:
        with open(args.result_file + ".gate_dist", "w") as f:
            f.write(f"<result>{sum(gate_dists)}\n")
    if group is not None:
        dist.barrier(group)
        dist.shutdown()


if __name__ == "__main__":
    main()
