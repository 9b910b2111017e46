"""Dataset assembly: list file → processor chain → padded batches (port
of ``wenet_celoss_tpu/data/dataset.py``, stage for stage).

Raw (jsonl) or shard (tar) lists, sharding by rank as
``lists[rank::world_size]``, the ordered thread pool over the numeric
stages with a counter-based random generator per sample (seeded by the
epoch and the sample's index, so any worker order gives the same draws),
and the train/eval stages that ``conf`` switches on. A plain iterator,
no DataLoader.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from wenet_celoss_tpu_torch.data import processor
from wenet_celoss_tpu_torch.data.tokenizer import Tokenizer
from wenet_celoss_tpu_torch.utils.file_utils import read_lists


class Dataset:
    def __init__(self, data_type: str, list_file: str,
                 symbol_table: Dict[str, int], conf: Dict,
                 bpe_model: Optional[str] = None,
                 non_lang_syms: Optional[List[str]] = None,
                 partition: bool = True, rank: int = 0,
                 world_size: int = 1):
        assert data_type in ("raw", "shard")
        self.data_type = data_type
        self.lists = read_lists(list_file)
        self.conf = conf
        self.partition = partition
        self.rank = rank
        self.world_size = world_size
        self.symbol_table = symbol_table
        self.tokenizer = Tokenizer(
            symbol_table, bpe_model, non_lang_syms,
            conf.get("split_with_space", False))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict]:
        conf = self.conf
        rng = random.Random(self.epoch)
        np_rng = np.random.default_rng(self.epoch)
        lists = list(self.lists)
        if conf.get("shuffle", True):
            rng.shuffle(lists)
        if self.partition and self.world_size > 1:
            lists = lists[self.rank::self.world_size]

        data: Iterator = iter([{"src": s} for s in lists])
        if self.data_type == "shard":
            data = processor.url_opener(data)
            data = processor.tar_file_and_group(data)
        else:
            data = processor.parse_raw(data)
        data = processor.tokenize(data, self.tokenizer)
        if conf.get("filter", True):
            data = processor.filter(data, **conf.get("filter_conf", {}))
        if conf.get("resample", True):
            data = processor.resample(data, **conf.get("resample_conf", {}))
        feats_type = conf.get("feats_type", "fbank")
        feat_conf = conf.get(f"{feats_type}_conf", {})
        feat_one = {"fbank": processor.fbank_one,
                    "mfcc": processor.mfcc_one}[feats_type]
        sp = conf.get("speed_perturb", False)
        sp_speeds = conf.get("speed_perturb_conf", {}).get(
            "speeds", [0.9, 1.0, 1.1])
        # Featurize threads only pay off when cores remain for the
        # GIL-held stages (read/tokenize/augment/batch/pad run in the
        # main thread), so the pool is off on a host of 2 cores or fewer.
        ncpu = os.cpu_count() or 1
        num_workers = conf.get("num_workers",
                               0 if ncpu <= 2 else min(8, ncpu - 1))
        if num_workers > 0:
            # Ordered thread map over the heavy numeric stages
            # (speed-perturb resample + fbank FFT/mel; numpy releases
            # the GIL). Randomness (speed, dither) is counter-based per
            # sample: a generator seeded by (epoch, sample index) draws
            # the same under any worker scheduling; the serial path
            # draws from the epoch's generators.
            epoch = self.epoch

            def _featurize(pair):
                i, s = pair
                srng = np.random.default_rng(
                    np.random.SeedSequence(entropy=(epoch, i)))
                if sp:
                    speed = sp_speeds[int(srng.integers(len(sp_speeds)))]
                    s = processor.speed_perturb_one(s, speed)
                return feat_one(s, np_rng=srng, **feat_conf)

            data = processor.parallel_map(enumerate(data), _featurize,
                                          num_workers=num_workers)
        else:
            if sp:
                data = processor.speed_perturb(data, speeds=sp_speeds,
                                               rng=rng)
            data = (sample for sample in map(
                lambda s: feat_one(s, np_rng=np_rng, **feat_conf), data))
        if conf.get("spec_aug", False):
            data = processor.spec_aug(data, rng=rng,
                                      **conf.get("spec_aug_conf", {}))
        if conf.get("spec_sub", False):
            data = processor.spec_sub(data, rng=rng,
                                      **conf.get("spec_sub_conf", {}))
        if conf.get("shuffle", True):
            data = processor.shuffle(
                data, rng=rng,
                **{k: v for k, v in conf.get("shuffle_conf", {}).items()})
        if conf.get("sort", True):
            data = processor.sort(data, **conf.get("sort_conf", {}))
        batch_conf = conf.get("batch_conf", {})
        if batch_conf.get("batch_type", "static") == "dynamic":
            data = processor.dynamic_batch(
                data, batch_conf.get("max_frames_in_batch", 12000))
        else:
            data = processor.static_batch(
                data, batch_conf.get("batch_size", 16))
        pad_conf = dict(conf.get("pad_conf", {}))
        if conf.get("context_mode", 0) == 1 and \
                "bpe_start_ids" not in pad_conf:
            # Mode-1 hotword sampling needs word-start token ids. BPE
            # pieces mark starts with '▁' (the reference reads these from
            # bpe_dict, processor.py:591-640); char-level vocabularies
            # have no marker, so every token starts a word.
            starts = {i for tok, i in self.symbol_table.items()
                      if tok.startswith("▁")}
            pad_conf["bpe_start_ids"] = (starts or
                                         set(self.symbol_table.values()))
        data = processor.padding(
            data,
            feat_buckets=conf.get("feat_buckets"),
            label_buckets=conf.get("label_buckets"),
            context_mode=conf.get("context_mode", 0),
            context_conf=pad_conf or None,
            num_labels=conf.get("num_labels", 2))
        n_prefetch = conf.get("prefetch", 2)
        if n_prefetch > 0:
            # Overlap the whole host pipeline with device compute.
            data = processor.prefetch(data, n_prefetch)
        return data
