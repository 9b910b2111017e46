"""The train CLI's ``--distributed`` and the recognize CLI's ``--sharded``
on 2 gloo ranks on the CPU (one spawn of ``tests/torch_dist_ranks.py``
a test session, each rank with yaml, msgpack, flax and jax blocked, as
on the machine with the card):

- ``train --distributed`` over 7 WAVs in batches of 1: the list is
  partitioned by rank (4 and 3 utterances), and both ranks stop the
  epoch at the shorter's 3 batches; the ranks' parameters and running
  statistics are equal bit for bit, and to rank 0's ``0.pt``; only rank
  0 writes (rank 1 is given a model directory of its own, which stays
  absent);
- ``recognize --sharded`` over 4 WAVs in batches of 3 (the second batch
  one utterance: rank 1 decodes a padding row), three modes with
  context mode 3 and "on" gating: the result files and ``.gate_dist``
  equal the one-process CLI's byte for byte; rank 1 writes nothing.
"""

import copy
import json
from pathlib import Path

import pytest
import torch
import yaml

import torch_dist_ranks
from test_torch_data_extra import write_train_inputs
from test_torch_recognize import cli_inputs
from test_torch_train_cli import cli_config
from wenet_celoss_tpu_torch.bin import recognize
from wenet_celoss_tpu_torch.utils import checkpoint

BLOCK = ("yaml", "msgpack", "flax", "jax")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs on 2 ranks, once a session (``spawn_once``) → (the
    directory, each rank's results, each rank's log, the one-process
    recognize arguments)."""
    (results, logs, (tmp, rec_args)) = torch_dist_ranks.spawn_once(
        "cli", _jobs, tmp_path_factory, block=BLOCK)
    return tmp, results, logs, rec_args


def _jobs(tmp):
    (tmp / "cv").mkdir()
    cv_list, _, _ = write_train_inputs(tmp / "cv", 2, offset=8)
    train_list, units, _ = write_train_inputs(tmp, 7)
    cfg = copy.deepcopy(cli_config())
    cfg["dataset_conf"]["batch_conf"] = {"batch_type": "static",
                                         "batch_size": 1}
    cfg.update(accum_grad=1, log_interval=1)
    conf = tmp / "conf.yaml"
    conf.write_text(yaml.dump(cfg))
    train_args = ["--config", str(conf), "--train_data", train_list,
                  "--cv_data", cv_list, "--symbol_table", units,
                  "--num_epochs", "1", "--distributed", "--dist_backend",
                  "gloo", "--device", "cpu", "--ddp.init_method",
                  f"file://{tmp}/train_rendezvous"]
    (tmp / "rec").mkdir()
    rec_args, rec_tmp = cli_inputs(str(tmp / "rec"))
    rec_args = rec_args + [
        "--context_mode", "3", "--context_list_file",
        str(rec_tmp / "hotwords.txt"), "--context_filter_state", "on",
        "--batch_size", "3", "--device", "cpu"]
    sharded = ["--sharded", "--dist_backend", "gloo", "--ddp.init_method",
               f"file://{tmp}/recognize_rendezvous"]
    jobs = {r: [{"kind": "cli", "cli": "train",
                 "argv": train_args + ["--model_dir",
                                       str(tmp / f"model_rank{r}")]},
                {"kind": "cli", "cli": "recognize",
                 "argv": rec_args + sharded + [
                     "--result_file", str(tmp / f"text_rank{r}" / "text")]}]
            for r in range(2)}
    return jobs, (tmp, rec_args)


def test_train_distributed_stops_at_the_shorter_rank_and_rank_0_writes(run):
    tmp, results, logs, _ = run
    out = tmp / "model_rank0"
    assert sorted(p.name for p in out.iterdir()) == [
        "0.pt", "0.pt.yaml", "final.pt", "metrics.jsonl", "train.yaml"]
    assert not (tmp / "model_rank1").exists()
    # 7 utterances: 4 on rank 0, 3 on rank 1, one a batch
    records = [json.loads(line) for line in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["batch"] for r in records] == [0, 1, 2]
    assert checkpoint.load_checkpoint_infos(str(out / "0.pt"))["step"] == 3
    (s0,), (s1,) = results[0][0], results[1][0]
    saved = torch.load(out / "0.pt", weights_only=False)
    saved = saved.get("model", saved)
    assert sorted(s0) == sorted(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
        assert torch.equal(s0[k], saved[k]), k
    assert "rank 1 of 2 on cpu over gloo" in logs[1]


def test_recognize_sharded_files_equal_the_one_process_run(run):
    tmp, _, _, rec_args = run
    one = tmp / "one_process" / "text"
    recognize.main(rec_args + ["--result_file", str(one)])
    want = {p.name: p.read_bytes() for p in sorted(one.parent.iterdir())}
    got_dir = tmp / "text_rank0"
    got = {p.name: p.read_bytes() for p in sorted(got_dir.iterdir())}
    assert got == want
    assert sorted(want) == ["text.attention_rescoring",
                            "text.ctc_beam_td_attn_rescoring",
                            "text.gate_dist", "text.rnnt_greedy_search"]
    assert len(want["text.rnnt_greedy_search"].splitlines()) == 4
    assert not (tmp / "text_rank1").exists()


def test_model_parallel_still_raises_naming_item_9b(tmp_path):
    from wenet_celoss_tpu_torch.bin import train
    with pytest.raises(NotImplementedError, match="item 9b"):
        train.main(["--config", "x", "--train_data", "x", "--cv_data", "x",
                    "--symbol_table", "x", "--model_dir",
                    str(tmp_path / "m"), "--model_parallel", "2"])
    assert not (tmp_path / "m").exists()


def test_rank_helper_imports_no_jax():
    from test_torch_imports import FORBIDDEN, _imported_modules
    path = Path(torch_dist_ranks.__file__)
    assert not [m for m in _imported_modules(path) if FORBIDDEN.match(m)]
