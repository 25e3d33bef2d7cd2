"""The port's training CLI under ``torchrun`` on the CPU: two gloo ranks with
``--data_parallel 2`` (``python -m torch.distributed.run --standalone``, a
free port picked by the launcher), held to the same CLI on one process with
the same global batch (``--per_device_train_batch_size`` doubled): the
losses rank 0 logs for steps 1 and 2 agree within ``LOSS_RTOL`` relative
(bf16 on both sides, the rows' sums in another order), and rank 0 writes
the one checkpoint, of whole leaves with the single-process run's shapes.
The checkpoint and the data set are ``tests/test_torch_train_cli.py``'s."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_llava_tpu_torch.train import train_sparse as tcli
from dynamic_llava_tpu_torch.weights import named_leaves

from helpers import make_tiny_checkpoint
from test_torch_train_cli import LOSS_RTOL, read_metrics, write_set

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchrun")
    ckpt = make_tiny_checkpoint(str(root / "ckpt"))
    data, images = write_set(root)
    base = ["--model_path", ckpt, "--data_path", data, "--image_folder", images,
            "--max_steps", "2", "--logging_steps", "1", "--learning_rate", "1e-3",
            "--seed", "3", "--output_text_len_for_training", "2", "--device", "cpu"]
    one = str(root / "one")
    tcli.train(base + ["--per_device_train_batch_size", "4", "--output_dir", one])
    two = str(root / "two")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "dynamic_llava_tpu_torch.train.train_sparse", *base,
         "--per_device_train_batch_size", "2", "--data_parallel", "2", "--output_dir", two],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return one, two, proc.stdout


def test_train_sparse_under_torchrun_matches_one_process(runs):
    one, two, stdout = runs
    got, want = read_metrics(two), read_metrics(one)
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "lm_loss", "image_mask_loss", "output_text_mask_loss"):
            gap = abs(g[k] - w[k]) / abs(w[k])
            assert gap <= LOSS_RTOL, (w["step"], k, g[k], w[k])
    assert stdout.count("final:") == 1  # rank 0 alone prints
    saved = [sorted(os.listdir(os.path.join(d, "ckpt"))) for d in (one, two)]
    assert saved[0] == saved[1] == ["step_2.pt"]
    a, b = (torch.load(os.path.join(d, "ckpt", "step_2.pt"), weights_only=True)
            for d in (one, two))
    shapes = [{p: tuple(t.shape) for p, t in named_leaves(c["params"])} for c in (a, b)]
    assert shapes[0] == shapes[1]
    assert all(np.isfinite(m["loss"]) for m in got)
