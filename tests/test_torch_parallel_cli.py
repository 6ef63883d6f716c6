"""The port's train CLI in two gloo processes, on the CPU.

``python -m wavenet_torch.cli.train --model_parallelism 2
--coordinator_address file://... --num_processes 2 --process_id I
--device cpu`` at a tiny config for 2 steps, both processes started once
for the module (``tests/torch_gloo.py``'s deadline): its losses are the
one-process CLI's on the same seed (the two model ranks read the same
batches), rank 0 alone prints and writes the one checkpoint, gathered in
the one-process format, and one process and the server restore it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from wavenet_torch import train_lib as tl
from wavenet_torch.audio import write_wav
from wavenet_torch.cli import train as cli
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.serve import GenerationService

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo  # noqa: E402

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# D and S even: split over 2 model ranks.
PARAMS = {"filter_width": 2, "sample_rate": 2000,
          "dilations": [1, 2, 4, 8, 1, 2, 4, 8], "residual_channels": 8,
          "dilation_channels": 8, "skip_channels": 16,
          "quantization_channels": 64, "use_biases": True,
          "scalar_input": False, "initial_filter_width": 32}
STEPS = 2


def _argv(root, logdir):
    return ["--data_dir", os.path.join(root, "corpus"),
            "--wavenet_params", os.path.join(root, "params.json"),
            "--logdir", logdir, "--num_steps", str(STEPS),
            "--checkpoint_every", str(STEPS), "--batch_size", "2",
            "--sample_size", "500", "--silence_threshold", "0.02",
            "--gc_channels", "4", "--seed", "1", "--steps_per_dispatch", "1",
            "--device", "cpu"]


def _losses(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_parallel_cli"))
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    rng = np.random.RandomState(0)
    t = np.arange(3000) / 2000
    for spk, f0 in ((1, 155.56), (2, 196.0), (3, 233.08)):
        for utt in range(2):
            write_wav(os.path.join(corpus, f"p{spk}_{utt:03d}.wav"),
                      0.6 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6)),
                      2000)
    with open(os.path.join(root, "params.json"), "w") as f:
        json.dump(PARAMS, f)
    one = os.path.join(root, "one")
    assert cli.main(_argv(root, one)) == 0
    two = os.path.join(root, "two")
    rdv = "file://" + os.path.join(root, "rendezvous")
    outs = torch_gloo.spawn(
        [[sys.executable, "-m", "wavenet_torch.cli.train"]
         + _argv(root, two)
         + ["--model_parallelism", "2", "--coordinator_address", rdv,
            "--num_processes", "2", "--process_id", str(r)]
         for r in range(2)], root)
    return root, one, two, outs


def test_two_process_losses_equal_one_process(runs):
    _, one, two, outs = runs
    ref = _losses(one)
    assert len(ref) == STEPS
    np.testing.assert_allclose(_losses(two), ref, rtol=1e-6)
    assert f"step {STEPS} - loss = " in outs[0]


def test_only_rank0_prints_and_writes(runs):
    _, _, two, outs = runs
    assert "step 1 - loss" not in outs[1]
    assert "starting new training" in outs[0]
    assert sorted(os.listdir(two)) == [f"ckpt-{STEPS}", "metrics.jsonl"]


def test_gathered_checkpoint_restores_in_one_process(runs):
    """The whole params and Adam moments, as the one-process run's."""
    _, one, two, _ = runs
    cfg = WaveNetConfig.from_json(PARAMS, gc_channels=4, gc_cardinality=4)
    states = []
    for logdir in (one, two):
        state = tl.create_train_state(0, cfg, tl.make_optimizer("adam",
                                                                1e-3), "cpu")
        assert tl.restore_checkpoint(logdir, state) is state
        assert state.step == STEPS
        states.append(state)
    for k, v in states[0].params.items():
        np.testing.assert_allclose(states[1].params[k].detach(), v.detach(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for i, s in states[0].optimizer.state_dict()["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            got = states[1].optimizer.state_dict()["state"][i][name]
            assert got.shape == s[name].shape
            np.testing.assert_allclose(got, s[name], rtol=1e-4, atol=1e-9)


def test_gathered_checkpoint_serves_and_resumes(runs, capsys):
    """The server restores it, and so does a one-process resume."""
    root, _, two, _ = runs
    js = os.path.join(root, "params.json")
    svc = GenerationService(None, js, gc_channels=4, gc_cardinality=4,
                            checkpoint=two, warm_samples=0, device="cpu")
    wave = svc.generate(32, gc_id=1, seed=2)
    assert wave.shape == (32,) and np.all(np.abs(wave) <= 1.0)
    argv = _argv(root, two)
    argv[argv.index("--num_steps") + 1] = str(STEPS + 1)
    capsys.readouterr()
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"Restored model from step {STEPS}" in out
    assert f"step {STEPS + 1} - loss = " in out
    assert tl.latest_checkpoint_step(two) == STEPS + 1
