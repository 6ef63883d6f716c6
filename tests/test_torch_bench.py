"""``wavenet_torch.bench`` on the CPU: every row function once at the tiny
config, the compact line's keys against the JAX bench's, and a failing
row that ends the run.

On the CPU the rows run the plain versions (``decode_reference``), so
their rates say nothing of the card: these tests check that each row runs
and yields a finite, positive rate, that no decode kernel is counted, and
that the output has the JAX bench's shape.
"""

import ast
import json
import math
import os

import pytest
import torch

from wavenet_torch import bench
from wavenet_torch.kernels import sampler as ks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.fixture
def no_launch():
    """Fails the test if a decode kernel was counted."""
    before = (ks.decode.launches, ks.decode_sequential.launches)
    yield
    assert (ks.decode.launches, ks.decode_sequential.launches) == before


@pytest.mark.parametrize("prefill,weight_dtype,sync", [
    (True, None, "full"), (True, torch.bfloat16, "device"),
    (False, None, "device")], ids=["prefill", "bf16_device", "sequential"])
def test_generation_row(prefill, weight_dtype, sync, no_launch):
    row = bench.bench_generation_cuda(
        2, 40, weight_dtype=weight_dtype, prefill=prefill,
        config_name="tiny", reps=2, sync=sync, device="cpu")
    assert _positive(row.rate)
    assert len(row.rates_per_rep) == 2
    assert all(_positive(r) for r in row.rates_per_rep)
    assert min(row.rates_per_rep) <= row.rate <= max(row.rates_per_rep)
    assert row.kernels == {}          # the CPU runs the plain version


def test_scan_row(no_launch):
    assert _positive(bench.bench_generation_scan(2, 30, "tiny",
                                                 device="cpu"))


@pytest.mark.parametrize("K", [1, 2])
def test_training_row(K):
    row = bench.bench_training(2, 300, config_name="tiny", n_steps=4,
                               reps=2, steps_per_dispatch=K, device="cpu")
    assert _positive(row.rate)
    assert len(row.rates_per_rep) == 2
    assert all(_positive(r) for r in row.rates_per_rep)
    assert row.mfu is None            # no peak is known for the CPU


def test_e2e_cli_row(tmp_path, no_launch):
    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps(
        {"filter_width": 2, "sample_rate": 2000, "dilations": [1, 2, 4, 8],
         "residual_channels": 8, "dilation_channels": 8, "skip_channels": 16,
         "quantization_channels": 32, "use_biases": True}))
    assert _positive(bench.bench_e2e_cli(
        num_steps=10, batch_size=2, sample_size=200,
        wavenet_params=str(pfile), device="cpu"))


def test_e2e_cli_row_raises_when_the_cli_fails(tmp_path):
    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps({"sample_rate": 2000, "dilations": [1, 2]}))
    with pytest.raises(RuntimeError, match="fewer than 10"):
        bench.bench_e2e_cli(num_steps=3, batch_size=1, sample_size=50,
                            wavenet_params=str(pfile), device="cpu")


def test_tf1_baseline_is_the_committed_measurement(tmp_path):
    rate, kind = bench.tf1_baseline_samples_per_s()
    with open(os.path.join(ROOT, "baselines", "tf1_fastgen.json")) as f:
        assert rate == json.load(f)["samples_per_s"]
    assert kind == "measured"
    assert bench.tf1_baseline_samples_per_s(str(tmp_path / "none.json")) \
        == (100.0, "estimate")


def _jax_compact_keys():
    """The nested key set of the dict that the root bench.py's ``main``
    assigns to ``compact``, read from its source (the JAX bench is not
    run)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    compact = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
        and any(isinstance(t, ast.Name) and t.id == "compact"
                for t in n.targets))

    def keys(d):
        return {k.value: keys(v) if isinstance(v, ast.Dict) else None
                for k, v in zip(d.keys, d.values)}
    return keys(compact)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _parts(rate=1234.5):
    gen = bench.GenRow(rate, [rate * 0.99, rate, rate * 1.01], {})
    train = bench.TrainRow(654.321, 0.0712, [650.0, 654.321, 660.0])
    configs = {
        "gc": {"train_audio_sec_per_s_bf16_b8": 700.12,
               "train_audio_sec_per_s_bf16_b8_k4": 710.5,
               "mfu_train_b8_k4": 0.0731},
        "wide": {"train_audio_sec_per_s_bf16_b8": 210.2,
                 "gen_samples_per_s_b1_prefill": 25000.25},
        "sharded": {"train_audio_sec_per_s_bf16_b1_remat": 40.1},
        "lc": {"train_audio_sec_per_s_bf16_b8": 600.3},
    }
    ladder = {B: {"device": gen._replace(rate=rate * B,
                                         rates_per_rep=[rate * B] * 3),
                  "delivered": gen} for B in bench.LADDER}
    return dict(headline=31234.56, tf1_rate=640.85, train_b8=train,
                e2e_cli=600.7, ladder=ladder, configs=configs,
                hbm_peak=3.35e12)


def test_compact_line_has_the_jax_keys():
    line = bench.compact_line(**_parts())
    assert len(line) <= bench.COMPACT_LIMIT
    compact = json.loads(line)
    assert _keys(compact) == _jax_compact_keys()
    assert compact["value"] == 31234.56
    assert compact["vs_baseline"] == round(31234.56 / 640.85, 2)
    extra = compact["extra"]
    assert extra["gen_b512"] == [round(1234.5 * 512)] * 2
    assert extra["b512_over_b256"] == 2.0
    assert extra["full"] == "build/bench_full_latest.json"
    assert all(v is not None for v in extra.values())
    assert all(v is not None for v in extra["cfg_train_b8"].values())


def test_compact_line_keeps_its_limit():
    parts = _parts()
    parts["configs"]["wide"]["gen_samples_per_s_b1_prefill"] = "x" * 2000
    compact = json.loads(bench.compact_line(**parts))
    assert set(compact["extra"]) == {"train_b8", "gen_b512", "full"}


def test_a_failing_row_ends_the_run(monkeypatch, capsys):
    """No row is caught: the first one that raises ends ``main`` (so
    ``python -m wavenet_torch.bench`` exits non-zero), and no line is
    printed."""
    def failing_row(*args, **kw):
        raise RuntimeError("the row failed")

    monkeypatch.setattr(bench, "bench_generation_cuda", failing_row)
    with pytest.raises(RuntimeError, match="the row failed"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_no_row_is_caught():
    """The one try statement of the bench reads the committed TF1 rate;
    no row, and no call of a row, sits in one."""
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    catching = {f.name for f in ast.walk(tree)
                if isinstance(f, ast.FunctionDef)
                and any(isinstance(n, ast.Try) for n in ast.walk(f))}
    assert catching == {"tf1_baseline_samples_per_s"}
