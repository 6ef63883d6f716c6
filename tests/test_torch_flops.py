"""``wavenet_torch.utils.flops`` against the JAX package's
``wavenet_tpu/utils/flops.py`` (CPU).

Mirrors tests/test_flops.py: the paper config's MACs by hand, the train
step's scaling, the device constants (keyed here by the CUDA device name)
and a cross-check of the analytic train-step count against FLOPs counted
from the port's own train step, with ``torch.utils.flop_counter`` in the
place of XLA's cost analysis, in the JAX test's band (0.5x-1.5x). Every
ported count equals the JAX function on each ``CONFIGS`` entry and on the
LC config; the decode's device-memory bytes equal JAX's where the TPU
layouts pad nothing (R = 128, C_lc = 128 or no LC, B a multiple of 128).
"""

import dataclasses

import numpy as np
import pytest
import torch

from wavenet_tpu.models.config import CONFIGS as JCONFIGS
from wavenet_tpu.models.config import paper_config as jpaper
from wavenet_tpu.utils import flops as JF
from wavenet_torch.models.config import CONFIGS as TCONFIGS
from wavenet_torch.models.config import WaveNetConfig, paper_config
from wavenet_torch.utils import flops as F

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


def _pairs():
    yield "lc", jpaper(lc_channels=80), paper_config(lc_channels=80)
    for name in sorted(JCONFIGS):
        yield name, JCONFIGS[name](), TCONFIGS[name]()


PAIRS = list(_pairs())


def test_paper_config_macs_by_hand():
    c = paper_config()
    layer = 2 * 32 * 64 + 32 * 32 + 32 * 512
    assert layer == 21504
    assert F.stack_macs_per_position(c) == 30 * layer + 2 * 32
    assert F.head_macs_per_position(c) == 512 * 512 + 512 * 256
    assert F.forward_flops_per_position(c) == 2.0 * (
        30 * layer + 2 * 32 + 512 * 512 + 512 * 256)
    wb = F.weight_bytes(c)
    assert 4.0e6 < wb < 4.6e6
    assert F.weight_bytes(c, 2) * 2 == wb


def test_train_step_flops_scales():
    c = paper_config()
    one = F.train_step_flops(c, 1, 16000)
    assert F.train_step_flops(c, 8, 16000) == pytest.approx(8 * one)
    T = c.receptive_field + 16000
    fwd = 2 * (F.stack_macs_per_position(c) * T
               + F.head_macs_per_position(c) * 16000)
    assert one == pytest.approx(3 * fwd)


def test_device_constants():
    assert F.device_peak_flops(H100) == 989e12
    assert F.device_hbm_bytes_per_s(H100) == 3.35e12
    for other in ("Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB", "cpu",
                  "TPU v5 lite"):
        assert F.device_peak_flops(other) is None
        assert F.device_hbm_bytes_per_s(other) is None
        assert F.mfu(1e12, other) is None
    assert F.mfu(98.9e12, H100) == pytest.approx(0.1)
    assert F.mfu(None, H100) is None


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=[p[0] for p in PAIRS])
def test_counts_equal_jax(name, jc, tc):
    assert (F.forward_flops_per_position(tc)
            == JF.forward_flops_per_position(jc))
    assert F.gen_flops_per_sample(tc) == JF.gen_flops_per_sample(jc)
    for nb in (2, 4):
        assert F.weight_bytes(tc, nb) == JF.weight_bytes(jc, nb)
    for B, T in ((1, 16000), (8, 16000), (2, 777)):
        assert F.train_step_flops(tc, B, T) == JF.train_step_flops(jc, B, T)


@pytest.mark.parametrize("lc", [None, 128])
@pytest.mark.parametrize("B", [128, 256, 512])
@pytest.mark.parametrize("name", ["paper", "wide", "sharded"])
def test_stream_decode_bytes_equal_jax_without_padding(name, B, lc):
    jc = dataclasses.replace(JCONFIGS[name](), residual_channels=128,
                             dilation_channels=128, lc_channels=lc)
    tc = dataclasses.replace(TCONFIGS[name](), residual_channels=128,
                             dilation_channels=128, lc_channels=lc)
    want = JF.stream_decode_hbm_bytes_per_step(jc, B)
    assert F.stream_decode_hbm_bytes_per_step(tc, B) == want
    # The port packs no ring: ring_pack changes nothing.
    assert F.stream_decode_hbm_bytes_per_step(tc, B, ring_pack=True) == want


@pytest.mark.parametrize("lc", [None, 80])
def test_stream_decode_bytes_count_the_work(lc):
    """At the paper's widths: a ring row [B, R] float32 read and written
    per layer, the codes in and out, and the LC row."""
    c = paper_config(lc_channels=lc)
    B = 64
    want = 2 * 30 * B * 32 * 4 + 2 * B * 4 + (B * 80 * 4 if lc else 0)
    assert F.stream_decode_hbm_bytes_per_step(c, B) == want


def test_analytic_flops_match_counted_train_step():
    """The analytic count against the FLOPs that
    ``torch.utils.flop_counter`` counts in the port's train step (loss,
    backward and Adam) at the JAX test's config: within the JAX test's
    band. The counter counts the products (the convolutions and matmuls)
    only, and the causal layer's gather not at all."""
    from torch.utils.flop_counter import FlopCounterMode

    from wavenet_torch import train_lib as tl

    cfg = WaveNetConfig(dilations=(1, 2, 4, 8, 16, 32, 64, 128) * 2,
                        residual_channels=16, dilation_channels=16,
                        skip_channels=64, quantization_channels=64,
                        use_biases=True)
    B, sample_size = 2, 2000
    state = tl.create_train_state(0, cfg, tl.make_optimizer("adam", 1e-3),
                                  "cpu")
    step = tl.make_train_step(cfg, None)
    audio = torch.zeros((B, cfg.receptive_field + sample_size))
    with FlopCounterMode(display=False) as counter:
        step(state, audio)
    counted = counter.get_total_flops()
    assert counted > 0
    analytic = F.train_step_flops(cfg, B, sample_size)
    ratio = analytic / counted
    assert 0.5 < ratio < 1.5, (analytic, counted)
    assert np.isfinite(ratio)
