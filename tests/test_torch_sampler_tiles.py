"""The route to the port's third decode kernel (``tile_plan``, which sends
paper/gc b121 and up to ``csrc/sampler_tiles.cu``, or at bf16 weights to
``csrc/sampler_tiles_bf16.cu``, on the same plan) and the wrappers'
``kernel="tiles"``, on the CPU. The kernel itself runs on the card only
(``tests/test_torch_gpu.py``); its plain version is ``decode_reference``,
held against the JAX package in ``tests/test_torch_sampler.py``."""

import numpy as np
import pytest
import torch

from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models.config import (
    gc_config, paper_config, tiny_config, wide_config)

torch.set_num_threads(1)

# An H100 SXM: opt-in shared memory per block, and the clusters of 8 (and
# 16) CTAs it keeps resident at once (cudaOccupancyMaxActiveClusters on the
# card, as tests/test_torch_sampler_cluster.py takes them).
H100_SMEM = 232448
H100_CLUSTERS = {8: 15, 16: 7}


def h100_resident(cs, rb, nbytes):
    return H100_CLUSTERS[cs]


H100 = dict(smem_optin=H100_SMEM, resident_clusters=h100_resident,
            cluster_resident=h100_resident)


@pytest.mark.parametrize("B", [1, 2, 4, 16, 64, 100, 113, 120])
@pytest.mark.parametrize("name", ["paper", "gc"])
def test_none_where_the_cluster_kernel_runs(name, B):
    """b1-b120 keep sampler_cluster (and their codes)."""
    c = paper_config() if name == "paper" else gc_config()
    assert ks.cluster_plan(c, B, H100_SMEM, h100_resident) is not None
    assert ks.tile_plan(c, B, **H100) is None


@pytest.mark.parametrize("config", [
    wide_config(), wide_config(scalar_input=False),
    paper_config(scalar_input=True, initial_filter_width=32),
    gc_config(lc_channels=8), paper_config(filter_width=3), tiny_config(),
    paper_config(skip_channels=256), paper_config(quantization_channels=128),
    paper_config(dilations=(1, 2, 4, 8)), paper_config(dilations=(1,) * 33),
], ids=["wide", "wide_mulaw", "scalar", "lc", "fw3", "tiny", "s256", "q128",
        "l4", "l33"])
def test_none_outside_the_compiled_shape(config):
    assert not ks.tile_shape(config)
    for B in (121, 128, 256, 512):
        assert ks.tile_plan(config, B, **H100) is None


@pytest.mark.parametrize("name,B,rb", [
    ("gc", 121, 9), ("gc", 128, 9), ("gc", 135, 9), ("gc", 136, 10),
    ("gc", 256, 18), ("gc", 512, 35), ("paper", 512, 35), ("gc", 525, 35),
])
def test_rows_per_cluster_on_an_h100(name, B, rb):
    """The fewest rows a cluster that keep 15 clusters resident: RB =
    ceil(B / 15), up to 35 rows (b512's, the top: b525)."""
    c = paper_config() if name == "paper" else gc_config()
    plan = ks.tile_plan(c, B, **H100)
    assert (plan.CS, plan.RB) == (8, rb)
    assert -(-B // plan.RB) <= 15
    assert ks.tile_smem_bytes(plan.RB) <= H100_SMEM


def test_top_of_the_range_on_an_h100():
    c = gc_config()
    assert ks.tile_plan(c, 525, **H100).RB == 35
    assert ks.tile_plan(c, 526, **H100) is None
    assert ks.tile_plan(c, 600, **H100) is None
    assert ks.tile_plan(c, 1024, **H100) is None


def test_layer_split_does_not_depend_on_the_batch():
    """A row's sums follow the layer split, so it is one per config."""
    c = gc_config()
    splits = {ks.tile_plan(c, B, **H100).layer_begin
              for B in range(121, 526, 7)}
    assert splits == {ks.layer_split(30, 8)}
    assert ks.layer_split(30, 8) == (0, 4, 8, 12, 16, 20, 24, 28, 30)


def test_residency_follows_the_device_count_of_clusters():
    c = gc_config()
    seen = []

    def resident(cs, rb, nbytes):
        seen.append((cs, rb, nbytes))
        assert nbytes == ks.tile_smem_bytes(rb)
        return 14 if cs == 8 else 7
    assert ks.tile_plan(c, 480, H100_SMEM, resident,
                        cluster_resident=h100_resident).RB == 35
    assert ks.tile_plan(c, 512, H100_SMEM, resident,
                        cluster_resident=h100_resident) is None
    assert seen and all(cs == 8 for cs, _, _ in seen)
    # The cluster kernel's own count decides where its range ends.
    assert ks.tile_plan(c, 120, H100_SMEM, h100_resident,
                        cluster_resident=lambda *a: 1).RB == 8
    assert ks.tile_plan(c, 1, H100_SMEM, lambda *a: 0,
                        cluster_resident=h100_resident) is None


def test_smem_bytes_grow_with_padded_rows():
    """Rows run padded to 8 x rows a thread (at least 2): 16, 24, 32, 40
    (RB 33-35)."""
    sizes = [ks.tile_smem_bytes(rb) for rb in ks.TILE_ROWS]
    assert len(set(sizes[:16])) == 1 and len(set(sizes[16:24])) == 1
    assert sizes == sorted(sizes)
    assert len(set(sizes)) == 4
    assert ks.tile_smem_bytes(35) == 223088 <= H100_SMEM
    # A smaller opt-in ends the range earlier.
    assert ks.tile_plan(gc_config(), 512, ks.tile_smem_bytes(24),
                        h100_resident, h100_resident) is None
    assert ks.tile_plan(gc_config(), 360, ks.tile_smem_bytes(24),
                        h100_resident, h100_resident).RB == 24


@pytest.mark.parametrize("sequential", [False, True])
def test_wrappers_run_the_plain_version_on_the_cpu(sequential):
    """``kernel="tiles"`` on CPU tensors is ``decode_reference``, at float32
    and at bf16 weights (the chain rounded on both routes at B = 3), and
    the CPU launches no kernel."""
    c = paper_config(dilations=(1, 2, 4, 8, 16, 32, 1, 2), skip_channels=64,
                     quantization_channels=64)
    from wavenet_torch.models.wavenet import init_params
    params = init_params(0, c, device="cpu")
    B = 3
    rng = np.random.RandomState(0)
    forced = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, 4)),
                             dtype=torch.int32)
    before = (ks.decode.launches, dict(ks.decode.launches_by),
              ks.decode_sequential.launches)
    logits = {}
    for wt in (torch.float32, torch.bfloat16):
        packed = ks.pack_sampler_weights(params, c, B, weight_dtype=wt)
        ring_r, causal_r = ks.zero_state(c, B)
        codes_r, lg_r = ks.decode_reference(packed, c, ring_r, causal_r,
                                            forced, 6, 0, 3, collect_logits=3,
                                            round_chain=True)
        if sequential:
            codes, lg = ks.decode_sequential(packed, c, forced, 6, 3,
                                             collect_logits=3, kernel="tiles")
        else:
            ring, causal = ks.zero_state(c, B)
            codes, lg = ks.decode(packed, c, ring, causal, forced, 6, 0, 3,
                                  collect_logits=3, kernel="tiles")
            assert torch.equal(ring, ring_r) and torch.equal(causal, causal_r)
        assert torch.equal(codes, codes_r) and torch.equal(lg, lg_r)
        logits[wt] = lg
    assert not torch.equal(logits[torch.float32], logits[torch.bfloat16])
    assert (ks.decode.launches, dict(ks.decode.launches_by),
            ks.decode_sequential.launches) == before
    assert "tiles" in ks.KERNEL_CHOICES
