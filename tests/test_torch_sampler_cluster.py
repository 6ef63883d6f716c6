"""The route between the port's two decode kernels (``cluster_plan``) and
the wrappers' kernel choice, on the CPU. The cluster kernel itself runs
on the card only (``tests/test_torch_gpu.py``); its plain version is
``decode_reference``, held against the JAX package in
``tests/test_torch_sampler.py``."""

import numpy as np
import pytest
import torch

from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models.config import (
    WaveNetConfig, gc_config, paper_config, sharded_config, tiny_config,
    wide_config)

torch.set_num_threads(1)

# An H100 SXM: opt-in shared memory per block (232,448 bytes), and the
# clusters it keeps resident at once as cudaOccupancyMaxActiveClusters
# reported them on the card at the paper and wide widths' cluster sizes
# (15 of 8 CTAs, 7 of 16: one CTA an SM, and a cluster within one GPC).
H100_SMEM = 232448
H100_CLUSTERS = {8: 15, 16: 7}


def h100_resident(cs, rb, nbytes):
    return H100_CLUSTERS[cs]


H100 = dict(smem_optin=H100_SMEM, resident_clusters=h100_resident)


def spread(n_sm):
    """A device of n_sm SMs that keeps one CTA an SM and places a cluster
    on any CS of them."""
    return lambda cs, rb, nbytes: n_sm // cs


CONFIGS = {"paper": paper_config(), "gc": gc_config(), "wide": wide_config(),
           "tiny": tiny_config()}
BATCHES = (1, 2, 4, 7, 32, 64, 100, 128, 256, 512, 1000)


def _plans():
    for name, c in CONFIGS.items():
        for B in BATCHES:
            for n_sm, smem in ((132, 232448), (16, 232448), (132, 101376)):
                yield name, c, B, n_sm, smem


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layer_ranges_cover_the_stack_in_order(name):
    c = CONFIGS[name]
    for B in BATCHES:
        plan = ks.cluster_plan(c, B, H100_SMEM, spread(132))
        if plan is None:
            continue
        lb = plan.layer_begin
        assert len(lb) == plan.CS + 1
        assert lb[0] == 0 and lb[-1] == c.num_layers
        assert all(b > a for a, b in zip(lb, lb[1:]))
        sizes = [b - a for a, b in zip(lb, lb[1:])]
        assert max(sizes) == -(-c.num_layers // plan.CS)
        assert sizes == sorted(sizes, reverse=True)


def test_every_cta_fits_and_every_cluster_is_resident():
    seen = 0
    for name, c, B, n_sm, smem in _plans():
        plan = ks.cluster_plan(c, B, smem, spread(n_sm))
        if plan is None:
            continue
        seen += 1
        assert plan.CS in ks.CLUSTER_SIZES and plan.RB in ks.CLUSTER_ROWS
        assert ks.cluster_smem_bytes(c, plan.CS, plan.RB) <= smem, (name, B)
        assert -(-B // plan.RB) * plan.CS <= n_sm, (name, B)
        assert c.skip_channels % plan.CS == 0
        assert c.quantization_channels % (4 * plan.CS) == 0
    assert seen > 50


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cluster_size_does_not_depend_on_the_batch(name):
    """A row's sums follow the layer split and the head's column split,
    so CS (and with it the split) is one per config and device."""
    c = CONFIGS[name]
    for n_sm, smem in ((132, 232448), (132, 101376)):
        plans = [ks.cluster_plan(c, B, smem, spread(n_sm))
                 for B in BATCHES]
        sizes = {p.CS for p in plans if p is not None}
        splits = {p.layer_begin for p in plans if p is not None}
        assert len(sizes) <= 1 and len(splits) <= 1


@pytest.mark.parametrize("name,B,want", [
    ("paper", 1, (8, 1)),
    ("gc", 1, (8, 1)),
    ("gc", 4, (8, 1)),
    ("gc", 64, (8, 5)),
    ("gc", 120, (8, 8)),
    ("gc", 128, None),
    ("gc", 256, None),
    ("gc", 512, None),
    ("wide", 1, (16, 1)),
    ("wide", 28, (16, 4)),
    ("wide", 32, None),
    ("wide", 64, None),
])
def test_route_on_an_h100(name, B, want):
    plan = ks.cluster_plan(CONFIGS[name], B, **H100)
    if want is None:
        assert plan is None
    else:
        assert (plan.CS, plan.RB) == want
        assert plan.layer_begin == ks.layer_split(30, want[0])


def test_rows_per_cluster_are_the_fewest_that_stay_resident():
    c = CONFIGS["gc"]
    assert [ks.cluster_plan(c, B, **H100).RB
            for B in (15, 16, 30, 31, 64, 65, 100, 113)] \
        == [1, 2, 2, 3, 5, 5, 7, 8]


def test_residency_follows_the_device_count_of_clusters():
    """The rows a cluster follow the count of resident clusters the
    device gives for the plan's CS, RB and shared memory."""
    c = CONFIGS["gc"]
    seen = []

    def resident(cs, rb, nbytes):
        seen.append((cs, rb, nbytes))
        assert nbytes == ks.cluster_smem_bytes(c, cs, rb)
        return 14
    assert ks.cluster_plan(c, 64, H100_SMEM, resident).RB == 5
    assert seen and all(cs == 8 for cs, _, _ in seen)
    assert ks.cluster_plan(c, 112, H100_SMEM, resident).RB == 8
    assert ks.cluster_plan(c, 113, H100_SMEM, resident) is None
    assert ks.cluster_plan(c, 1, H100_SMEM, lambda *a: 0) is None
    # 16 clusters of 8 CTAs fit 132 SMs, but an H100 keeps only 15
    # resident: gc b64 at 4 rows a cluster would run in two waves.
    assert ks.cluster_plan(c, 64, H100_SMEM, spread(132)).RB == 4


def test_none_where_the_chain_does_not_fit():
    # R = D = 256: 1.3 MB of chain weights a layer; 16 CTAs cannot hold it.
    assert ks.cluster_plan(sharded_config(), 1, **H100) is None
    # 30 layers at R = D = 96: 184 KB a layer, two a CTA at CS = 16.
    too_wide = paper_config(residual_channels=96, dilation_channels=96)
    assert all(ks.cluster_smem_bytes(too_wide, cs, 1) > H100_SMEM
               for cs in ks.CLUSTER_SIZES)
    assert ks.cluster_plan(too_wide, 1, **H100) is None
    # Other filter widths and LC route like sampler_decode: not at all.
    assert ks.cluster_plan(tiny_config(filter_width=3), 1, **H100) is None


def test_smem_bytes_grow_with_rows_and_shrink_with_cluster_size():
    c = CONFIGS["paper"]
    assert ks.cluster_smem_bytes(c, 8, 1) < ks.cluster_smem_bytes(c, 8, 8)
    assert ks.cluster_smem_bytes(c, 8, 4) < ks.cluster_smem_bytes(c, 4, 4)
    # Paper: 4 layers of filter/gate (16 KB) and dense (4 KB) weights a CTA.
    chain = 4 * 4 * (4 * 32 * 32 + 32 * 32 + 32)
    assert chain < ks.cluster_smem_bytes(c, 8, 1) < chain + 16 * 1024


@pytest.mark.parametrize("kernel", ["auto", "cluster", "decode"])
def test_wrappers_take_a_kernel_and_run_the_plain_version_on_the_cpu(kernel):
    c = tiny_config()
    from wavenet_torch.models.wavenet import init_params
    params = init_params(0, c, device="cpu")
    B = 2
    packed = ks.pack_sampler_weights(params, c, B)
    rng = np.random.RandomState(0)
    forced = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, 3)),
                             dtype=torch.int32)
    ring, causal = ks.zero_state(c, B)
    before = (ks.decode.launches, dict(ks.decode.launches_by))
    codes, lg = ks.decode(packed, c, ring, causal, forced, 5, 0, 3,
                          collect_logits=2, kernel=kernel)
    ring_r, causal_r = ks.zero_state(c, B)
    codes_r, lg_r = ks.decode_reference(packed, c, ring_r, causal_r, forced,
                                        5, 0, 3, collect_logits=2)
    assert torch.equal(codes, codes_r) and torch.equal(lg, lg_r)
    # The counts are of kernel launches: the CPU launches none.
    assert (ks.decode.launches, dict(ks.decode.launches_by)) == before
    seq, _ = ks.decode_sequential(packed, c, forced, 5, 3, kernel=kernel)
    assert torch.equal(seq, codes_r)


def test_wrappers_reject_an_unknown_kernel():
    c = tiny_config()
    ring, causal = ks.zero_state(c, 1)
    with pytest.raises(ValueError, match="kernel"):
        ks.decode(None, c, ring, causal, torch.zeros((1, 1), dtype=torch.int32),
                  1, 0, 0, kernel="scan")
    with pytest.raises(ValueError, match="kernel"):
        ks.decode_sequential(None, c, torch.zeros((1, 1), dtype=torch.int32),
                             1, 0, kernel="fast")


def test_decode_turns_tool_refuses_the_cpu():
    """``python -m wavenet_torch.tools.decode_turns`` takes the cluster
    kernel's digests and times in a process of its own for each checkout,
    on the card; without one it fails rather than run anything else."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "wavenet_torch.tools.decode_turns", "--trees",
         root, "--reps", "1"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "needs a CUDA GPU" in proc.stderr
