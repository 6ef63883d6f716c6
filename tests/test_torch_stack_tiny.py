"""The fused stack at R = D in 1, 2, 4 against the JAX package's TPU
kernel pair.

At these widths the TPU kernel's 128-lane records still pack (its
``supports`` takes them) and ``stack_kernel_plan`` sends them to
``csrc/fused_stack_tiled.cu`` on the card, whose 64 x 64 tiles are then
mostly padding, masked at every edge, and whose rows start off 16 bytes
(4-byte copies at widths 1 and 2). On the CPU the same calls run the
plain versions; they are held against ``fused_stack3`` in interpret mode
as ``test_torch_stack_ragged.py`` holds the R != D widths (3 layers, B2 x
T150, gc on at width 2): f32 at the fused-stack tests' tolerances, bf16
by ``test_torch_stack_bf16.py``'s small rule (every product sums at most
8 terms here, so only the order of float32 sums differs: a tenth of the
gap, records within one bf16 ulp).
"""

import pytest

from test_torch_stack_ragged import DTYPES, check_backward, check_forward

CASES = pytest.mark.parametrize("W,gc", [(1, False), (2, True), (4, False)],
                                ids=["w1", "w2_gc", "w4"])


@CASES
@DTYPES
def test_forward_matches_jax_kernel(W, gc, dtype):
    check_forward(W, W, gc, dtype)


@CASES
@DTYPES
def test_backward_matches_jax_grad(W, gc, dtype):
    check_backward(W, W, gc, dtype)
