"""The retired training-kernel generations (counterpart of
``wavenet_tpu/experiments/``).

The JAX package kept three earlier generations of its fused training
kernels as measured negative results, out of the production surface:
v1 (``fused_stack.py``) and v2 (``fused_stack2.py``) of the whole-stack
kernel, which carry each layer's dilated-tap tail from one time tile to
the next, reached with ``use_pallas_stack`` and ``pallas_stack_version``
1 or 2; and the per-layer op ``dilated_layer.fused_dilated_layer`` with a
flash-style backward. Their ports here run on the H100 through
``csrc/fused_stack_carry.cu`` (v1 and v2) and ``csrc/dilated_layer.cu``.
The JAX package gates only its tests of these kernels (behind
``WAVENET_RUN_EXPERIMENTS=1``); the port's code and tests are not gated.
"""
