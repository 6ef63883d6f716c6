// b1_bisect_cluster: the r3 probe of the cluster decode kernel at float32
// weights (b1_bisect_cluster.cuh says what it runs and why; its bf16
// weights are b1_bisect_cluster_bf16.cu).
//
// Replaces the TPU (Pallas) probe kernel of the JAX package
//   tools/r3_b1_bisect.py:158   kernel (the b=1 sampler step, ablated)

#define SAMPLER_CLUSTER_PROBE 1

#include "b1_bisect_cluster.cuh"

B1_BISECT_CLUSTER_RUN(float, 0)
B1_BISECT_CLUSTER_CLOCK
