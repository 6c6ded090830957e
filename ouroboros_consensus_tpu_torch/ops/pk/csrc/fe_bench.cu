// Tool kernel `fe_bench`: the field-op microbenchmark (tools.cuh), one
// lane per thread, 4 independent chains of k operations each. Replaces
// the TPU A/B scripts/exp_sqr.py:bench_device.
#include "tools.cuh"

template <int OP>
__global__ void __launch_bounds__(128) fe_bench_kernel(int B, int k,
                                                       const int32_t *x,
                                                       int32_t *out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) fe_bench_lane<OP>(i, B, k, x, out);
}

// op 0: fe_mul(w, v), 1: fe_mul(w, w), 2: fe_sq(w); -1 for an unknown op
extern "C" int pk_fe_bench(int B, int op, int k, const void *x, void *out,
                           void *stream) {
  dim3 grid((B + 127) / 128), block(128);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *xi = (const int32_t *)x;
  int32_t *o = (int32_t *)out;
  if (op == 0) fe_bench_kernel<0><<<grid, block, 0, s>>>(B, k, xi, o);
  else if (op == 1) fe_bench_kernel<1><<<grid, block, 0, s>>>(B, k, xi, o);
  else if (op == 2) fe_bench_kernel<2><<<grid, block, 0, s>>>(B, k, xi, o);
  else return -1;
  return (int)cudaGetLastError();
}

extern "C" int pk_fe_bench_occupancy(int *out) {
  return pk_occupancy((const void *)fe_bench_kernel<0>, 128, 0, out);
}

// The same kernel's registers, local bytes, static shared bytes and
// max threads a block (obs/resources.py).
extern "C" int pk_fe_bench_attributes(int *out) {
  return pk_func_attributes((const void *)fe_bench_kernel<0>, out);
}
