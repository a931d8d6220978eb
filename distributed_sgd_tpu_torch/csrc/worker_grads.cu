// Fused per-worker sparse gradient for the sync SVM-family step, CUDA C++
// for Hopper (sm_90a).
//
// Replaces: distributed_sgd_tpu/ops/pallas_sparse.py::worker_grads (the
// Pallas TPU kernel _worker_grad_kernel, grid (K,)).  For each worker k and
// each of its B padded rows x_b (P (index, value) pairs):
//
//     m_b = x_b . w                       margin (gather)
//     c_b = coeff(m_b, y_b)               hinge / logistic / least squares
//     g_k = sum_b c_b * x_b               gradient sum (scatter-add)
//
// The TPU kernel builds one-hot operands and runs both sides as MXU
// matmuls because the TPU has no fast scatter.  Here the function is
// written as what it is: a gather, a warp reduction and atomic adds.
//
// Design.  One warp per (k, b) sample.  The lanes stride over P, gather
// w[idx] * val and reduce with shuffles; lane 0 applies the coefficient
// rule and broadcasts it; each lane then atomically adds c * val into
// g[k, idx] for its nonzero entries.  Pad entries (idx 0, val 0, y 0) add
// nothing.  g is zero-filled by the caller; the kernel allocates nothing.
// Atomic adds make the float summation order vary from run to run.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32).  At the main-path
// shape K=3, B=100, P=76, D=47,236 the kernel reads 182 KB of idx/val, at
// most 91 KB of gathered w and 1.2 KB of y, and the function writes the
// 567 KB g[K, D]: about 0.25 us of memory traffic and ~0.1 MFLOP, so one
// launch is bound by launch latency, not by the card.  sync_epoch.cu runs
// a whole epoch's steps in one launch where the state fits a cluster; this
// kernel serves the per-step path for the shapes that do not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coeff.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
worker_grads_kernel(const float* __restrict__ w, const int32_t* __restrict__ idx,
                    const float* __restrict__ val, const float* __restrict__ y,
                    float* __restrict__ g, int K, int B, int P, int D,
                    int coeff_kind) {
  const int lane = threadIdx.x % kWarp;
  const int64_t sample =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (sample >= (int64_t)K * B) return;  // whole warp leaves together
  const int k = (int)(sample / B);
  const int32_t* row_idx = idx + sample * P;
  const float* row_val = val + sample * P;

  float part = 0.f;
  for (int p = lane; p < P; p += kWarp) {
    const int32_t i = row_idx[p];
    const float v = row_val[p];
    // out-of-range ids are skipped here and in the scatter below
    if (v != 0.f && (uint32_t)i < (uint32_t)D) part += __ldg(w + i) * v;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    part += __shfl_xor_sync(0xffffffffu, part, off);

  float c = 0.f;
  if (lane == 0) c = grad_coeff(coeff_kind, part, y[sample]);
  c = __shfl_sync(0xffffffffu, c, 0);
  if (c == 0.f) return;  // inactive sample: every c * val is zero

  float* gk = g + (int64_t)k * D;
  for (int p = lane; p < P; p += kWarp) {
    const int32_t i = row_idx[p];
    const float v = row_val[p];
    if (v != 0.f && (uint32_t)i < (uint32_t)D) atomicAdd(gk + i, c * v);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Returns the launch's
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int dsgd_worker_grads(const float* w, const int32_t* idx,
                                 const float* val, const float* y, float* g,
                                 int K, int B, int P, int D, int coeff_kind,
                                 void* stream) {
  const int64_t samples = (int64_t)K * B;
  if (samples == 0) return (int)cudaSuccess;
  const int64_t blocks = (samples + kWarpsPerBlock - 1) / kWarpsPerBlock;
  worker_grads_kernel<<<(unsigned)blocks, kWarp * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(w, idx, val, y, g, K, B, P, D,
                                                coeff_kind);
  return (int)cudaGetLastError();
}
