// Fused per-worker sparse gradient for the sync SVM-family step, CUDA C++
// for Hopper (sm_90a), summed in a fixed order.
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
// written as what it is: a gather, a warp reduction and a scatter.
//
// Design: the scatter is an integer sum, so one input gives one output
// bit for bit, whatever order the threads run in (f32 atomics would sum
// in a different order on every launch).  Three kernels on one stream:
//
//   1. one warp per (k, b) sample: the lanes stride over P, gather
//      w[idx] * val and reduce with shuffles (a fixed tree); lane 0
//      applies the coefficient rule and stores c_b, and the warp stores
//      the sample's largest finite |c_b * val|.  The kernel's threads also
//      zero-fill g and the accumulator.
//   2. one warp per sample again: the warp reduces its worker's B sample
//      maxima to max_k (every warp of worker k gets the same value and
//      stores it for kernel 3).  Worker k's scale is the power of two
//      2^e_k with B*P * max_k * 2^e_k <= 2^62, so no sum of B*P scaled
//      terms can leave a signed 64-bit integer.  Each finite contribution
//      c_b * val (rounded to f32 first, as the plain version rounds it) is
//      scaled exactly in double, rounded to the nearest integer and added
//      with a 64-bit integer atomicAdd, which commutes.  A coefficient of
//      exactly 0 adds nothing: the warp leaves.  A non-finite contribution
//      (an overflowed least-squares step) is added in f32 to g itself:
//      sums of infinities and NaNs do not depend on order either.
//   3. one thread per g entry: g[k, i] += acc[k, i] * 2^-e_k, rounded once
//      from double to f32.
//
// The integer sum is exact; the only rounding is each term's, at
// 2^-e_k, which is 2^-(62 - ceil(log2(B*P))) of worker k's largest term
// (2^-49 at B*P = 7,600), and the final conversion to f32.  A feature
// whose terms cancel comes out exactly 0.0 (llrint is odd-symmetric, so
// +x and -x cancel; the plain version's f32 sums can leave a residue);
// a term below that resolution rounds to 0.
//
// The caller passes g and scratch: acc[K, D] int64, and f32 scratch of
// 2*K*B + K entries (the coefficients, the sample maxima, and each
// worker's maximum as float bits); kernel 1 zero-fills g and acc.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32).  At the RPC reply's
// shape K=1, B=100, P=76, D=47,236 the function reads 61 KB of idx/val,
// at most 30 KB of gathered w and 0.4 KB of y, and writes the 189 KB g:
// about 0.08 us of memory traffic, so one call is bound by its launches,
// not by the card.  The integer accumulator adds 2 x 8 x K x D bytes of
// scratch traffic (zero-fill and read) that the function itself does not
// need.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coeff.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kConvertThreads = 256;
constexpr int kSumBits = 62;  // |sum| <= 2^62 < 2^63

__device__ __forceinline__ bool in_row(int32_t i, float v, int D) {
  // pad entries (val 0) and out-of-range ids add nothing
  return v != 0.f && (uint32_t)i < (uint32_t)D;
}

// The exponent e_k of worker k's scale 2^e_k: with max = f * 2^E,
// f in [0.5, 1), every |term| < 2^E and terms * 2^e_k < 2^(E + e_k);
// B*P of them stay within 2^kSumBits when E + e_k + ceil(log2(B*P))
// <= kSumBits.
__device__ __forceinline__ int scale_exponent(uint32_t max_bits, int count) {
  int e_max;
  frexpf(__uint_as_float(max_bits), &e_max);
  int log2_count = 0;
  while ((1LL << log2_count) < (long long)count) ++log2_count;
  return kSumBits - e_max - log2_count;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
margins_kernel(const float* __restrict__ w, const int32_t* __restrict__ idx,
               const float* __restrict__ val, const float* __restrict__ y,
               float* __restrict__ coeff, float* __restrict__ sample_max,
               unsigned long long* __restrict__ acc, float* __restrict__ g,
               int K, int B, int P, int D, int coeff_kind) {
  const int64_t n = (int64_t)K * D;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    acc[j] = 0ull;
    g[j] = 0.f;
  }
  const int lane = threadIdx.x % kWarp;
  const int64_t sample =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (sample >= (int64_t)K * B) return;  // whole warp leaves together
  const int32_t* row_idx = idx + sample * P;
  const float* row_val = val + sample * P;

  float part = 0.f;
  for (int p = lane; p < P; p += kWarp) {
    const int32_t i = row_idx[p];
    const float v = row_val[p];
    if (in_row(i, v, D)) part += __ldg(w + i) * v;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    part += __shfl_xor_sync(0xffffffffu, part, off);

  float c = 0.f;
  if (lane == 0) c = grad_coeff(coeff_kind, part, y[sample]);
  c = __shfl_sync(0xffffffffu, c, 0);

  float big = 0.f;
  if (c != 0.f) {
    for (int p = lane; p < P; p += kWarp) {
      const int32_t i = row_idx[p];
      const float v = row_val[p];
      const float t = fabsf(c * v);
      if (in_row(i, v, D) && isfinite(t)) big = fmaxf(big, t);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
  }
  if (lane == 0) {
    coeff[sample] = c;
    sample_max[sample] = big;
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ coeff,
               const float* __restrict__ sample_max,
               uint32_t* __restrict__ max_bits,
               unsigned long long* __restrict__ acc, float* __restrict__ g,
               int K, int B, int P, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t sample =
      (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (sample >= (int64_t)K * B) return;
  const int k = (int)(sample / B);
  // worker k's largest term: a max, so the same in every warp of k
  float big = 0.f;
  for (int b = lane; b < B; b += kWarp)
    big = fmaxf(big, sample_max[(int64_t)k * B + b]);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
  const uint32_t mb = __float_as_uint(big);
  if (lane == 0 && sample % B == 0) max_bits[k] = mb;  // read by kernel 3
  const float c = coeff[sample];
  if (c == 0.f) return;  // inactive sample: every c * val is zero
  const int e = mb ? scale_exponent(mb, B * P) : 0;
  const int32_t* row_idx = idx + sample * P;
  const float* row_val = val + sample * P;
  unsigned long long* acc_k = acc + (int64_t)k * D;
  float* g_k = g + (int64_t)k * D;
  for (int p = lane; p < P; p += kWarp) {
    const int32_t i = row_idx[p];
    const float v = row_val[p];
    if (!in_row(i, v, D)) continue;
    const float t = c * v;  // rounded to f32, as the plain version's term
    if (!isfinite(t)) {
      atomicAdd(g_k + i, t);  // inf/NaN sums are order-free
      continue;
    }
    const long long q = __double2ll_rn(ldexp((double)t, e));
    if (q != 0) atomicAdd(acc_k + i, (unsigned long long)q);
  }
}

__global__ void __launch_bounds__(kConvertThreads)
convert_kernel(const unsigned long long* __restrict__ acc,
               const uint32_t* __restrict__ max_bits, float* __restrict__ g,
               int K, int B, int P, int D) {
  const int64_t n = (int64_t)K * D;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const long long s = (long long)acc[j];
    if (s == 0) continue;
    const int e = scale_exponent(max_bits[j / D], B * P);
    g[j] += (float)ldexp((double)s, -e);
  }
}

}  // namespace

// Launch the three kernels on `stream` (PyTorch's current stream).
// `scratch` holds 2*K*B + K floats.  Returns the first cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int dsgd_worker_grads(const float* w, const int32_t* idx,
                                 const float* val, const float* y, float* g,
                                 unsigned long long* acc, float* scratch,
                                 int K, int B, int P, int D, int coeff_kind,
                                 void* stream) {
  const int64_t samples = (int64_t)K * B;
  if (samples == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  float* coeff = scratch;
  float* sample_max = scratch + samples;
  uint32_t* max_bits = reinterpret_cast<uint32_t*>(scratch + 2 * samples);
  const unsigned blocks = (unsigned)((samples + kWarpsPerBlock - 1) / kWarpsPerBlock);
  margins_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
      w, idx, val, y, coeff, sample_max, acc, g, K, B, P, D, coeff_kind);
  scatter_kernel<<<blocks, kWarp * kWarpsPerBlock, 0, s>>>(
      idx, val, coeff, sample_max, max_bits, acc, g, K, B, P, D);
  const int64_t n = (int64_t)K * D;
  int64_t cblocks = (n + kConvertThreads - 1) / kConvertThreads;
  if (cblocks > 4096) cblocks = 4096;
  convert_kernel<<<(unsigned)cblocks, kConvertThreads, 0, s>>>(acc, max_bits, g, K, B, P, D);
  return (int)cudaGetLastError();
}
