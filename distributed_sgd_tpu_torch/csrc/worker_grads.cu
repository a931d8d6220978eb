// Fused per-worker sparse gradient for the sync SVM-family step, CUDA C++
// for Hopper (sm_90a): one launch a call, each worker's integer sums in
// shared memory, summed in a fixed order.
//
// Replaces: distributed_sgd_tpu/ops/pallas_sparse.py::worker_grads (the
// Pallas TPU kernel _worker_grad_kernel, grid (K,)).  For each worker k and
// each of its B padded rows x_b (P (index, value) pairs):
//
//     m_b = x_b . w                       margin (gather)
//     c_b = coeff(m_b, y_b)               hinge / logistic / least squares,
//                                         or a model's own rule (coeff.cuh)
//     g_k = sum_b c_b * x_b               gradient sum (scatter-add)
//
// The TPU kernel builds one-hot operands and runs both sides as MXU
// matmuls because the TPU has no fast scatter.  Here the function is
// written as what it is: a gather, a warp reduction and a scatter.
//
// What bounds it.  At the RPC reply's shape (K=1, B=100, P=76, D=47,236)
// the function reads 61 KB of idx/val, at most 30 KB of gathered w and
// 0.4 KB of y, and writes the 189 KB g: about 0.08 us at 3.35 TB/s.  So a
// call is bound by one launch's latency and the chains of dependent loads
// (idx, then w) in the margins, not by bytes.  The design spends nothing
// it need not:
//
// - One launch, K x R ordinary blocks (block k * R + r), no cluster and no
//   communication between blocks.  Block (k, r) owns worker k's features
//   [r * span, (r + 1) * span) and keeps their 64-bit integer sums in its
//   own shared memory (8 B a feature, 6,144 features at most), so there is
//   no accumulator in device memory, no zero-fill pass and no global
//   atomic on a finite term; g is written once, coalesced.
//   ops/worker_grads.py::launch_plan picks R, span and the shared bytes;
//   the entry point refuses a plan it cannot run.
// - Each block computes all B margins of its worker itself, through L2
//   (7,600 gathers at the RPC shape): redundant across the R blocks of a
//   worker, and cheaper than a second launch or a grid-wide sync.  One
//   warp a sample, lanes striding over p, the fixed shuffle tree and the
//   coefficient from lane 0, the same expressions as the three-kernel
//   route this kernel replaced, so every block gets the c_b that route
//   got; a warp takes 4 samples at once so that their loads overlap.
// - The same warp gives its samples' largest finite |c_b * v|: rounding
//   is monotonic, so that is |c_b| times the row's largest |v|, rounded
//   (the row is read again only where that overflows).  Each block
//   reduces its worker's maximum itself (a max, so the same in every
//   block of k), giving the scale 2^e_k with B*P * max_k * 2^e_k <= 2^62:
//   no sum of B*P scaled terms can leave a signed 64-bit integer.
// - The scatter walks the worker's entries, 8 a thread loaded at once.
//   Each finite term c_b * v (rounded to f32 first, as the plain version
//   rounds it) that lands in the block's range is scaled exactly in
//   double, rounded to the nearest integer and added in shared memory as
//   two native 32-bit atomics with the carry (add_to_sum), an exact
//   64-bit add that commutes.  A coefficient of exactly 0 adds nothing.
// - Each owned sum becomes (float)(s * 2^-e_k), rounded once, added to
//   the f32 sum of the feature's non-finite terms (0 when it has none),
//   and stored.  A non-finite term (an overflowed least-squares step) is
//   rare: it sets a flag, and the flagged block alone runs a side pass
//   that sums those terms in f32 in its shared memory.  Sums of
//   infinities and NaNs do not depend on order.
// - A model's own rule (the Pallas kernel's coeff_fn) is compiled into a
//   variant of this file with DSGD_USER_COEFF (coeff.cuh, ops/_build.py);
//   nothing else changes: the scale already comes from the terms' own
//   largest finite |c_b * v|, so the rule needs no bound, and its
//   non-finite terms take the side pass as any others.
// - A block keeps at most `cap` coefficients (launch_plan's chunk of
//   samples); past B = cap it computes each chunk's coefficients again
//   before scattering it, with the same code, so they come out the same.
//
// The integer sum is exact; the only rounding is each term's, at
// 2^-e_k, which is 2^-(62 - ceil(log2(B*P))) of worker k's largest term
// (2^-49 at B*P = 7,600), and the final conversion to f32.  So the output
// is the three-kernel route's bit for bit.  A feature whose terms cancel
// comes out exactly 0.0 (llrint is odd-symmetric, so +x and -x cancel;
// the plain version's f32 sums can leave a residue); a term below that
// resolution rounds to 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "coeff.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;
constexpr int kBatch = 4;  // samples a warp takes at once in the margins
constexpr int kRowIters = 2;  // ... and entries a lane of each holds at once
constexpr int kPerThread = 8;  // entries a thread holds at once in a walk
constexpr int kSumBits = 62;  // |sum| <= 2^62 < 2^63
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool in_row(int32_t i, float v, int D) {
  // pad entries (val 0) and out-of-range ids add nothing
  return v != 0.f && (uint32_t)i < (uint32_t)D;
}

// The exponent e_k of worker k's scale 2^e_k: with max = f * 2^E,
// f in [0.5, 1), every |term| < 2^E and terms * 2^e_k < 2^(E + e_k);
// B*P of them stay within 2^kSumBits when E + e_k + ceil(log2(B*P))
// <= kSumBits.
__device__ __forceinline__ int scale_exponent(uint32_t max_bits, long long count) {
  int e_max;
  frexpf(__uint_as_float(max_bits), &e_max);
  int log2_count = 0;
  while ((1LL << log2_count) < count) ++log2_count;
  return kSumBits - e_max - log2_count;
}

// Adds q to the 64-bit sum in `slot` (its low word first) with two 32-bit
// shared-memory atomics, which cost less than one 64-bit shared atomicAdd
// here: the low word's carry goes into the high word, so the pair holds
// the exact sum modulo 2^64 whatever the order of the adds.
__device__ __forceinline__ void add_to_sum(unsigned long long* slot, long long q) {
  unsigned int* word = reinterpret_cast<unsigned int*>(slot);
  const unsigned int lo = (unsigned int)q;
  const unsigned int old = atomicAdd(word, lo);
  const unsigned int hi = (unsigned int)((unsigned long long)q >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(word + 1, hi);
}

// Coefficients of samples [base, base + m) of the worker whose first row
// is `first`, into coeffs[0, m): one warp a sample, lanes striding over
// the row, gathering w[idx] * val and reducing with a fixed shuffle tree;
// lane 0 applies the coefficient rule.  A warp takes kBatch samples at
// once so that their loads are in flight together; each sample's sum is
// taken in the same order as when one warp takes one sample.  Returns
// the largest finite |c * v| of the warp's samples (every lane the same):
// rounding is monotonic, so it is |c| times the row's largest in-row |v|,
// rounded, unless that overflows; then the row is read again for its
// largest finite term.
__device__ __forceinline__ float fill_coeffs(float* coeffs, const float* __restrict__ w,
                                             const int32_t* __restrict__ idx,
                                             const float* __restrict__ val,
                                             const float* __restrict__ y, int64_t first,
                                             int base, int m, int P, int D, int coeff_kind,
                                             int warp, int lane) {
  float big = 0.f;
  for (int b0 = warp; b0 < m; b0 += kWarps * kBatch) {
    float part[kBatch], vmax[kBatch];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) part[s] = vmax[s] = 0.f;
    for (int p0 = lane; p0 < P; p0 += kWarp * kRowIters) {
      int32_t ii[kBatch][kRowIters];
      float vv[kBatch][kRowIters];
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
#pragma unroll
        for (int t = 0; t < kRowIters; ++t) {
          const int b = b0 + s * kWarps;
          const int p = p0 + t * kWarp;
          const bool ok = b < m && p < P;
          const int64_t at = (first + base + b) * P + p;
          ii[s][t] = ok ? idx[at] : 0;
          vv[s][t] = ok ? val[at] : 0.f;
        }
      float ww[kBatch][kRowIters];
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
#pragma unroll
        for (int t = 0; t < kRowIters; ++t)
          ww[s][t] = in_row(ii[s][t], vv[s][t], D) ? __ldg(w + ii[s][t]) : 0.f;
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
#pragma unroll
        for (int t = 0; t < kRowIters; ++t)
          if (in_row(ii[s][t], vv[s][t], D)) {
            part[s] += ww[s][t] * vv[s][t];
            vmax[s] = fmaxf(vmax[s], fabsf(vv[s][t]));
          }
    }
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int b = b0 + s * kWarps;  // the same in every lane
      if (b >= m) break;
      const int64_t row = first + base + b;
      float x = part[s], vm = vmax[s];
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
        vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, off));
      }
      float c = 0.f;
      if (lane == 0) c = grad_coeff(coeff_kind, x, y[row]);
      c = __shfl_sync(0xffffffffu, c, 0);
      if (lane == 0) coeffs[b] = c;
      if (c == 0.f) continue;  // inactive sample: every c * val is zero
      float t = fabsf(c * vm);
      if (!isfinite(t)) {  // a term overflowed (or c is NaN): the largest finite one
        t = 0.f;
        for (int p = lane; p < P; p += kWarp) {
          const int32_t i = idx[row * P + p];
          const float v = val[row * P + p];
          const float u = fabsf(c * v);
          if (in_row(i, v, D) && isfinite(u)) t = fmaxf(t, u);
        }
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2)
          t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, off));
      }
      big = fmaxf(big, t);
    }
  }
  return big;
}

// The entries of samples [base, base + m): each thread takes kPerThread of
// them at once, a block's width apart, loading all before using any
// (m * P + kThreads * kPerThread fits an int: launch_plan bounds cap).
// Calls fn(c, i, v) for each in-row entry of a sample whose coefficient is
// not 0 (an inactive sample: every c * val is zero).
template <typename Fn>
__device__ __forceinline__ void for_entries(const float* coeffs, const int32_t* __restrict__ idx,
                                            const float* __restrict__ val, int64_t row0, int m,
                                            int P, int D, Fn fn) {
  const int32_t* chunk_idx = idx + row0 * P;
  const float* chunk_val = val + row0 * P;
  const int total = m * P;
  const int rows_per_step = kThreads / P, rest_per_step = kThreads % P;
  for (int at0 = threadIdx.x; at0 < total; at0 += kThreads * kPerThread) {
    int32_t ii[kPerThread];
    float vv[kPerThread], cc[kPerThread];
    int b = at0 / P, r = at0 % P;  // the sample and place of entry at, kept up to date
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int at = at0 + j * kThreads;
      const bool ok = at < total;
      ii[j] = ok ? chunk_idx[at] : 0;
      vv[j] = ok ? chunk_val[at] : 0.f;
      cc[j] = ok ? coeffs[b] : 0.f;
      b += rows_per_step;
      r += rest_per_step;
      if (r >= P) {
        r -= P;
        ++b;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (cc[j] != 0.f && in_row(ii[j], vv[j], D)) fn(cc[j], ii[j], vv[j]);
  }
}

// Dynamic shared memory: sums[span] (int64), coeffs[cap] (f32), then two
// words: worker k's largest finite |term| (float bits) and the non-finite
// flag.  No static __shared__.
__global__ void __launch_bounds__(kThreads)
worker_grads_kernel(const float* __restrict__ w, const int32_t* __restrict__ idx,
                    const float* __restrict__ val, const float* __restrict__ y,
                    float* __restrict__ g, int B, int P, int D, int coeff_kind,
                    int ranges, int span, int cap) {
  extern __shared__ unsigned long long sums[];
  float* coeffs = reinterpret_cast<float*>(sums + span);
  unsigned int* max_bits = reinterpret_cast<unsigned int*>(coeffs + cap);
  int* nonfinite = reinterpret_cast<int*>(max_bits + 1);

  const int k = blockIdx.x / ranges;
  const int lo = (blockIdx.x % ranges) * span;
  const int n = min(span, D - lo);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t first = (int64_t)k * B;  // worker k's first sample

  for (int j = threadIdx.x; j < n; j += kThreads) sums[j] = 0ull;
  if (threadIdx.x == 0) {
    *max_bits = 0u;
    *nonfinite = 0;
  }
  __syncthreads();

  // every sample's coefficient, a chunk of `cap` at a time (kept for the
  // scatter where B <= cap), and the worker's largest finite |c * v|
  float big = 0.f;
  for (int base = 0; base < B; base += cap) {
    big = fmaxf(big, fill_coeffs(coeffs, w, idx, val, y, first, base, min(cap, B - base), P, D,
                                 coeff_kind, warp, lane));
  }
  // non-negative floats order as their bits
  if (lane == 0 && big > 0.f) atomicMax(max_bits, __float_as_uint(big));
  __syncthreads();
  const uint32_t mb = *max_bits;
  const int e = mb ? scale_exponent(mb, (long long)B * P) : 0;
  const double scale = ldexp(1.0, e), unscale = ldexp(1.0, -e);  // exact powers of two

  // the scatter into the block's range: t * 2^e is exact in double, as
  // ldexp((double)t, e) is
  for (int base = 0; base < B; base += cap) {
    const int m = min(cap, B - base);
    if (B > cap) {
      __syncthreads();
      fill_coeffs(coeffs, w, idx, val, y, first, base, m, P, D, coeff_kind, warp, lane);
      __syncthreads();
    }
    for_entries(coeffs, idx, val, first + base, m, P, D, [&](float c, int32_t i, float v) {
      const uint32_t off = (uint32_t)(i - lo);
      if (off >= (uint32_t)n) return;  // another block's feature
      const float t = c * v;  // rounded to f32, as the plain version's term
      if (!isfinite(t)) {
        *nonfinite = 1;
        return;
      }
      const long long q = __double2ll_rn((double)t * scale);
      if (q != 0) add_to_sum(sums + off, q);
    });
  }
  __syncthreads();

  float* g_k = g + (int64_t)k * D + lo;
  // the finite part of a feature, s * 2^-e rounded once to f32: -0 where
  // nothing finite landed, so that adding it leaves the non-finite part
  // (or +0) as it is
  auto finite_part = [&](int j) {
    const long long s = (long long)sums[j];
    return s == 0 ? -0.f : (float)((double)s * unscale);
  };
  if (!*nonfinite) {
    for (int j = threadIdx.x; j < n; j += kThreads) g_k[j] = __fadd_rn(0.f, finite_part(j));
    return;
  }

  // side pass: each slot becomes (non-finite sum, finite part) in f32
  float2* pairs = reinterpret_cast<float2*>(sums);
  for (int j = threadIdx.x; j < n; j += kThreads) pairs[j] = make_float2(0.f, finite_part(j));
  for (int base = 0; base < B; base += cap) {
    const int m = min(cap, B - base);
    if (B > cap) {
      __syncthreads();
      fill_coeffs(coeffs, w, idx, val, y, first, base, m, P, D, coeff_kind, warp, lane);
    }
    __syncthreads();
    for_entries(coeffs, idx, val, first + base, m, P, D, [&](float c, int32_t i, float v) {
      const uint32_t off = (uint32_t)(i - lo);
      const float t = c * v;
      if (off < (uint32_t)n && !isfinite(t)) atomicAdd(&pairs[off].x, t);  // order-free
    });
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) g_k[j] = __fadd_rn(pairs[j].x, pairs[j].y);
}

// Per device, once: the largest dynamic shared memory a block may ask for,
// set on the kernel, and the kernel's static shared bytes.
struct DeviceSetup {
  std::atomic<int> ready{0};
  int smem_optin = 0;
  int static_smem = 0;
};
DeviceSetup g_setup[kMaxDevices];
std::mutex g_setup_lock;

cudaError_t setup_device(int dev, const DeviceSetup** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup& s = g_setup[dev];
  if (!s.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> hold(g_setup_lock);
    if (!s.ready.load(std::memory_order_relaxed)) {
      int optin = 0;
      cudaFuncAttributes attr;
      cudaError_t err =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, worker_grads_kernel);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(worker_grads_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin - (int)attr.sharedSizeBytes);
      if (err != cudaSuccess) return err;
      s.smem_optin = optin;
      s.static_smem = (int)attr.sharedSizeBytes;
      s.ready.store(1, std::memory_order_release);
    }
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

// Launch the kernel on `stream` (PyTorch's current stream) on the current
// device, with the plan of ops/worker_grads.py::launch_plan: `ranges`
// blocks a worker, each owning `span` features, keeping `cap`
// coefficients, with `smem_bytes` of dynamic shared memory.  Returns the
// first cudaError_t (0 on success); cudaErrorInvalidValue for a plan
// that does not cover [0, D) exactly once or does not fit a block.  The
// caller raises on anything but 0.
extern "C" int dsgd_worker_grads(const float* w, const int32_t* idx,
                                 const float* val, const float* y, float* g,
                                 int K, int B, int P, int D, int coeff_kind,
                                 int ranges, int span, int cap, int smem_bytes,
                                 void* stream) {
  if (K == 0 || B == 0 || D == 0) return (int)cudaSuccess;
#ifdef DSGD_USER_COEFF
  if (coeff_kind != kUserCoeff) return (int)cudaErrorInvalidValue;  // the variant's one rule
#else
  if (coeff_kind < 0 || coeff_kind >= kUserCoeff) return (int)cudaErrorInvalidValue;
#endif
  if (K < 0 || B < 0 || P < 0 || D < 0 || ranges < 1 || span < 1 || cap < 1 ||
      (int64_t)K * ranges > INT32_MAX ||
      (int64_t)cap * P > INT32_MAX - kThreads * kPerThread || (int64_t)ranges * span < D ||
      (int64_t)(ranges - 1) * span >= D ||
      (int64_t)smem_bytes != 8 * (int64_t)span + 4 * (int64_t)cap + 8)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const DeviceSetup* setup = nullptr;
  err = setup_device(dev, &setup);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes + setup->static_smem > setup->smem_optin) return (int)cudaErrorInvalidValue;
  worker_grads_kernel<<<(unsigned)(K * ranges), kThreads, (size_t)smem_bytes,
                        (cudaStream_t)stream>>>(w, idx, val, y, g, B, P, D, coeff_kind, ranges,
                                                span, cap);
  return (int)cudaGetLastError();
}
