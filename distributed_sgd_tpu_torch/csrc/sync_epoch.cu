// S whole synchronous SGD steps in one launch, CUDA C++ for Hopper (sm_90a).
//
// Replaces, on the sync engine's main path, the Pallas TPU kernel
// distributed_sgd_tpu/ops/pallas_sparse.py:154 (worker_grads) together with
// the XLA ops around it in the JAX engine's step (parallel/sync.py
// _one_step): for each step s with sample ids ids[s] of shape [K, B],
//
//     g_k  = sum_b coeff(x_b . w, y_b) * x_b          per worker k
//     g_k += reg(g_k, w)                              dim_sparsity | l2 | none
//     w    = w - lr * (sum_k g_k) / n_total_workers
//
// where reg is 1[g_k != 0] * 2*lam*(w . dim_sparsity) for dim_sparsity and
// 2*lam*w for l2.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32).  At the main path's
// shape (K=3, B=100, P=76, D=47,236, 2,146 steps an epoch) the state a step
// reads and writes is small: w 188,944 B, dim_sparsity 188,944 B and the
// per-worker sums g[3, D] 566,832 B.  Only the sampled rows must come from
// HBM: 300 rows x 76 x 8 B plus ids and labels, about 186 KB a step and
// 400 MB an epoch, or about 0.12 ms; the operations (about 1.4 GFLOP, most
// of it the dense update sweep) take about 21 us.  So the bound is bytes.
// One step of the per-step path is about 12 small launches, each costing
// host time, and round trips the dense [K, D] sums through HBM.
//
// Design.  One thread-block cluster of 8 blocks runs the whole epoch.
// Block r owns the features i with i % 8 == r: its entries of w,
// dim_sparsity and each g[k, .].  It loads them into shared memory once,
// keeps them there for every step, and writes w_out once at the end.
// Other blocks reach them through distributed shared memory
// (cluster.map_shared_rank).  Ownership is cyclic, not by contiguous
// slices: where feature popularity follows the index (term ids ranked by
// frequency, as in the synthetic RCV1 rows), the first slice would take
// most of every step's remote loads and atomics.  Each step:
//   phase A  16 lanes take one sample (k, b); the cluster holds 512
//            samples at once, so at K*B <= 512 every sample is in flight
//            together.  The lanes hold the row's entries in registers,
//            loaded straight from HBM (no idx[ids] copy) during the last
//            step's phase B; they gather w[i] * v from the owners' shared
//            memory, reduce with shuffles, apply the coefficient
//            (coeff.cuh) and atomically add c * v into the owners' g[k, i];
//   cluster.sync()  (arrive.release / wait.acquire: the remote atomics are
//            visible to their owners);
//   phase B  each block sweeps its own entries densely, four at a time:
//            the regularizer, the sum over workers, the mean and the
//            update; it zeroes g and sums its partial of w . dim_sparsity
//            for the next step's scalar.  Every block adds the cluster's
//            partials in rank order, so the scalar is the same in every
//            block;
//   cluster.sync().
// w is read only from shared memory, never through the non-coherent
// (__ldg) path: the kernel writes it between steps.  The input w is never
// written; the caller allocates w_out.  The time goes to latency, not to
// the bound: the two cluster barriers, the remote loads and the remote
// atomics of each step (PERF.md).
//
// Atomic adds make the float summation order of g vary from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coeff.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks in the cluster, the portable size
constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;
static_assert(kWarps == kWarp, "block_sum reduces one value per warp in one warp");
constexpr int kLanes = 16;                 // lanes that share one sample
constexpr int kSlots = kThreads / kLanes;  // samples a block holds at once
constexpr int kHeld = 8;                   // row entries a lane holds: P <= 128 all in registers

// reg_kind, as ops/sync_epoch.py::REG_KINDS orders them
constexpr int kRegDimSparsity = 0;
constexpr int kRegL2 = 1;

// returned when the cluster cannot be scheduled on this card
constexpr int kErrClusterUnschedulable = 100000;

struct Params {
  const float* w_in;          // [D]
  const float* ds;            // [D], read only for dim_sparsity
  const int64_t* ids;         // [S, K, B] rows of the data
  const int32_t* idx;         // [N, P]
  const float* val;           // [N, P]
  const float* y;             // [N]
  float* w_out;               // [D]
  int64_t n_rows;             // N
  int steps, K, B, P, D;
  int slice;                  // entries of w each block holds: ceil(D / kCluster)
  int coeff_kind, reg_kind;
  float lam2;                 // 2 * lam
  float lr;
  float n_total;              // workers over all cards
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One sample's row as one of its kLanes lanes holds it in registers: the
// entries sub, sub + kLanes, ..., kHeld of them.  Entries past
// kHeld * kLanes are read from global memory where they are used.
struct Sample {
  int64_t row;  // < 0: no sample in this slot
  int k;        // its worker
  float y;
  int32_t i[kHeld];
  float v[kHeld];
};

// Row id of sample j of step s, or -1 past the end.
__device__ __forceinline__ int64_t load_id(const Params& p, int s, int j) {
  const int n = p.K * p.B;
  if (s >= p.steps || j >= n) return -1;
  return __ldg(reinterpret_cast<const long long*>(p.ids) + (int64_t)s * n + j);
}

// Issue the loads of sample j's row; they are independent, so they are in
// flight together, and nothing waits for them until the row is used.
__device__ __forceinline__ Sample load_row(const Params& p, int64_t row, int j, int sub) {
  Sample r;
  r.row = (uint64_t)row < (uint64_t)p.n_rows ? row : -1;  // out-of-range ids add nothing
  r.k = j / p.B;
  r.y = 0.f;
#pragma unroll
  for (int t = 0; t < kHeld; ++t) {
    r.i[t] = 0;
    r.v[t] = 0.f;
  }
  if (r.row >= 0) {
    r.y = __ldg(p.y + r.row);
    const int32_t* ri = p.idx + r.row * p.P;
    const float* rv = p.val + r.row * p.P;
#pragma unroll
    for (int t = 0; t < kHeld; ++t) {
      const int q = sub + t * kLanes;
      if (q < p.P) {
        r.i[t] = __ldg(ri + q);
        r.v[t] = __ldg(rv + q);
      }
    }
  }
  return r;
}

// Feature i's entry of `base` in the block that owns it: block i % kCluster,
// at i / kCluster.
__device__ __forceinline__ float* owned(const cg::cluster_group& cluster, float* base, int i) {
  return cluster.map_shared_rank(base + i / kCluster, i % kCluster);
}

// Phase A for one sample: its margin gathered from the owners' w, the
// coefficient, and c * v added into the owners' g[k].  Every lane of the
// warp calls this, with a live sample or not, so the shuffles converge.
__device__ __forceinline__ void run_sample(const cg::cluster_group& cluster, const Params& p,
                                           const Sample& r, int sub, float* w_s, float* g_s) {
  const bool live = r.row >= 0;
  const int32_t* ri = p.idx + (live ? r.row : 0) * p.P;
  const float* rv = p.val + (live ? r.row : 0) * p.P;
  float m = 0.f;
  if (live) {
#pragma unroll
    for (int t = 0; t < kHeld; ++t)  // pad entries (val 0) and out-of-range ids add nothing
      if (r.v[t] != 0.f && (uint32_t)r.i[t] < (uint32_t)p.D)
        m += *owned(cluster, w_s, r.i[t]) * r.v[t];
    for (int q = sub + kHeld * kLanes; q < p.P; q += kLanes) {
      const int32_t i = __ldg(ri + q);
      const float v = __ldg(rv + q);
      if (v != 0.f && (uint32_t)i < (uint32_t)p.D) m += *owned(cluster, w_s, i) * v;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    m += __shfl_xor_sync(0xffffffffu, m, off, kLanes);
  // lane 0 of the sample decides, so every lane scatters with the same c
  float c = (live && sub == 0) ? grad_coeff(p.coeff_kind, m, r.y) : 0.f;
  c = __shfl_sync(0xffffffffu, c, 0, kLanes);
  if (c == 0.f) return;  // no sample, or an inactive one: every c * v is zero
  float* g_k = g_s + (size_t)r.k * p.slice;
#pragma unroll
  for (int t = 0; t < kHeld; ++t)
    if (r.v[t] != 0.f && (uint32_t)r.i[t] < (uint32_t)p.D)
      atomicAdd(owned(cluster, g_k, r.i[t]), c * r.v[t]);
  for (int q = sub + kHeld * kLanes; q < p.P; q += kLanes) {
    const int32_t i = __ldg(ri + q);
    const float v = __ldg(rv + q);
    if (v != 0.f && (uint32_t)i < (uint32_t)p.D) atomicAdd(owned(cluster, g_k, i), c * v);
  }
}

// Sum of every thread's `v`, in a fixed order, written to *out by thread 0.
__device__ __forceinline__ void block_sum(float v, float* red_s, float* out) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  v = warp_sum(v);
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(red_s[lane]);
    if (lane == 0) *out = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1) sync_epoch_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % kWarp;
  const int slice = p.slice;
  const int n_own = max(0, (p.D - rank + kCluster - 1) / kCluster);  // features rank + kCluster * j
  const bool dim_sp = p.reg_kind == kRegDimSparsity;

  // shared layout: w | dim_sparsity | g[K] | partial[2] | red[kWarps]
  extern __shared__ float smem[];
  float* w_s = smem;
  float* ds_s = w_s + slice;
  float* g_s = ds_s + slice;
  float* part_s = g_s + (size_t)p.K * slice;  // w . ds partial, by step parity
  float* red_s = part_s + 2;

  float part = 0.f;
  for (int j = threadIdx.x; j < slice; j += kThreads) {
    float wv = 0.f, dv = 0.f;
    if (j < n_own) {
      wv = p.w_in[j * kCluster + rank];
      if (dim_sp) dv = p.ds[j * kCluster + rank];
    }
    w_s[j] = wv;
    ds_s[j] = dv;
    part += wv * dv;
  }
  for (int j = threadIdx.x; j < p.K * slice; j += kThreads) g_s[j] = 0.f;
  if (dim_sp) block_sum(part, red_s, &part_s[0]);
  cluster.sync();  // every block's state is in place before any remote access

  const int n_samples = p.K * p.B;
  const int sub = threadIdx.x % kLanes;
  const int slot = (threadIdx.x / kLanes) * kCluster + rank;  // samples spread over the blocks
  const int n_slots = kCluster * kSlots;
  Sample first = load_row(p, load_id(p, 0, slot), slot, sub);
  for (int s = 0; s < p.steps; ++s) {
    // -- phase A: per-sample margins and the scatter into the owners' g ---
    const int64_t next_id = load_id(p, s + 1, slot);  // needed at phase B
    run_sample(cluster, p, first, sub, w_s, g_s);  // loaded during the last phase B
    for (int base = n_slots; base < n_samples; base += n_slots)
      run_sample(cluster, p, load_row(p, load_id(p, s, base + slot), base + slot, sub), sub,
                 w_s, g_s);
    cluster.sync();
    // the next step's first samples: their loads are in flight during the sweep
    first = load_row(p, next_id, slot, sub);

    // -- phase B: regularizer, sum over workers, mean, update -------------
    float scalar = 0.f;
    if (dim_sp) {
      // partial of this step's w from every block, added in rank order
      const float mine = lane < kCluster ? *cluster.map_shared_rank(&part_s[s & 1], lane) : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) dot += __shfl_sync(0xffffffffu, mine, r);
      scalar = __fmul_rn(p.lam2, dot);
    }
    // four entries at a time over the whole slice: the entries past the
    // block's last feature are zero in w, dim_sparsity and g, and stay so
    float next = 0.f;
    for (int j = 4 * threadIdx.x; j < slice; j += 4 * kThreads) {
      float4 w4 = *reinterpret_cast<float4*>(w_s + j);
      float* wv = reinterpret_cast<float*>(&w4);
      float upd[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < p.K; ++k) {
        float4* gp = reinterpret_cast<float4*>(g_s + (size_t)k * slice + j);
        float4 g4 = *gp;
        float* g = reinterpret_cast<float*>(&g4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (dim_sp) {
            g[e] = __fadd_rn(g[e], g[e] != 0.f ? scalar : 0.f);
          } else if (p.reg_kind == kRegL2) {
            g[e] = __fadd_rn(g[e], __fmul_rn(p.lam2, wv[e]));
          }
          upd[e] = __fadd_rn(upd[e], g[e]);
        }
        *gp = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 d4 = *reinterpret_cast<const float4*>(ds_s + j);
      const float* dv = reinterpret_cast<const float*>(&d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the _rn intrinsics keep the plain version's rounding (no fused FMA)
        wv[e] = __fsub_rn(wv[e], __fmul_rn(p.lr, __fdiv_rn(upd[e], p.n_total)));
        next += wv[e] * dv[e];
      }
      *reinterpret_cast<float4*>(w_s + j) = w4;
    }
    if (dim_sp) block_sum(next, red_s, &part_s[(s + 1) & 1]);
    cluster.sync();
  }

  for (int j = threadIdx.x; j < n_own; j += kThreads) p.w_out[j * kCluster + rank] = w_s[j];
}

}  // namespace

// Launch one cluster of `cluster` blocks on `stream` (PyTorch's current
// stream), each with `smem_bytes` of dynamic shared memory holding a slice
// of `slice` entries.  Returns 0 on success, a cudaError_t, or
// kErrClusterUnschedulable when the card cannot run such a cluster; the
// caller raises on anything but 0.
extern "C" int dsgd_sync_epoch(const float* w, const float* ds, const int64_t* ids,
                               const int32_t* idx, const float* val, const float* y,
                               float* w_out, int64_t n_rows, int steps, int K, int B,
                               int P, int D, int cluster, int slice, int smem_bytes,
                               int coeff_kind, int reg_kind, float lam2, float lr,
                               float n_total, void* stream) {
  // the sweep reads the slices as float4s
  if (cluster != kCluster || slice % 4 != 0 || (int64_t)slice * kCluster < D)
    return (int)cudaErrorInvalidValue;
  const Params p{w, ds, ids, idx, val, y, w_out, n_rows, steps, K, B, P, D,
                 slice, coeff_kind, reg_kind, lam2, lr, n_total};
  cudaError_t err = cudaFuncSetAttribute(
      sync_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, sync_epoch_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n_clusters < 1) return kErrClusterUnschedulable;

  err = cudaLaunchKernelEx(&cfg, sync_epoch_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
