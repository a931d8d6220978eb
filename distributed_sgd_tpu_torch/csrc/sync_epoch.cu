// S whole synchronous SGD steps in one launch, CUDA C++ for Hopper (sm_90a).
//
// Replaces, on the sync engine's main path, the Pallas TPU kernel
// distributed_sgd_tpu/ops/pallas_sparse.py:154 (worker_grads) together with
// the XLA ops around it in the JAX engine's step (parallel/sync.py
// _one_step): for each step s with sample ids ids[s] of shape [K, B],
//
//     g_k  = sum_b coeff(x_b . w, y_b) * x_b          per worker k
//     g_k  = g_k / grad_divisor
//     g_k += reg(g_k, w)                              dim_sparsity | l2 | none
//     g    = (sum_k g_k) / n_total_workers
//     w    = update(w, g)                             sgd | momentum | adam
//
// where reg is 1[g_k != 0] * 2*lam*(w . dim_sparsity) for dim_sparsity and
// 2*lam*w for l2.  grad_divisor is 1 on the sync path.  The async engines
// (Hogwild, local SGD) run it in a mean mode, K = 1 and grad_divisor = B:
// each step is then the JAX async step, grad_mean (models/linear.py) then
// regularize then the update (parallel/sync.py local_update).
//
// The update is the JAX engines' optimizer (optax 0.2.6), on every entry
// every step, the entries whose g is 0 included:
//     sgd       w = w - lr*g
//     momentum  t = g + m*t;  w = w + (-lr)*t          optax.sgd(lr, momentum=m)
//     adam      mu = (1-b1)*g + b1*mu;  nu = (1-b2)*g*g + b2*nu;
//               w = w + (-lr) * (mu/bc1) / (sqrt(nu/bc2) + eps)    optax.adam(lr)
// The optimizer state (momentum: t; adam: mu, nu) lives in shared memory
// beside w for the whole launch.  Adam's bias corrections bc1 = 1 - b1^c,
// bc2 = 1 - b2^c at step count c come from a per-step table the caller
// makes, so the kernel and the plain version divide by the same floats.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32).  At the main path's
// shape (K=3, B=100, P=76, D=47,236, 2,146 steps an epoch) the state a step
// reads and writes is small: w 188,944 B, dim_sparsity 188,944 B and the
// per-worker integer sums g[3, D] 1,133,664 B.  Only the sampled rows must come from
// HBM: 300 rows x 76 x 8 B plus ids and labels, about 186 KB a step and
// 400 MB an epoch, or about 0.12 ms; the operations (about 1.4 GFLOP, most
// of it the dense update sweep) take about 21 us.  So the bound is bytes.
// The optimizer state adds a read and a write of one (momentum) or two
// (adam) [D] vectors a launch, and a few operations per entry and step.
// One step of the per-step path is about 12 small launches, each costing
// host time, and round trips the dense [K, D] sums through HBM.
//
// Design.  One thread-block cluster of 8 blocks runs the whole epoch.
// Block r owns the features i with i % 8 == r: its entries of w, the
// optimizer state and each g[k, .].  It loads them into shared memory
// once, keeps them there for every step, and writes w_out and the state
// once at the end.  dim_sparsity, read only by the sweep, is copied once
// into a slice of shared memory where the plan leaves room (sgd and
// momentum at K <= 3, the mean mode), else into a contiguous slice of a
// global scratch buffer (resident in L2); the sweep reads it as float4s.
// Other blocks reach the shared entries through distributed shared memory
// (DSMEM).  Ownership is cyclic, not by contiguous slices: where feature
// popularity follows the index (term ids ranked by frequency, as in the
// synthetic RCV1 rows), the first slice would take most of every step's
// remote loads and adds.  Each step:
//   phase A  16 lanes take one sample (k, b); the cluster holds 512
//            samples at once, so at K*B <= 512 every sample is in flight
//            together.  The lanes hold the row's entries in registers,
//            loaded during the last step's closing barrier; they gather
//            w[i] * v from the owners' shared memory, reduce with
//            shuffles, apply the coefficient (coeff.cuh) and add c * v into
//            the owners' g[k, i];
//   cluster.sync()  (arrive.release / wait.acquire: the remote adds are
//            visible to their owners);
//   phase B  each block sweeps its own entries, four at a time: the
//            conversion of g to f32, the regularizer, the sum over workers,
//            the mean and the optimizer's update; it zeroes g and sums its
//            partial of w . dim_sparsity (and least squares' largest |w|),
//            which it pushes into its slot in every block.  With sgd, no
//            l2 term, lr finite with its sign bit clear and no non-finite
//            term that step, an entry whose sums are all 0 keeps its
//            weight bit for bit, so the sweep updates only the entries
//            with a sum (each warp gathers those of its 128 entries, one
//            a lane) and then reads w densely for the partial;
//   barrier.cluster.arrive.release; the next step's rows are loaded into
//            registers, which depends on no other block, while the others
//            arrive; barrier.cluster.wait.acquire.
// Each step adds the pushed partials in rank order from its own shared
// memory: the same floats in the same order in every block, with no
// remote load on the step's path.  A block reads them before the barrier
// after which the next ones may be pushed, so one slot a block does.  w is
// read only from shared memory, never through the non-coherent (__ldg)
// path: the kernel writes it between steps.  The input w and state are
// never written; the caller allocates w_out and the state's outputs.  The
// time goes to latency and to the owners' 64-bit shared-memory atomics,
// not to the bound: the two cluster barriers a step, which the step's
// dependence forces, the remote adds and the sweep (PERF.md).
//
// Fixed order.  g[k, .] is a 64-bit integer sum, so one input gives one
// output bit for bit, whatever order the lanes run in (f32 atomics would
// sum in another order on every launch).  Each finite term c * v is
// rounded to f32, as the plain version rounds it, scaled exactly by a
// power of two 2^e, rounded to the nearest integer and added with a
// remote 64-bit reduction (red.shared::cluster.add.u64), which commutes.
// The sweep converts each sum once: the integer rounded to f32, times
// 2^-e (exact).  The scale is the largest at which B*P terms of at most
// the bound cannot leave 2^62 (ops/sync_epoch.py scale_exponent; the same
// rule as csrc/worker_grads.cu, there per worker from the terms' own
// maximum):
//   hinge, logistic  |c| <= |y| (coeff.cuh), so |c v| <= max|y| max|v|
//            over the data: the caller computes e once for the launch and
//            the step pays nothing for it;
//   least squares  c = 2 (m - y) has no bound before the step.  Each step
//            bounds it from the cluster's largest |w| (pushed beside the
//            w . dim_sparsity partial, one more shared word a block):
//            |c v| <= 4 (max|w| L1 + max|y|) max|v|, where L1 is the data's
//            largest row sum of |v| (a factor 2 over the exact bound covers
//            the f32 rounding of the margin).  No extra barrier, and no
//            coefficient is held between passes.
// The integer sum is exact; the only roundings are each term's at 2^-e
// (2^-49 of the bound at B*P = 7,600) and the final one to f32.  A feature
// whose terms cancel comes out exactly 0.0, where the plain version's f32
// sum can leave a residue, so dim_sparsity's g != 0 mask can differ there
// by one 2 lam (w . dim_sparsity).  A coefficient of exactly 0 adds
// nothing.  A non-finite term (an overflowed or diverged step) goes to an
// f32 buffer in global memory with a global atomic, and a flag tells its
// owner to take that entry from there: a sum of infinities and NaNs does
// not depend on order either.
//
// A model's own rule (the Pallas kernel's coeff_fn; ops/coeff.py) is
// compiled into a variant of this file with DSGD_USER_COEFF (coeff.cuh,
// ops/_build.py), with the same pushed values, barriers and sweep.  Such
// a rule has no bound before the step, so the variant splits phase A in
// two passes around one more cluster barrier a step:
//   pass 1  every sample's margin and coefficient, and the cluster's
//           largest finite term |c v| (over the block, then pushed
//           into every block's slots);
//   cluster.sync()
//   pass 2  the step's scale from that maximum, the rule of
//           csrc/worker_grads.cu, then the adds.
// The coefficients of the first 512 samples stay in the registers of
// their lanes; past K*B = 512, a round's coefficients are kept in a global
// scratch slice (L2) that the lane writing one reads back, and the rows
// are loaded again.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coeff.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks in the cluster, the portable size
constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;
static_assert(kWarps == kWarp, "block_push reduces one value per warp in one warp");
constexpr int kLanes = 16;                 // lanes that share one sample
constexpr int kSlots = kThreads / kLanes;  // samples a block holds at once
constexpr int kHeld = 8;                   // row entries a lane holds: P <= 128 all in registers
constexpr int kSumBits = 62;               // |sum| <= 2^62 < 2^63
constexpr int kScaleLimit = 1000;          // |e|: 2^e stays a normal double

// coeff_kind, as ops/worker_grads.py::COEFF_KINDS orders them
constexpr int kLeastSquares = 2;
// reg_kind, as ops/sync_epoch.py::REG_KINDS orders them
constexpr int kRegDimSparsity = 0;
constexpr int kRegL2 = 1;
// opt_kind, as ops/sync_epoch.py::OPT_KINDS orders them
constexpr int kOptMomentum = 1;
constexpr int kOptAdam = 2;
constexpr int kMaxState = 2;  // state vectors: momentum 1, adam 2

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
  const float* st_in[kMaxState];  // [D] each: momentum's trace; adam's mu, nu
  float* st_out[kMaxState];
  const float* bias;          // [steps, 2]: adam's 1 - b1^c, 1 - b2^c at each step
  float* scratch;             // dim_sparsity by owner [8, slice], then non-finite terms [8, K, slice]
  int64_t n_rows;             // N
  int steps, K, B, P, D;
  int slice;                  // entries of w each block holds: ceil(D / kCluster)
  int ds_local;               // dim_sparsity's slice in shared memory, not the scratch
  int coeff_kind, reg_kind, opt_kind, n_state;
  int scale_e;                // hinge, logistic: the launch's scale exponent
  int count_bits;             // ceil(log2(B * P)): terms a step adds into one g[k, i], at most
  double l1_max, y_max, v_max;  // least squares: the data's bounds
  float lam2;                 // 2 * lam
  float lr;
  float n_total;              // workers over all cards
  float grad_div;             // each worker's sum is divided by it: 1 (sync) or B (mean mode)
  float decay1, decay2;       // momentum: m, unused; adam: b1, b2
  float keep1, keep2;         // adam: 1 - b1, 1 - b2, rounded from double as JAX does
  float eps;                  // adam
};

// Byte offsets of a block's dynamic shared memory, the same arithmetic as
// ops/sync_epoch.py cluster_plan: g[K, slice] (u64) | w | state[n_state] |
// dim_sparsity (where ds_local) | pushed values [2][kCluster] |
// red[kWarps] | flag[2].
struct Layout {
  size_t g, w, st, ds, pushed, red, flag, end;
};

__host__ __device__ inline Layout layout(int K, int slice, int n_state, int ds_local) {
  Layout l;
  size_t o = 0;
  l.g = o;      o += (size_t)8 * K * slice;
  l.w = o;      o += (size_t)4 * slice;
  l.st = o;     o += (size_t)4 * n_state * slice;
  l.ds = o;     o += ds_local ? (size_t)4 * slice : 0;
  l.pushed = o; o += 4 * 2 * kCluster;
  l.red = o;    o += 4 * kWarps;
  l.flag = o;   o += 4 * 2;
  l.end = o;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The two halves of a cluster barrier: what a block does between them
// must depend on no other block.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The exponent e of the scale 2^e at which 2^count_bits terms of magnitude
// at most `bound`, rounded to integers, sum within 2^kSumBits: with
// bound < 2^E (frexp), each scaled term is at most 2^(E + e).  A bound
// that is not finite takes 2^128, above every finite f32.  The same rule
// as ops/sync_epoch.py scale_exponent.
__device__ __forceinline__ int scale_exponent(double bound, int count_bits) {
  if (!(bound > 0.0)) return 0;
  if (!isfinite(bound)) bound = 0x1p128;
  int big;
  frexp(bound, &big);
  return max(-kScaleLimit, min(kScaleLimit, kSumBits - big - count_bits));
}

// red.add of `v` into `local`'s counterpart in block `rank` of the cluster:
// a 64-bit integer reduction in distributed shared memory.
__device__ __forceinline__ void cluster_add(unsigned long long* local, int rank,
                                            unsigned long long v) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.u64 [%0], %1;"
               :: "r"(remote), "l"(v) : "memory");
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

// Where phase A adds a step's terms: the integer sums g[K, slice] of this
// block (the owners' counterparts are reached through cluster_add), the
// step's scale 2^e, and for non-finite terms the f32 buffer and the owners'
// flags for this step's parity.
struct Sink {
  unsigned long long* g;
  double scale;
  float* nf;  // [kCluster, K, slice] in global memory
  int* flag;  // this block's flag of the step's parity
};

// Add the term t of worker k into feature i's g[k, i] at its owner.
__device__ __forceinline__ void add_term(const cg::cluster_group& cluster, const Params& p,
                                         const Sink& sink, int k, int32_t i, float t) {
  const int owner = i % kCluster, j = i / kCluster;
  if (!isfinite(t)) {
    atomicAdd(sink.nf + ((size_t)owner * p.K + k) * p.slice + j, t);
    atomicOr(cluster.map_shared_rank(sink.flag, owner), 1);
    return;
  }
  const long long q = __double2ll_rn(__dmul_rn((double)t, sink.scale));
  if (q != 0) cluster_add(sink.g + (size_t)k * p.slice + j, owner, (unsigned long long)q);
}

#ifdef DSGD_USER_COEFF
// The user variant's phase A, in two passes (see the header).  One
// sample's margin, as run_sample gathers and reduces it (every lane gets
// it); every lane of the warp calls this, with a live sample or not.
__device__ __forceinline__ float sample_margin(const cg::cluster_group& cluster, const Params& p,
                                               const Sample& r, int sub, float* w_s) {
  const bool live = r.row >= 0;
  const int32_t* ri = p.idx + (live ? r.row : 0) * p.P;
  const float* rv = p.val + (live ? r.row : 0) * p.P;
  float m = 0.f;
  if (live) {
#pragma unroll
    for (int t = 0; t < kHeld; ++t)
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
  return m;
}

// Pass 1 for one sample: its coefficient, decided by lane 0 of the sample
// (every lane gets it), and the largest finite |c * v| of the lane's
// entries into *top: the terms scatter_row adds, rounded the same way.
__device__ __forceinline__ float measure_sample(const cg::cluster_group& cluster,
                                               const Params& p, const Sample& r, int sub,
                                               float* w_s, float* top) {
  const float m = sample_margin(cluster, p, r, sub, w_s);
  float c = (r.row >= 0 && sub == 0) ? grad_coeff(p.coeff_kind, m, r.y) : 0.f;
  c = __shfl_sync(0xffffffffu, c, 0, kLanes);
  if (c == 0.f) return c;  // no sample, or an inactive one: every c * v is zero
  float big = *top;
#pragma unroll
  for (int t = 0; t < kHeld; ++t)
    if (r.v[t] != 0.f && (uint32_t)r.i[t] < (uint32_t)p.D) {
      const float x = fabsf(c * r.v[t]);
      if (isfinite(x)) big = fmaxf(big, x);
    }
  for (int q = sub + kHeld * kLanes; q < p.P; q += kLanes) {
    const int32_t i = __ldg(p.idx + r.row * p.P + q);
    const float v = __ldg(p.val + r.row * p.P + q);
    const float x = fabsf(c * v);
    if (v != 0.f && (uint32_t)i < (uint32_t)p.D && isfinite(x)) big = fmaxf(big, x);
  }
  *top = big;
  return c;
}

// Pass 2 for one live sample: c * v of each of the lane's entries added
// into the owners' g[k], as run_sample adds them.
__device__ __forceinline__ void scatter_row(const cg::cluster_group& cluster, const Params& p,
                                            const Sample& r, int sub, float c,
                                            const Sink& sink) {
  const int32_t* ri = p.idx + r.row * p.P;
  const float* rv = p.val + r.row * p.P;
#pragma unroll
  for (int t = 0; t < kHeld; ++t)
    if (r.v[t] != 0.f && (uint32_t)r.i[t] < (uint32_t)p.D)
      add_term(cluster, p, sink, r.k, r.i[t], c * r.v[t]);
  for (int q = sub + kHeld * kLanes; q < p.P; q += kLanes) {
    const int32_t i = __ldg(ri + q);
    const float v = __ldg(rv + q);
    if (v != 0.f && (uint32_t)i < (uint32_t)p.D) add_term(cluster, p, sink, r.k, i, c * v);
  }
}
#else
// Phase A for one sample: its margin gathered from the owners' w, the
// coefficient, and c * v added into the owners' g[k].  Every lane of the
// warp calls this, with a live sample or not, so the shuffles converge.
__device__ __forceinline__ void run_sample(const cg::cluster_group& cluster, const Params& p,
                                           const Sample& r, int sub, float* w_s,
                                           const Sink& sink) {
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
#pragma unroll
  for (int t = 0; t < kHeld; ++t)
    if (r.v[t] != 0.f && (uint32_t)r.i[t] < (uint32_t)p.D)
      add_term(cluster, p, sink, r.k, r.i[t], c * r.v[t]);
  for (int q = sub + kHeld * kLanes; q < p.P; q += kLanes) {
    const int32_t i = __ldg(ri + q);
    const float v = __ldg(rv + q);
    if (v != 0.f && (uint32_t)i < (uint32_t)p.D) add_term(cluster, p, sink, r.k, i, c * v);
  }
}
#endif

// Every thread's `v` over the block, a sum in a fixed order (or the
// largest), pushed by warp 0 into slot `rank` of `slots` in every block
// of the cluster.
__device__ __forceinline__ void block_push(const cg::cluster_group& cluster, float v,
                                           float* red_s, float* slots, int rank, bool largest) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (largest) __syncthreads();  // red_s may still be read by a sum just before
  v = largest ? warp_max(v) : warp_sum(v);
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = largest ? warp_max(red_s[lane]) : warp_sum(red_s[lane]);
    if (lane < kCluster) *cluster.map_shared_rank(slots + rank, lane) = v;
  }
}

// The cluster's pushed values combined in rank order from this block's
// own slots (a sum, or the largest): every block gets the same float.
__device__ __forceinline__ float rank_order(const float* slots, bool largest) {
  float out = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) out = largest ? fmaxf(out, slots[r]) : out + slots[r];
  return out;
}

#ifndef DSGD_USER_COEFF
// The step's scale exponent: the launch's, or for least squares the bound
// from the cluster's largest |w| this step (see the header).
__device__ __forceinline__ int step_exponent(const Params& p, const float* wmax) {
  if (p.coeff_kind != kLeastSquares) return p.scale_e;
  const double w_max = (double)rank_order(wmax, true);
  return scale_exponent(4.0 * (w_max * p.l1_max + p.y_max) * p.v_max, p.count_bits);
}
#endif

// An integer sum at 2^-e as f32: the integer rounded to f32, times 2^-e.
__device__ __forceinline__ float to_f32(long long acc, int e) {
  return acc != 0 ? ldexpf(__ll2float_rn(acc), -e) : 0.f;
}

// Feature sums g[k, j..j+3] of this block as f32: the integer sums at
// 2^-e, or the non-finite sum where one was added.  Zeroes both for the
// next step.
__device__ __forceinline__ void take_sums(unsigned long long* g, float* nf, bool any_nf, int e,
                                          float out[4]) {
  ulonglong2* gp = reinterpret_cast<ulonglong2*>(g);
  const ulonglong2 a = gp[0], b = gp[1];
  const long long acc[4] = {(long long)a.x, (long long)a.y, (long long)b.x, (long long)b.y};
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = to_f32(acc[q], e);
  if ((a.x | a.y | b.x | b.y) != 0ull) {
    gp[0] = make_ulonglong2(0ull, 0ull);
    gp[1] = make_ulonglong2(0ull, 0ull);
  }
  if (any_nf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // through L2: other blocks added these with global atomics
      const float x = __ldcg(nf + q);
      if (x != 0.f) {
        out[q] = x;
        __stcg(nf + q, 0.f);
      }
    }
  }
}

// The position of the n-th set bit of m (n counts from 0; n < popc(m)).
__device__ __forceinline__ int nth_set(uint32_t m, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half /= 2) {
    const uint32_t low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= half;
      pos += half;
    } else {
      m = low;
    }
  }
  return pos;
}

// The sparse sweep's update of entry j: sgd, with dim_sparsity or no
// regularizer, and no non-finite term this step.  The arithmetic of the
// dense sweep for one entry; zeroes its sums.
__device__ __forceinline__ void sgd_entry(const Params& p, unsigned long long* g_s, float* w_s,
                                           int j, int e, float scalar, bool mean, bool dim_sp) {
  float upd = 0.f;
  for (int k = 0; k < p.K; ++k) {
    unsigned long long* gk = g_s + (size_t)k * p.slice + j;
    const long long acc = (long long)*gk;
    if (acc != 0) *gk = 0ull;
    float g = to_f32(acc, e);
    if (mean) g = __fdiv_rn(g, p.grad_div);
    if (dim_sp) g = __fadd_rn(g, g != 0.f ? scalar : 0.f);
    upd = __fadd_rn(upd, g);
  }
  w_s[j] = __fsub_rn(w_s[j], __fmul_rn(p.lr, __fdiv_rn(upd, p.n_total)));
}

__global__ void __launch_bounds__(kThreads, 1) sync_epoch_kernel(const Params p) {
  // every block of the cluster has started before any remote access
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slice = p.slice;
  const int n_own = max(0, (p.D - rank + kCluster - 1) / kCluster);  // features rank + kCluster * j
  const bool dim_sp = p.reg_kind == kRegDimSparsity;
  const bool lsq = p.coeff_kind == kLeastSquares;
  const bool mean = p.grad_div != 1.f;  // the sync path skips a division by 1
  const bool ds_local = p.ds_local != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(p.K, slice, p.n_state, p.ds_local);
  unsigned long long* g_s = reinterpret_cast<unsigned long long*>(smem + l.g);
  float* w_s = reinterpret_cast<float*>(smem + l.w);
  float* st_s = reinterpret_cast<float*>(smem + l.st);  // state vector v at st_s + v * slice
  float* part_s = reinterpret_cast<float*>(smem + l.pushed);  // w . ds partials, by rank
  float* wmax_s = part_s + kCluster;  // largest |w| (user variant: |c v|), by rank
  float* red_s = reinterpret_cast<float*>(smem + l.red);
  int* flag_s = reinterpret_cast<int*>(smem + l.flag);  // non-finite terms, by step parity
  // this block's slices of the global scratch; dim_sparsity's where the
  // sweep reads it
  float* ds_own = p.scratch + (size_t)rank * slice;
  float* nf_own = p.scratch + (size_t)kCluster * slice + (size_t)rank * p.K * slice;
  const float* ds_sweep = ds_local ? reinterpret_cast<const float*>(smem + l.ds) : ds_own;

  float part = 0.f, big = 0.f;
  for (int j = threadIdx.x; j < slice; j += kThreads) {
    float wv = 0.f, dv = 0.f;
    if (j < n_own) {
      wv = p.w_in[j * kCluster + rank];
      if (dim_sp) dv = p.ds[j * kCluster + rank];
    }
    w_s[j] = wv;
    if (ds_local) {
      reinterpret_cast<float*>(smem + l.ds)[j] = dv;
    } else {
      ds_own[j] = dv;
    }
    part += wv * dv;
    big = fmaxf(big, fabsf(wv));
#pragma unroll
    for (int v = 0; v < kMaxState; ++v)  // pad entries stay 0 under every update
      if (v < p.n_state)
        st_s[(size_t)v * slice + j] = j < n_own ? p.st_in[v][j * kCluster + rank] : 0.f;
  }
  for (int j = threadIdx.x; j < p.K * slice; j += kThreads) {
    g_s[j] = 0ull;
    nf_own[j] = 0.f;
  }
  if (threadIdx.x < 2) flag_s[threadIdx.x] = 0;
  asm volatile("barrier.cluster.wait;" ::: "memory");
  if (dim_sp) block_push(cluster, part, red_s, part_s, rank, false);
  if (lsq) block_push(cluster, big, red_s, wmax_s, rank, true);
  cluster.sync();  // every block's state and pushed values are in place

  const int n_samples = p.K * p.B;
  const int sub = threadIdx.x % kLanes;
  const int slot = (threadIdx.x / kLanes) * kCluster + rank;  // samples spread over the blocks
  const int n_slots = kCluster * kSlots;
  float* nf_all = p.scratch + (size_t)kCluster * slice;
  Sample first = load_row(p, load_id(p, 0, slot), slot, sub);
#ifdef DSGD_USER_COEFF
  // the coefficients of the samples past the first n_slots, by round
  float* c_keep = nf_all + (size_t)kCluster * p.K * slice;
#endif
  for (int s = 0; s < p.steps; ++s) {
    // -- phase A: per-sample margins and the scatter into the owners' g ---
#ifdef DSGD_USER_COEFF
    const int64_t next_id = load_id(p, s + 1, slot);  // needed at phase B
    // pass 1: every coefficient, and the cluster's largest finite term
    float top = 0.f;
    const float c_first = measure_sample(cluster, p, first, sub, w_s, &top);
    for (int base = n_slots; base < n_samples; base += n_slots) {
      const float c = measure_sample(
          cluster, p, load_row(p, load_id(p, s, base + slot), base + slot, sub), sub, w_s, &top);
      if (sub == 0) c_keep[base - n_slots + slot] = c;
    }
    block_push(cluster, top, red_s, wmax_s, rank, true);
    cluster.sync();
    // pass 2: the step's scale, then the adds with the kept coefficients
    const int e = scale_exponent((double)rank_order(wmax_s, true), p.count_bits);
    const Sink sink{g_s, ldexp(1.0, e), nf_all, &flag_s[s & 1]};
    if (c_first != 0.f) scatter_row(cluster, p, first, sub, c_first, sink);
    for (int base = n_slots; base < n_samples; base += n_slots) {
      // read back by the lane that wrote it
      const float c = __shfl_sync(0xffffffffu, sub == 0 ? c_keep[base - n_slots + slot] : 0.f,
                                  0, kLanes);
      if (c != 0.f)
        scatter_row(cluster, p, load_row(p, load_id(p, s, base + slot), base + slot, sub), sub,
                    c, sink);
    }
#else
    const int e = step_exponent(p, wmax_s);
    const Sink sink{g_s, ldexp(1.0, e), nf_all, &flag_s[s & 1]};
    const int64_t next_id = load_id(p, s + 1, slot);  // needed at phase B
    run_sample(cluster, p, first, sub, w_s, sink);  // loaded during the last step
    for (int base = n_slots; base < n_samples; base += n_slots)
      run_sample(cluster, p, load_row(p, load_id(p, s, base + slot), base + slot, sub), sub,
                 w_s, sink);
#endif
    // read before the barrier after which the next partials are pushed
    const float scalar = dim_sp ? __fmul_rn(p.lam2, rank_order(part_s, false)) : 0.f;
    cluster.sync();  // the remote adds are visible to their owners

    // -- phase B: sums to f32, regularizer, sum over workers, mean, update
    const bool any_nf = flag_s[s & 1] != 0;
    // the next step's flag was last read before the barrier that ended
    // the last step, and is next set after the barrier that ends this one
    if (threadIdx.x == 0) flag_s[(s + 1) & 1] = 0;
    float bc1 = 1.f, bc2 = 1.f;
    if (p.opt_kind == kOptAdam) {
      bc1 = __ldg(p.bias + 2 * s);
      bc2 = __ldg(p.bias + 2 * s + 1);
    }
    // sgd with dim_sparsity or no regularizer leaves an entry whose sums
    // are all 0 as it was (w - lr * 0), bit for bit, where lr is finite
    // with its sign bit clear; such a step updates only the entries with a
    // nonzero sum (or a NaN weight, which the update makes the canonical
    // NaN)
    const bool sparse = p.opt_kind == 0 && p.reg_kind != kRegL2 && !any_nf && !signbit(p.lr) &&
                        isfinite(p.lr);
    // four entries at a time over the whole slice: the entries past the
    // block's last feature are zero in w, dim_sparsity and g, and stay so.
    // A warp takes 128 entries a round; lane l entries j..j+3, j = j0 + 4l
    float next = 0.f;
    big = 0.f;
    const int lane = threadIdx.x % kWarp;
    for (int j0 = 4 * (threadIdx.x - lane); j0 < slice; j0 += 4 * kThreads) {
      const int j = j0 + 4 * lane;
      const bool in = j < slice;
      if (sparse) {
        // the round's entries to update (m_q: the lanes whose entry j + q
        // has a sum or a NaN weight), compacted one a lane
        uint32_t m0, m1, m2, m3;
        {
          const float4 w4 = in ? *reinterpret_cast<const float4*>(w_s + j)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          const float* wv = reinterpret_cast<const float*>(&w4);
          unsigned long long any[4] = {0ull, 0ull, 0ull, 0ull};
          for (int k = 0; in && k < p.K; ++k) {
            const ulonglong2* gp = reinterpret_cast<const ulonglong2*>(g_s + (size_t)k * slice + j);
            const ulonglong2 a = gp[0], b = gp[1];
            any[0] |= a.x;
            any[1] |= a.y;
            any[2] |= b.x;
            any[3] |= b.y;
          }
          m0 = __ballot_sync(0xffffffffu, any[0] != 0ull || isnan(wv[0]));
          m1 = __ballot_sync(0xffffffffu, any[1] != 0ull || isnan(wv[1]));
          m2 = __ballot_sync(0xffffffffu, any[2] != 0ull || isnan(wv[2]));
          m3 = __ballot_sync(0xffffffffu, any[3] != 0ull || isnan(wv[3]));
        }
        const int c0 = __popc(m0), c1 = __popc(m1), c2 = __popc(m2);
        const int n = c0 + c1 + c2 + __popc(m3);
        for (int t = lane; t - lane < n; t += kWarp) {
          if (t >= n) continue;
          // the t-th entry in the order (q, lane)
          int q, nth;
          uint32_t mq;
          if (t < c0) {
            q = 0, nth = t, mq = m0;
          } else if (t < c0 + c1) {
            q = 1, nth = t - c0, mq = m1;
          } else if (t < c0 + c1 + c2) {
            q = 2, nth = t - c0 - c1, mq = m2;
          } else {
            q = 3, nth = t - c0 - c1 - c2, mq = m3;
          }
          const int jj = j0 + 4 * nth_set(mq, nth) + q;
          sgd_entry(p, g_s, w_s, jj, e, scalar, mean, dim_sp);
        }
        __syncwarp();
        if (!in) continue;
        const float4 d4 = dim_sp ? *reinterpret_cast<const float4*>(ds_sweep + j)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 w4 = *reinterpret_cast<const float4*>(w_s + j);
        const float* wv = reinterpret_cast<const float*>(&w4);
        const float* dv = reinterpret_cast<const float*>(&d4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          next += wv[q] * dv[q];
          big = fmaxf(big, fabsf(wv[q]));
        }
        continue;
      }
      if (!in) continue;
      // dim_sparsity's load is issued first; it is used after the update
      const float4 d4 = dim_sp ? *reinterpret_cast<const float4*>(ds_sweep + j)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 w4 = *reinterpret_cast<float4*>(w_s + j);
      float* wv = reinterpret_cast<float*>(&w4);
      float upd[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < p.K; ++k) {
        float g[4];
        take_sums(g_s + (size_t)k * slice + j, nf_own + (size_t)k * slice + j, any_nf, e, g);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // the mean first, as JAX's grad_sum / batch_size: its g != 0 mask
          // is the regularizer's
          if (mean) g[q] = __fdiv_rn(g[q], p.grad_div);
          if (dim_sp) {
            g[q] = __fadd_rn(g[q], g[q] != 0.f ? scalar : 0.f);
          } else if (p.reg_kind == kRegL2) {
            g[q] = __fadd_rn(g[q], __fmul_rn(p.lam2, wv[q]));
          }
          upd[q] = __fadd_rn(upd[q], g[q]);
        }
      }
      // the _rn intrinsics keep the plain version's rounding (no fused FMA)
      if (p.opt_kind == kOptMomentum) {
        float4* tp = reinterpret_cast<float4*>(st_s + j);
        float4 t4 = *tp;
        float* t = reinterpret_cast<float*>(&t4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = __fdiv_rn(upd[q], p.n_total);
          t[q] = __fadd_rn(g, __fmul_rn(p.decay1, t[q]));
          wv[q] = __fadd_rn(wv[q], __fmul_rn(-p.lr, t[q]));
        }
        *tp = t4;
      } else if (p.opt_kind == kOptAdam) {
        float4* mp = reinterpret_cast<float4*>(st_s + j);
        float4* np = reinterpret_cast<float4*>(st_s + slice + j);
        float4 m4 = *mp, n4 = *np;
        float* mu = reinterpret_cast<float*>(&m4);
        float* nu = reinterpret_cast<float*>(&n4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = __fdiv_rn(upd[q], p.n_total);
          mu[q] = __fadd_rn(__fmul_rn(p.keep1, g), __fmul_rn(p.decay1, mu[q]));
          nu[q] = __fadd_rn(__fmul_rn(p.keep2, __fmul_rn(g, g)), __fmul_rn(p.decay2, nu[q]));
          const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu[q], bc2)), p.eps);
          wv[q] = __fadd_rn(wv[q], __fmul_rn(-p.lr, __fdiv_rn(__fdiv_rn(mu[q], bc1), den)));
        }
        *mp = m4;
        *np = n4;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = __fsub_rn(wv[q], __fmul_rn(p.lr, __fdiv_rn(upd[q], p.n_total)));
      }
      const float* dv = reinterpret_cast<const float*>(&d4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        next += wv[q] * dv[q];
        big = fmaxf(big, fabsf(wv[q]));
      }
      *reinterpret_cast<float4*>(w_s + j) = w4;
    }
    if (dim_sp) block_push(cluster, next, red_s, part_s, rank, false);
    if (lsq) block_push(cluster, big, red_s, wmax_s, rank, true);
    // the step's closing barrier, split: the next step's first rows are
    // loaded while the cluster arrives (not before the sweep, where their
    // registers would spill it)
    cluster_arrive();
    first = load_row(p, next_id, slot, sub);
    cluster_wait();
  }

  for (int j = threadIdx.x; j < n_own; j += kThreads) {
    p.w_out[j * kCluster + rank] = w_s[j];
#pragma unroll
    for (int v = 0; v < kMaxState; ++v)
      if (v < p.n_state) p.st_out[v][j * kCluster + rank] = st_s[(size_t)v * slice + j];
  }
}

}  // namespace

// Launch one cluster of `cluster` blocks on `stream` (PyTorch's current
// stream), each with `smem_bytes` of dynamic shared memory holding a slice
// of `slice` entries, laid out as `layout` says, dim_sparsity in shared
// memory where `ds_local`.  opt_kind 0 (sgd)
// reads no state; 1 (momentum) the trace st_in0 -> st_out0 with
// decay1 = m; 2 (adam) mu st_in0 -> st_out0, nu st_in1 -> st_out1 and the
// [steps, 2] table `bias`.  `scratch` holds
// (1 + K) * cluster * slice floats, and in the user variant (coeff_kind 3,
// DSGD_USER_COEFF) (ceil(K * B / 512) - 1) * 512 more; a `scratch_floats`
// under that is refused.  The kernel initialises what it reads.  scale_e
// is the hinge and logistic terms' scale exponent; least squares reads
// l1_max, y_max and v_max instead (ops/sync_epoch.py data_bounds).
// Returns 0 on success, a cudaError_t, or kErrClusterUnschedulable when
// the card cannot run such a cluster; the caller raises on anything but 0.
extern "C" int dsgd_sync_epoch(const float* w, const float* ds, const int64_t* ids,
                               const int32_t* idx, const float* val, const float* y,
                               float* w_out, const float* st_in0, const float* st_in1,
                               float* st_out0, float* st_out1, const float* bias,
                               float* scratch, int64_t scratch_floats,
                               int64_t n_rows, int steps, int K, int B, int P, int D, int cluster,
                               int slice, int smem_bytes, int ds_local,
                               int coeff_kind, int reg_kind, int opt_kind, int scale_e,
                               int count_bits, double l1_max, double y_max, double v_max,
                               float lam2, float lr, float n_total, float grad_div, float decay1,
                               float decay2, float keep1, float keep2, float eps, void* stream) {
  // the sweep reads the slices as float4s and the integer sums as pairs
  if (cluster != kCluster || slice % 4 != 0 || (int64_t)slice * kCluster < D ||
      opt_kind < 0 || opt_kind > kOptAdam)
    return (int)cudaErrorInvalidValue;
  const int n_state = opt_kind;  // sgd 0, momentum 1, adam 2
  if (layout(K, slice, n_state, ds_local).end > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  int64_t need = (int64_t)(1 + K) * kCluster * slice;
#ifdef DSGD_USER_COEFF
  const int64_t n_slots = (int64_t)kCluster * kSlots;
  need += ((int64_t)K * B + n_slots - 1) / n_slots * n_slots - n_slots;
#endif
  if (scratch_floats < need) return (int)cudaErrorInvalidValue;  // a buffer too short
#ifdef DSGD_USER_COEFF
  if (coeff_kind != kUserCoeff) return (int)cudaErrorInvalidValue;  // the variant's one rule
#else
  if (coeff_kind < 0 || coeff_kind >= kUserCoeff) return (int)cudaErrorInvalidValue;
#endif
  const Params p{w, ds, ids, idx, val, y, w_out, {st_in0, st_in1}, {st_out0, st_out1}, bias,
                 scratch, n_rows, steps, K, B, P, D, slice, ds_local,
                 coeff_kind, reg_kind, opt_kind, n_state, scale_e, count_bits, l1_max, y_max,
                 v_max, lam2, lr, n_total, grad_div, decay1, decay2, keep1, keep2, eps};
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
