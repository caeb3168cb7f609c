// The simulator's link demand, summed serially in index order (sm_90a).
//
// Not a port of a TPU kernel: the JAX engine takes this sum with a jnp
// scatter-add (src/repro/netsim/engine.py:805, the link demand of the
// injection step), which XLA on the CPU adds serially in index order.
// It computes the same function as repro_torch.kernels.link_demand.
// link_demand_plain on the CPU: for every (member, link) key g,
//   demand[g] = ((0 + v_0) + v_1) + ...
// over the remaining bytes v_j of the active messages whose route crosses
// the link, in the order of their flat (member, message, route slot)
// index, every add a correctly rounded __fadd_rn. UGAL compares these
// sums, so every bit counts: PyTorch's CUDA index_put_(accumulate=True)
// and index_add_ add the entries of one key in another order.
//
// Design: a bucket sort of the valid route entries by key, then one
// serial fold per bucket. An entry is e = message * K + slot, so flat
// order is the order of e, and putting a bucket in flat order is sorting
// it by e. Five launches on one stream, no library call and no host round
// trip; every buffer is the caller's:
//   1. link_zero_kernel   zeroes the per-key counts;
//   2. link_count_kernel  counts each key's entries with int32 atomics
//                         (exact in any order) and keeps each entry's
//                         rank, the count it saw; a warp stages its 32
//                         route rows with 16-byte loads (sim_rows.cuh) and
//                         skips them when all 32 messages are inactive;
//   3. link_alloc_kernel  gives each bucket its place: a block scans 1,024
//                         counts and takes its range of places with one
//                         atomic (buckets lie in no fixed order, each one
//                         contiguous), and lists the buckets of more than
//                         64 entries;
//   4. link_place_kernel  writes each entry e at its bucket's place + its
//                         rank: the right entries, in no fixed order;
//   5. link_fold_kernel   puts each bucket in flat order and folds it: a
//                         thread sorts a bucket of up to 8 in registers
//                         (a sorting network), a warp one of up to 64
//                         (each entry's rank by comparing it with the
//                         others through shuffles), and 132 blocks share
//                         the listed long ones: a block marks a bucket's
//                         entries in a bitmap of its member's M * K route
//                         entries in shared memory, ranks each entry by
//                         counting the marks below it, and one thread
//                         folds the values in that order; a bucket of more
//                         than 8,192 entries, or a pool whose bitmap does
//                         not fit, is folded while the block walks its
//                         member's messages in order.
// The keys need only 18 bits at the paper's sizes (53,857 on the 1D
// dragonfly, 221,763 for three members on the 2D one), so nothing is
// sorted on 64-bit keys.
//
// Bound on an H100: memory. Routes and the active flags are read once and
// the bytes of the active messages once, the sums written once, one add
// per valid entry. Two things the bound does not see set the time: the
// fold of one bucket is a serial chain of adds (about 4 cycles each, so a
// bucket of 4,000 entries takes some 9 us however the work is spread),
// and the atomics on one hot key's count queue one after another.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_rows.cuh"

namespace {

constexpr int kThreads = 256;       // zero, count, place
constexpr int kBatch = 16;          // route slots a count or place batch
constexpr int kBig = 1024;          // alloc and fold blocks
constexpr int kThreadRun = 8;       // longest bucket a thread folds
constexpr int kWarpRun = 64;        // longest bucket a warp folds
constexpr int kPerThread = 8;       // entries a fold-block thread ranks
constexpr int kBlockRun = kPerThread * kBig;  // longest a block ranks
constexpr int kRunBlocks = 132;     // fold blocks that share the long buckets
// the largest bitmap of a member's route entries a fold block holds (82 KB:
// the paper's pools of 65,573 messages of 10 route slots), two blocks an SM
constexpr int kFoldBitmapBytes = 82 * 1024;
constexpr unsigned kFull = sim_rows::kFullMask;

__global__ void link_zero_kernel(int32_t* __restrict__ p, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    p[i] = 0;
}

// The valid route entries of one warp's 32 messages (blockIdx.y is the
// member), entry e = message * K + slot: counted (kPlace false; rank[e]
// gets the counter's old value, a place in the bucket unique to the
// entry) or placed (kPlace true; slots[starts[key] + rank[e]] = e).
template <bool kPlace>
__device__ __forceinline__ void link_entries(
    const int32_t* __restrict__ routes, const uint8_t* __restrict__ active,
    int M, int K, int Lp, int32_t* __restrict__ count,
    int32_t* __restrict__ rank, const int32_t* __restrict__ starts,
    int32_t* __restrict__ slots) {
  extern __shared__ int32_t rows_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (m0 >= M) return;
  const int n = min(32, M - m0);
  const int64_t msg = (int64_t)b * M + m0 + lane;
  const bool act = lane < n && active[msg] != 0;
  if (!__ballot_sync(kFull, act)) return;
  int32_t* sm = rows_sm + warp * 32 * K;
  sim_rows::warp_stage(routes + ((int64_t)b * M + m0) * K, n * K, sm, lane);
  if (!act) return;
  const int32_t* row = sm + lane * K;
  const int64_t key0 = (int64_t)b * Lp;
  // a batch of slots at a time, so that their atomics (or loads) are in
  // flight together
  for (int k0 = 0; k0 < K; k0 += kBatch) {
    int32_t l[kBatch];
    int32_t r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int32_t x = k0 + j < K ? row[k0 + j] : -1;
      l[j] = (x >= 0 && x < Lp) ? x : -1;
    }
    const int64_t e0 = msg * K + k0;
    if (kPlace) {
      int32_t at[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        at[j] = l[j] >= 0 ? starts[key0 + l[j]] : 0;
        r[j] = l[j] >= 0 ? rank[e0 + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (l[j] >= 0) slots[at[j] + r[j]] = (int32_t)(e0 + j);
    } else {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        r[j] = l[j] >= 0 ? atomicAdd(count + key0 + l[j], 1) : 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (l[j] >= 0) rank[e0 + j] = r[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
link_count_kernel(const int32_t* __restrict__ routes,
                  const uint8_t* __restrict__ active, int M, int K, int Lp,
                  int32_t* __restrict__ count, int32_t* __restrict__ rank) {
  link_entries<false>(routes, active, M, K, Lp, count, rank, nullptr,
                      nullptr);
}

__global__ void __launch_bounds__(kThreads)
link_place_kernel(const int32_t* __restrict__ routes,
                  const uint8_t* __restrict__ active, int M, int K, int Lp,
                  const int32_t* __restrict__ rank,
                  const int32_t* __restrict__ starts,
                  int32_t* __restrict__ slots) {
  link_entries<true>(routes, active, M, K, Lp, nullptr,
                     const_cast<int32_t*>(rank), starts, slots);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive sum of x over the block (blockDim.x a multiple of 32, at most
// 1024); every thread gets the block's sum in *total. Every thread calls
// it.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sum[32];
  __shared__ int sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_sum(x, lane);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
    const int wi = warp_inclusive_sum(w, lane);
    warp_sum[lane] = wi - w;
    if (lane == 31) sum = wi;
  }
  __syncthreads();
  const int out = warp_sum[warp] + incl - x;
  *total = sum;
  __syncthreads();  // warp_sum and sum are free again when this returns
  return out;
}

// starts[g]: where bucket g begins (a block takes its range of places
// with one atomic on counters[0]); the keys of more than kWarpRun entries
// listed in ``big``, their number in counters[1].
__global__ void __launch_bounds__(kBig)
link_alloc_kernel(const int32_t* __restrict__ count, int64_t n_keys,
                  int32_t* __restrict__ starts, int32_t* __restrict__ big,
                  int32_t* __restrict__ counters) {
  __shared__ int base, n_long, long_base;
  const int64_t g = (int64_t)blockIdx.x * kBig + threadIdx.x;
  const int c = g < n_keys ? count[g] : 0;
  if (threadIdx.x == 0) n_long = 0;
  int total;
  const int off = block_exclusive_sum(c, &total);  // synchronises
  const int slot = c > kWarpRun ? atomicAdd(&n_long, 1) : -1;
  if (threadIdx.x == 0) base = atomicAdd(counters, total);
  __syncthreads();
  if (threadIdx.x == 0) long_base = atomicAdd(counters + 1, n_long);
  __syncthreads();
  if (g < n_keys) starts[g] = base + off;
  if (slot >= 0) big[long_base + slot] = (int32_t)g;
}

// Serial fold of n values in shared memory (16-byte aligned).
__device__ __forceinline__ float fold_shared(const float* v, int n) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc = 0.0f;
  int j = 0;
#pragma unroll 4
  for (; j + 4 <= n; j += 4) {
    const float4 q = v4[j >> 2];
    acc = __fadd_rn(acc, q.x);
    acc = __fadd_rn(acc, q.y);
    acc = __fadd_rn(acc, q.z);
    acc = __fadd_rn(acc, q.w);
  }
  for (; j < n; ++j) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// A bucket of up to kThreadRun entries, sorted and folded in registers.
__device__ __forceinline__ float thread_fold(const int32_t* __restrict__ e_in,
                                             int n,
                                             const float* __restrict__ rem,
                                             int K) {
  int32_t e[kThreadRun];
  float v[kThreadRun];
#pragma unroll
  for (int j = 0; j < kThreadRun; ++j) e[j] = j < n ? e_in[j] : INT_MAX;
#pragma unroll
  for (int j = 0; j < kThreadRun; ++j) v[j] = j < n ? rem[e[j] / K] : 0.0f;
#pragma unroll
  for (int size = 2; size <= kThreadRun; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < kThreadRun; ++i) {
        const int j = i ^ stride;
        if (j > i && ((e[i] > e[j]) == ((i & size) == 0))) {
          const int32_t te = e[i];
          e[i] = e[j];
          e[j] = te;
          const float tv = v[i];
          v[i] = v[j];
          v[j] = tv;
        }
      }
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kThreadRun; ++j)
    if (j < n) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// A bucket of kThreadRun < n <= kWarpRun entries: each lane holds two,
// ranks them against all n through shuffles and stages their values at
// the ranks; lane 0 folds (the result is meaningful there only).
__device__ float warp_fold(const int32_t* __restrict__ e_in, int n,
                           const float* __restrict__ rem, int K,
                           float* stage, int lane) {
  int32_t e[2];
  int rank[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    e[h] = i < n ? e_in[i] : INT_MAX;
  }
  for (int j = 0; j < n; ++j) {
    const int32_t o = __shfl_sync(kFull, j < 32 ? e[0] : e[1], j & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) rank[h] += o < e[h];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < n) stage[rank[h]] = rem[e[h] / K];
  __syncwarp();
  const float acc = lane == 0 ? fold_shared(stage, n) : 0.0f;
  __syncwarp();
  return acc;
}

// A bucket of kWarpRun < n <= kBlockRun entries of member b: a bitmap of
// the member's M * K route entries (nw words) ranks each entry by the
// marks below it (thread t counts the marks of a run of consecutive
// words, a block-wide scan turns the counts into run starts, and an entry
// adds the marks before it in its run); each thread holds its entries'
// ranks and values in registers, the values are then staged at the ranks
// over the bitmap, and thread 0 folds them (the result is meaningful there
// only).
__device__ float block_fold(const int32_t* __restrict__ e_in, int n,
                            const float* __restrict__ rem, int K, int nw,
                            int32_t first, uint32_t* bitmap) {
  __shared__ int run_below[kBig];
  const int tid = threadIdx.x;
  for (int i = tid; i < nw; i += blockDim.x) bitmap[i] = 0u;
  __syncthreads();
  int32_t mine[kPerThread];
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    const int i = tid + h * (int)blockDim.x;
    mine[h] = i < n ? e_in[i] - first : -1;
    if (mine[h] >= 0)
      atomicOr(bitmap + (mine[h] >> 5), 1u << (mine[h] & 31));
  }
  __syncthreads();
  const int per = (nw + blockDim.x - 1) / blockDim.x;
  const int w0 = min(nw, tid * per), w1 = min(nw, w0 + per);
  int marks = 0;
  for (int w = w0; w < w1; ++w) marks += __popc(bitmap[w]);
  int total;
  run_below[tid] = block_exclusive_sum(marks, &total);  // synchronises
  __syncthreads();
  int r[kPerThread];
  float v[kPerThread];
#pragma unroll
  for (int h = 0; h < kPerThread; ++h) {
    if (mine[h] < 0) continue;
    const int w = mine[h] >> 5;
    int below = run_below[w / per];
    for (int u = (w / per) * per; u < w; ++u) below += __popc(bitmap[u]);
    r[h] = below + __popc(bitmap[w] & ((1u << (mine[h] & 31)) - 1u));
    v[h] = rem[(first + mine[h]) / K];
  }
  __syncthreads();  // the bitmap is read; its words take the values
  float* stage = reinterpret_cast<float*>(bitmap);
#pragma unroll
  for (int h = 0; h < kPerThread; ++h)
    if (mine[h] >= 0) stage[r[h]] = v[h];
  __syncthreads();
  const float acc = tid == 0 ? fold_shared(stage, n) : 0.0f;
  __syncthreads();
  return acc;
}

// Any bucket of member b on link l: the block walks the member's messages
// in order, a tile at a time, stages the values of each tile's entries on
// the link in order (a block-wide scan of the per-message counts), and
// thread 0 folds them. It reads the member's whole route table, so only
// buckets too long for block_fold take it; the result is meaningful in
// thread 0 only. ``stage`` holds stage_words values, at least K.
__device__ float walk_fold(const int32_t* __restrict__ routes,
                           const uint8_t* __restrict__ active,
                           const float* __restrict__ rem, int M, int K, int b,
                           int32_t l, float* stage, int stage_words) {
  const int tid = threadIdx.x;
  const int tile = min((int)blockDim.x, stage_words / K);
  float acc = 0.0f;
  for (int m0 = 0; m0 < M; m0 += tile) {
    const int m = m0 + tid;
    int c = 0;
    float v = 0.0f;
    if (tid < tile && m < M && active[(int64_t)b * M + m]) {
      const int64_t msg = (int64_t)b * M + m;
      const int32_t* row = routes + msg * K;
      for (int k = 0; k < K; ++k) c += row[k] == l;
      v = rem[msg];
    }
    int total;
    const int off = block_exclusive_sum(c, &total);
    for (int j = 0; j < c; ++j) stage[off + j] = v;
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < total; ++j) acc = __fadd_rn(acc, stage[j]);
    __syncthreads();
  }
  return acc;
}

// Blocks below kRunBlocks share the listed long buckets; every other block
// takes kBig consecutive keys: a thread each for buckets of up to
// kThreadRun, then its warps for those of up to kWarpRun. Dynamic shared
// memory, ``smem_words`` words: the bitmap of a member's route entries
// (``nw`` words, 0 when it does not fit: then every long bucket walks),
// which then takes the staged values, so at least kBlockRun words; the
// stage of walk_fold.
__global__ void __launch_bounds__(kBig)
link_fold_kernel(const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ count,
                 const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ big,
                 const int32_t* __restrict__ counters, int64_t n_keys,
                 const int32_t* __restrict__ routes,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ rem, int M, int K, int Lp, int nw,
                 int smem_words, float* __restrict__ out) {
  extern __shared__ __align__(16) int32_t fold_sm[];
  __shared__ int32_t mid[kBig];
  __shared__ int32_t n_mid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* stage = reinterpret_cast<float*>(fold_sm);

  if (blockIdx.x < kRunBlocks) {
    const int n_long = counters[1];
    for (int i = blockIdx.x; i < n_long; i += kRunBlocks) {
      const int32_t g = big[i];
      const int32_t s = starts[g], n = count[g];
      const int b = g / Lp;
      const float acc = (nw > 0 && n <= kBlockRun)
          ? block_fold(slots + s, n, rem, K, nw, b * M * K,
                       reinterpret_cast<uint32_t*>(fold_sm))
          : walk_fold(routes, active, rem, M, K, b, g % Lp, stage,
                      smem_words);
      if (tid == 0) out[g] = acc;
    }
    return;
  }

  const int64_t g0 = (int64_t)(blockIdx.x - kRunBlocks) * kBig;
  const int64_t g = g0 + tid;
  if (tid == 0) n_mid = 0;
  __syncthreads();
  if (g < n_keys) {
    const int32_t n = count[g];
    if (n <= kThreadRun)
      out[g] = thread_fold(slots + starts[g], n, rem, K);
    else if (n <= kWarpRun)
      mid[atomicAdd(&n_mid, 1)] = tid;
  }
  __syncthreads();
  float* warp_stage = stage + warp * kWarpRun;
  const int n_buckets = n_mid;
  for (int i = warp; i < n_buckets; i += kBig / 32) {
    const int64_t gi = g0 + mid[i];
    const float acc = warp_fold(slots + starts[gi], count[gi], rem, K,
                                warp_stage, lane);
    if (lane == 0) out[gi] = acc;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``routes`` (B, M, K) int32,
// ``active`` (B, M) bool, ``bytes_rem`` (B, M) float32, all contiguous;
// keys are b * Lp + link for 0 <= link < Lp (entries outside that range
// are not counted). ``work`` holds 3 * B * Lp + 2 + 2 * B * M * K int32
// words of scratch (B * M * K < 2^31), carved below. ``out`` (B * Lp)
// float32 gets the sums. Launches on ``stream`` and returns the first
// CUDA error (0 on success). Allocates nothing.
extern "C" int link_demand_launch(const int32_t* routes, const uint8_t* active,
                                  const float* bytes_rem, int B, int M, int K,
                                  int Lp, int32_t* work, float* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_keys = (int64_t)B * Lp;
  const int64_t n_entries = (int64_t)B * M * K;
  if (n_keys == 0) return 0;
  const int wpb = sim_rows::warps_per_block(K);
  if (wpb == 0 || K <= 0) return (int)cudaErrorInvalidValue;
  int32_t* count = work;                  // n_keys
  int32_t* counters = count + n_keys;     // next free place, long buckets
  int32_t* starts = counters + 2;         // n_keys
  int32_t* big = starts + n_keys;         // n_keys
  int32_t* rank = big + n_keys;           // n_entries
  int32_t* slots = rank + n_entries;      // n_entries
  cudaError_t err;

  const int64_t zero_blocks = (n_keys + 2 + kThreads - 1) / kThreads;
  link_zero_kernel<<<(unsigned)(zero_blocks < 1024 ? zero_blocks : 1024),
                     kThreads, 0, st>>>(count, n_keys + 2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int threads = 32 * wpb;
  const dim3 grid((M + threads - 1) / threads, B);
  const size_t rows_smem = (size_t)threads * K * sizeof(int32_t);
  if (M > 0) {
    link_count_kernel<<<grid, threads, rows_smem, st>>>(routes, active, M, K,
                                                        Lp, count, rank);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  link_alloc_kernel<<<(unsigned)((n_keys + kBig - 1) / kBig), kBig, 0, st>>>(
      count, n_keys, starts, big, counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (M > 0) {
    link_place_kernel<<<grid, threads, rows_smem, st>>>(
        routes, active, M, K, Lp, rank, starts, slots);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int64_t member_words = ((int64_t)M * K + 31) / 32;
  const int nw = member_words * 4 <= kFoldBitmapBytes ? (int)member_words : 0;
  const int words = nw > kBlockRun ? nw : kBlockRun;
  const int fold_smem = words * (int)sizeof(int32_t);
  // the opt-in limit of dynamic shared memory, raised at the first call on
  // a device and at each larger one: the kernel's static shared memory
  // counts against the 48 KB a block gets without it, so a dynamic size at
  // or just under 48 KB (the paper fat tree's 12,288-word bitmap) needs it
  // too
  static int fold_smem_allowed[sim_rows::kMaxDevices] = {0};
  err = sim_rows::allow_smem(link_fold_kernel, fold_smem, fold_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const int64_t fold_blocks = kRunBlocks + (n_keys + kBig - 1) / kBig;
  link_fold_kernel<<<(unsigned)fold_blocks, kBig, fold_smem, st>>>(
      starts, count, slots, big, counters, n_keys, routes, active, bytes_rem,
      M, K, Lp, nw, words, out);
  return (int)cudaGetLastError();
}

extern "C" const char* link_demand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
