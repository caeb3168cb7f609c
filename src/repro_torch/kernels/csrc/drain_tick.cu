// The fused drain tick (engine steps 2-3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/drain_tick.py::drain_tick_pallas.
// It computes the same function as repro_torch.kernels.drain_tick.
// drain_tick_plain, with the same float operations in the same order:
//   count   n[b, l]  = number of active messages whose route crosses link l
//   share   s[b, l]  = bw[b, l] / max(n, 1) * 1e-6          (correctly rounded)
//   rate    r[b, m]  = min over the route of s (0 if inactive or not finite)
//   drain   d[b, m]  = min(r * dt, rem)
//   new_rem          = rem - d
//   delivered        = active & new_rem <= 1e-6f & t[b] >= min_arrive
//   link_bytes_delta[b, l]               += d  for every route link
//   router_win_delta[b, job, dst_rtr(l)] += d  for every route link
//
// Design. The Pallas kernel carries the count table across two phases of
// one sequential TPU grid. GPU blocks run in no order, so the phases are
// launches on one stream, three a call:
//   1. drain_zero_kernel   zeroes the count table;
//   2. drain_count_kernel  zeroes the two delta tables (the drain adds into
//                          them after it, in stream order) and counts the
//                          active route entries per link with int32
//                          atomics, exact in any order;
//   3. drain_kernel        one message per thread: the route's shares, the
//                          rate, the drain, the delivery flag and the two
//                          byte deltas.
// A warp copies its 32 messages' route rows (32 * K contiguous words) to
// shared memory with 16-byte loads in both counting and drain passes
// (sim_rows.cuh), and skips them when all 32 are inactive. The drain pass
// loads a row's counts and bandwidths together, then divides, so a row
// costs one round trip to the L2, not one per route link. The count table
// is (L+1) int32 per member, 215 KB for the paper's 1D dragonfly and
// 296 KB for the 2D one, at or above the 227 KB of shared memory one block
// may use, so it stays in device memory (the 50 MB L2 holds it), and so
// does the link-byte table, with one float atomic per route entry that
// drained bytes. The router-window table is small (5 apps x 1,056 routers,
// 21 KB a member on 1D) and each of its entries takes many adds a tick: a
// block sums its messages' adds in shared memory and adds its table to
// device memory once, 16 bytes an atomic (sm_90's float4 atomicAdd),
// skipping the quads it did not touch. Where the table does not fit beside
// the rows, the adds go to device memory one by one. A link that over
// 1,024 route entries cross (counted in pass 2) would take so many equal
// float adds in one chain that the sum would drift from the true one:
// its adds are summed per warp (__match_any_sync and a tree of shuffles)
// and per block (a few shared slots keyed by link) before one atomic a
// block, and the warp's window adds with them. The byte deltas are
// float sums taken in run-to-run varying order (metrics only; the integer
// trajectory does not read them); an add of 0 changes no sum, so a
// message that drained nothing adds nothing. The ragged edge (M not a
// multiple of the block) is masked here; nothing is padded.
//
// Bound on an H100 (3.35 TB/s): memory. Per member and tick the kernel must
// read routes (M*K*4 B), bytes_rem, min_arrive, job (M*4 B each), active
// (M B), bw_eff and link_dst_router ((L+1)*4 B each) and write new_rem,
// rate (M*4 B each), delivered (M B) and the two delta tables. At paper 1D
// (M=65536, K=10, L+1=53857, workload1's 5 apps x 1056 routers) that is
// 4.73 MB, about 1.41 us; the arithmetic is a few operations per byte.
// Three launches and the atomics on the count and link tables dominate.
//
// Exactness: the share divide and multiply use __fdiv_rn / __fmul_rn and
// the file is compiled without fast math and with --fmad=false, so every
// float result is the correctly rounded IEEE value the reference computes.
// The delivery threshold is the float literal 1e-6f: with a double literal
// the compare would run in double and deliver on another tick. Both
// minima keep a NaN (sim_rows::nan_min), as torch.amin and torch.minimum
// do: a NaN bandwidth gives its messages a rate of 0, and a NaN rem
// drains NaN bytes into the byte deltas. fminf would drop the NaN and
// drain those messages.
//
// nvcc-flags: --fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sim_rows.cuh"

namespace {

constexpr int kZeroThreads = 256;
constexpr int kBatch = 16;  // route links whose loads are issued together
constexpr int kHot = 1024;  // links counted more often: summed per block
constexpr int kHotSlots = 32;  // shared slots a block keeps for them
// dynamic shared memory a block may take beside its static slots
constexpr int kMaxSharedBytes = 226 * 1024;
constexpr unsigned kFull = sim_rows::kFullMask;

// The sum of ``x`` over the lanes of ``peers`` (the calling lane's group
// of __match_any_sync), meaningful in the group's lowest lane: a tree over
// the group in which every lane of the warp takes part.
__device__ __forceinline__ float group_sum(unsigned peers, float x, int lane) {
  int rel = __popc(peers & ((1u << lane) - 1u));  // rank in the group
  unsigned above = peers & ~((2u << lane) - 1u);  // its later lanes
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);
    const float y = __shfl_sync(kFull, x, next > 0 ? next - 1 : lane);
    if (next > 0) x += y;
    above &= ~__ballot_sync(kFull, rel & 1);
    rel >>= 1;
  }
  return x;
}

__global__ void drain_zero_kernel(int32_t* __restrict__ p, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    p[i] = 0;
}

__global__ void drain_count_kernel(const int32_t* __restrict__ routes,
                                   const uint8_t* __restrict__ active,
                                   int M, int K, int Lp, int AR,
                                   int32_t* __restrict__ count,
                                   float* __restrict__ link_bytes_delta,
                                   float* __restrict__ router_win_delta) {
  extern __shared__ int32_t rows_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  // the member's two delta tables, spread over the blocks of its row
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < Lp; i += stride)
    link_bytes_delta[(int64_t)b * Lp + i] = 0.0f;
  for (int i = first; i < AR; i += stride)
    router_win_delta[(int64_t)b * AR + i] = 0.0f;

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
  int32_t* cnt = count + (int64_t)b * Lp;
  for (int k = 0; k < K; ++k) {
    const int32_t l = row[k];
    if (l >= 0 && l < Lp) atomicAdd(cnt + l, 1);
  }
}

// kSharedRw: the block sums its router-window adds in shared memory (the
// member's A * R table sits before the staged rows) and adds the table to
// device memory once; otherwise every add is a device atomic.
template <bool kSharedRw>
__global__ void drain_kernel(const int32_t* __restrict__ routes,
                             const float* __restrict__ bytes_rem,
                             const uint8_t* __restrict__ active,
                             const int32_t* __restrict__ job,
                             const float* __restrict__ min_arrive,
                             const float* __restrict__ t, float dt,
                             const float* __restrict__ bw, int64_t bw_stride,
                             const int32_t* __restrict__ link_dst_router,
                             const int32_t* __restrict__ count,
                             int M, int K, int Lp, int n_routers, int AR,
                             int rows_offset,
                             float* __restrict__ new_rem,
                             float* __restrict__ rate_out,
                             uint8_t* __restrict__ delivered,
                             float* __restrict__ link_bytes_delta,
                             float* __restrict__ router_win_delta) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t hot_link[kHotSlots];
  __shared__ float hot_sum[kHotSlots];
  float* table = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  if (kSharedRw)
    for (int i = tid; i < AR; i += blockDim.x) table[i] = 0.0f;
  if (tid < kHotSlots) {
    hot_link[tid] = -1;
    hot_sum[tid] = 0.0f;
  }
  __syncthreads();

  const int m0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  const int m = m0 + lane;
  const bool in = m < M;
  const int64_t msg = (int64_t)b * M + m;
  const bool act = in && active[msg] != 0;
  const float rem = in ? bytes_rem[msg] : 0.0f;
  const int32_t* cnt = count + (int64_t)b * Lp;
  const float* bw_b = bw + (int64_t)b * bw_stride;
  int32_t* sm = smem + rows_offset + warp * 32 * K;
  const int32_t* row = sm + lane * K;

  float rmin = INFINITY;
  unsigned hot = 0u;  // the route slots (< 32) on links with over kHot
  if (__ballot_sync(kFull, act)) {
    sim_rows::warp_stage(routes + ((int64_t)b * M + m0) * K,
                         min(32, M - m0) * K, sm, lane);
    if (act) {
      for (int k0 = 0; k0 < K; k0 += kBatch) {
        int32_t l[kBatch];
        int32_t c[kBatch];
        float w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int32_t x = k0 + j < K ? row[k0 + j] : -1;
          l[j] = (x >= 0 && x < Lp) ? x : -1;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          c[j] = l[j] >= 0 ? cnt[l[j]] : 0;
          w[j] = l[j] >= 0 ? bw_b[l[j]] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (l[j] < 0) continue;
          if (c[j] > kHot && k0 + j < 32) hot |= 1u << (k0 + j);
          const float nl = fmaxf((float)c[j], 1.0f);
          rmin = sim_rows::nan_min(
              rmin, __fmul_rn(__fdiv_rn(w[j], nl), 1e-6f));
        }
      }
    }
  }
  const float rate = (act && isfinite(rmin)) ? rmin : 0.0f;
  const float drain = sim_rows::nan_min(__fmul_rn(rate, dt), rem);
  const float left = __fsub_rn(rem, drain);
  if (in) {
    new_rem[msg] = left;
    rate_out[msg] = rate;
    delivered[msg] = (act && left <= 1e-6f && t[b] >= min_arrive[msg]) ? 1 : 0;
  }

  // the byte deltas (an add of 0 changes no sum, so a message that
  // drained nothing adds nothing)
  const bool adds = act && drain != 0.0f;
  float* lb = link_bytes_delta + (int64_t)b * Lp;
  float* rw = kSharedRw ? table : router_win_delta + (int64_t)b * AR;
  const int jr = adds ? job[msg] * n_routers : 0;  // the app's window row
  if (__any_sync(kFull, adds && hot != 0u)) {
    // a link that most of the pool crosses takes so many equal adds that
    // one chain of float32 atomics would drift from the true sum; its
    // adds are summed in a tree per warp, then per block in shared memory
    // (a few slots keyed by link), and the block adds its sum once; the
    // router-window adds of the warp are summed per entry in the same way
    for (int k = 0; k < K; ++k) {
      const int32_t l = adds ? row[k] : -1;
      const bool valid = l >= 0 && l < Lp;
      const bool h = valid && k < 32 && ((hot >> k) & 1u);
      unsigned peers = __match_any_sync(kFull, h ? l : -1 - lane);
      float sum = group_sum(peers, drain, lane);
      if (h && lane == __ffs(peers) - 1) {
        const int slot = l & (kHotSlots - 1);
        const int32_t was = atomicCAS(&hot_link[slot], -1, l);
        if (was == -1 || was == l)
          atomicAdd(&hot_sum[slot], sum);
        else
          atomicAdd(lb + l, sum);
      }
      if (valid && !h) atomicAdd(lb + l, drain);
      const int r = valid ? jr + link_dst_router[l] : -1;
      peers = __match_any_sync(kFull, valid ? r : -1 - lane);
      sum = group_sum(peers, drain, lane);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(rw + r, sum);
    }
  } else if (adds) {
    for (int k = 0; k < K; ++k) {
      const int32_t l = row[k];
      if (l < 0 || l >= Lp) continue;
      atomicAdd(lb + l, drain);
      atomicAdd(rw + jr + link_dst_router[l], drain);
    }
  }

  __syncthreads();
  if (tid < kHotSlots && hot_link[tid] >= 0)
    atomicAdd(link_bytes_delta + (int64_t)b * Lp + hot_link[tid],
              hot_sum[tid]);
  if (kSharedRw) {
    float* out = router_win_delta + (int64_t)b * AR;
    if ((AR & 3) == 0 && ((uintptr_t)out & 15u) == 0) {
      const float4* t4 = reinterpret_cast<const float4*>(table);
      float4* o4 = reinterpret_cast<float4*>(out);
      for (int i = tid; i < (AR >> 2); i += blockDim.x) {
        const float4 v = t4[i];
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
          atomicAdd(o4 + i, v);
      }
    } else {
      for (int i = tid; i < AR; i += blockDim.x)
        if (table[i] != 0.0f) atomicAdd(out + i, table[i]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``count`` is (B, Lp) int32
// scratch. Launches the three kernels on ``stream`` and returns the first
// CUDA error (0 on success). Allocates nothing.
extern "C" int drain_tick_launch(
    const int32_t* routes, const float* bytes_rem, const uint8_t* active,
    const int32_t* job, const float* min_arrive, const float* t, float dt,
    const float* bw, int64_t bw_stride, const int32_t* link_dst_router,
    int B, int M, int K, int Lp, int n_apps, int n_routers,
    int32_t* count, float* new_rem, float* rate, uint8_t* delivered,
    float* link_bytes_delta, float* router_win_delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const int wpb = sim_rows::warps_per_block(K);
  if (wpb == 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * wpb;
  const int AR = n_apps * n_routers;
  const int rows_bytes = threads * K * (int)sizeof(int32_t);
  cudaError_t err;

  const int64_t n_count = (int64_t)B * Lp;
  const int64_t zero_blocks = (n_count + kZeroThreads - 1) / kZeroThreads;
  drain_zero_kernel<<<(unsigned)(zero_blocks < 1024 ? zero_blocks : 1024),
                      kZeroThreads, 0, s>>>(count, n_count);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // at least one block per member, to zero its delta tables when M = 0
  const int blocks_x = M > 0 ? (M + threads - 1) / threads : 1;
  const dim3 grid(blocks_x, B);
  drain_count_kernel<<<grid, threads, rows_bytes, s>>>(
      routes, active, M, K, Lp, AR, count, link_bytes_delta,
      router_win_delta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (M == 0) return 0;

  const int table_bytes = ((AR * (int)sizeof(float) + 15) / 16) * 16;
  if (table_bytes + rows_bytes <= kMaxSharedBytes) {
    const int smem = table_bytes + rows_bytes;
    // the opt-in limit, raised at the first call on a device and at each
    // larger one (the hot-link slots' static shared memory counts against
    // the 48 KB a block gets without it); a first call inside a graph
    // capture sets it there
    static int smem_allowed[sim_rows::kMaxDevices] = {0};
    err = sim_rows::allow_smem(drain_kernel<true>, smem, smem_allowed);
    if (err != cudaSuccess) return (int)err;
    drain_kernel<true><<<grid, threads, smem, s>>>(
        routes, bytes_rem, active, job, min_arrive, t, dt, bw, bw_stride,
        link_dst_router, count, M, K, Lp, n_routers, AR,
        table_bytes / (int)sizeof(int32_t), new_rem, rate, delivered,
        link_bytes_delta, router_win_delta);
  } else {
    drain_kernel<false><<<grid, threads, rows_bytes, s>>>(
        routes, bytes_rem, active, job, min_arrive, t, dt, bw, bw_stride,
        link_dst_router, count, M, K, Lp, n_routers, AR, 0, new_rem, rate,
        delivered, link_bytes_delta, router_win_delta);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* drain_tick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
