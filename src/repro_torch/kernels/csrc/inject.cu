// A tick's injection into a dragonfly engine's message pool (sm_90a).
//
// No TPU kernel counterpart: it replaces the reference engine's jnp
// injection (src/repro/netsim/engine.py:634, inject: a cumsum for the
// emission order, UGAL routes from netsim/routing.py for every candidate,
// mode="drop" scatters of the pool's leaves). It computes the function of
// repro_torch.kernels.inject.inject_plain with the dragonfly's router, with
// the same integer and float operations:
//   k[b, i]   = emitted candidates of member b before i (flat order: job,
//               rank, emission slot), for candidates with dst_rank >= 0
//   can       = emitted and k < free_top[b]
//   slot      = free_stack[b, free_top[b] - 1 - k]
//   route     = MIN, or UGAL: the Valiant route through a random group when
//               the minimal route's cost exceeds 2x the Valiant one's + 1e-6
//   pool rows of slot = (active, src_rank, dst_rank, app, size, size, t,
//               t + hops * hop_latency, route)
//   free_top -= n_alloc; dropped += n_emit - n_alloc (n_alloc = min(n_emit,
//               free_top))
//   inj_bytes[b, i] = can ? size : 0  (the wrapper takes the peak from it)
//   tally += (n, n_alloc) summed over members, where a tally is given (a
//               traced graph's count of candidates seen and routed)
//
// Design. The plain version routes every candidate, emitted or not (65,536
// a member on the paper 1D dragonfly, 163,840 on the 2D one), with (n, 10)
// int64 tables, and writes each pool leaf through a copy onto one dummy
// element that every masked candidate hits. A tick emits a few hundred
// messages a member. So, three kernels:
//   1. inject_copy_kernel   one copy of each written pool leaf (16-byte
//                           loads), shared by a tick's batches: the input
//                           state stays as it was;
//   2. inject_count_kernel  per batch, the emitted candidates of each tile
//                           of 2,048;
//   3. inject_route_kernel  per batch, each tile's block sums the counts of
//                           the member's earlier tiles, scans its own tile in
//                           8 rounds of 256 (a ballot per warp, the warps'
//                           counts in shared memory), and routes and writes
//                           only the candidates that get a slot; the
//                           member's last tile writes free_top and dropped.
// A batch after the first (UR's after the jobs') reads the first one's
// free_top: its candidates continue the emission order, as two calls of
// the plain version do.
//
// Bound on an H100 (3.35 TB/s): memory. A tick reads each batch's dst_rank
// twice (4 B a candidate), a routed candidate's inputs, the tables it
// gathers and 20 link demands, copies the 9 pool leaves (69 B a slot:
// 36 MB for 8 paper members, about 11 us each way) and writes the routed
// rows and the injected bytes (4 B a candidate). The copy sets the bound;
// the scan is two passes over a few MB.
//
// Exactness: every route is the integer arithmetic of routing.py in int32
// (all values are non-negative and below 2^31, so / and % agree with the
// int64 ops). A route's cost adds demand[link] / link_bw[link]
// (__fdiv_rn) left to right from slot 0 (__fadd_rn), an empty slot adding
// 0, as routing.route_cost sums; UGAL compares cost_min >
// 2 * cost_val + 1e-6f with the multiply and the add rounded apart, and the
// latency floor is t + (float)hops * hop_latency rounded apart too. The
// file is compiled with --fmad=false, so no multiply and add fuse.
//
// nvcc-flags: --fmad=false

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // TILE in inject.py
constexpr int kRouteWidth = 10;
constexpr int kMaxSegs = 16;
constexpr int kCopyThreads = 256;
constexpr int kCandCols = 7;

struct Segs {
  const char* src[kMaxSegs];
  char* dst[kMaxSegs];
  int64_t bytes[kMaxSegs];
};

// one segment a grid row; 16-byte copies where both ends are aligned
__global__ void inject_copy_kernel(Segs s) {
  const int g = blockIdx.y;
  const char* __restrict__ src = s.src[g];
  char* __restrict__ dst = s.dst[g];
  const int64_t nb = s.bytes[g];
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15u) == 0) {
    const int64_t nv = nb / 16;
    const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
    int4* __restrict__ d4 = reinterpret_cast<int4*>(dst);
    for (int64_t v = i; v < nv; v += step) d4[v] = s4[v];
    for (int64_t b = nv * 16 + i; b < nb; b += step) dst[b] = src[b];
  } else {
    for (int64_t b = i; b < nb; b += step) dst[b] = src[b];
  }
}

// the sum of v over the block, in every thread
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_warp may be read by an earlier call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += s_warp[w];
  return s;
}

__global__ void __launch_bounds__(kThreads) inject_count_kernel(
    const int32_t* __restrict__ dst_rank, int64_t stride_b, int n, int tiles,
    int32_t* __restrict__ tile_count) {
  __shared__ int s_warp[kWarps];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int32_t* d = dst_rank + (int64_t)b * stride_b;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = tile * kTile + r * kThreads + threadIdx.x;
    if (i < n && __ldg(d + i) >= 0) ++c;
  }
  c = block_sum(c, s_warp);
  if (threadIdx.x == 0) tile_count[(int64_t)b * tiles + tile] = c;
}

struct Cands {
  const int32_t* src_rank;
  const int32_t* dst_rank;
  const int32_t* dst_node;
  const int32_t* src_node;
  const float* size;
  const int32_t* app;
  const int64_t* rand;
  int64_t stride[kCandCols];  // member strides (0: one row for all)
  int n;
};

struct Tables {
  const int32_t* local_link_id;  // (R, a)
  const int32_t* global_gw;  // (G, G, lpp)
  const int32_t* global_link_id;  // (G, G, lpp)
  const int32_t* link_dst_router;  // (L,)
  const float* link_bw;  // (L,)
  int G, a, p, cols, lpp, n_nodes, variant_2d, adaptive;
};

struct Pool {
  uint8_t* active;
  int32_t* src_rank;
  int32_t* dst_rank;
  int32_t* job;
  float* size;
  float* bytes_rem;
  float* inject_t;
  float* min_arrive;
  int32_t* routes;  // (B, M, 10)
  int M;
};

// the intra-group leg r_from -> r_to (routing._local_leg): (la, lb), -1
// unused; the 2D dragonfly goes through the corner router (row of from,
// column of to) where no direct link joins them
__device__ __forceinline__ void local_leg(const Tables& T, int r_from,
                                          int r_to, int& la, int& lb) {
  const int l_to = r_to % T.a;
  lb = -1;
  if (r_from == r_to) {
    la = -1;
    return;
  }
  const int direct = __ldg(T.local_link_id + (int64_t)r_from * T.a + l_to);
  if (!T.variant_2d || direct >= 0) {
    la = direct;
    return;
  }
  const int row_f = (r_from % T.a) / T.cols;
  const int corner_l = row_f * T.cols + l_to % T.cols;
  const int corner_r = (r_from / T.a) * T.a + corner_l;
  la = __ldg(T.local_link_id + (int64_t)r_from * T.a + corner_l);
  lb = __ldg(T.local_link_id + (int64_t)corner_r * T.a + l_to);
}

// routing._min_route
__device__ __forceinline__ void min_route(const Tables& T, int src, int dst,
                                          int rnd, int* rt) {
  const int r_s = src / T.p, r_d = dst / T.p;
  const int g_s = r_s / T.a, g_d = r_d / T.a;
  rt[0] = src;
  rt[6] = rt[7] = rt[8] = -1;
  rt[9] = T.n_nodes + dst;
  if (g_s == g_d) {
    local_leg(T, r_s, r_d, rt[1], rt[2]);
    rt[3] = rt[4] = rt[5] = -1;
    return;
  }
  const int e = (g_s * T.G + g_d) * T.lpp + rnd % T.lpp;
  const int gw_r = __ldg(T.global_gw + e);
  const int glink = __ldg(T.global_link_id + e);
  const int r_b = __ldg(T.link_dst_router + glink);
  local_leg(T, r_s, gw_r, rt[1], rt[2]);
  rt[3] = glink;
  local_leg(T, r_b, r_d, rt[4], rt[5]);
}

// routing._val_route through group g_i
__device__ __forceinline__ void val_route(const Tables& T, int src, int dst,
                                          int g_i, int rnd, int* rt) {
  const int r_s = src / T.p, r_d = dst / T.p;
  const int g_s = r_s / T.a, g_d = r_d / T.a;
  const int e1 = (g_s * T.G + g_i) * T.lpp + rnd % T.lpp;
  const int e2 = (g_i * T.G + g_d) * T.lpp + (rnd / T.lpp) % T.lpp;
  const int gw1 = __ldg(T.global_gw + e1);
  const int gl1 = __ldg(T.global_link_id + e1);
  const int r_mid = __ldg(T.link_dst_router + gl1);
  const int gw2 = __ldg(T.global_gw + e2);
  const int gl2 = __ldg(T.global_link_id + e2);
  const int r_b = __ldg(T.link_dst_router + gl2);
  rt[0] = src;
  local_leg(T, r_s, gw1, rt[1], rt[2]);
  rt[3] = gl1;
  local_leg(T, r_mid, gw2, rt[4], rt[5]);
  rt[6] = gl2;
  local_leg(T, r_b, r_d, rt[7], rt[8]);
  rt[9] = T.n_nodes + dst;
}

// routing.route_cost: demand over bandwidth, summed left to right
__device__ __forceinline__ float route_cost(const Tables& T,
                                            const float* __restrict__ dem,
                                            const int* rt) {
  float c = 0.0f;
#pragma unroll
  for (int k = 0; k < kRouteWidth; ++k) {
    float d = 0.0f;
    if (rt[k] >= 0) d = __fdiv_rn(__ldg(dem + rt[k]), __ldg(T.link_bw + rt[k]));
    c = __fadd_rn(c, d);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads) inject_route_kernel(
    Cands c, const int32_t* __restrict__ tile_count, int tiles,
    const int32_t* __restrict__ free_stack,
    const int32_t* __restrict__ free_top, const int32_t* __restrict__ dropped,
    const float* __restrict__ t, const float* __restrict__ demand, int Lp,
    Tables T, float hop_latency, Pool P, int32_t* __restrict__ free_top_out,
    int32_t* __restrict__ dropped_out, float* __restrict__ inj_bytes,
    unsigned long long* __restrict__ tally) {
  __shared__ int s_warp[kWarps];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* counts = tile_count + (int64_t)b * tiles;
  int pre = 0;
  for (int j = threadIdx.x; j < tile; j += kThreads) pre += counts[j];
  pre = block_sum(pre, s_warp);
  const int ft = free_top[b];
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const int n_emit = pre + counts[tile];
    const int n_alloc = n_emit < ft ? n_emit : ft;
    free_top_out[b] = ft - n_alloc;
    dropped_out[b] = dropped[b] + (n_emit - n_alloc);
    if (tally != nullptr) {
      atomicAdd(tally, (unsigned long long)c.n);
      atomicAdd(tally + 1, (unsigned long long)n_alloc);
    }
  }
  const int32_t* dst_rank = c.dst_rank + (int64_t)b * c.stride[1];
  float* inj = inj_bytes + (int64_t)b * c.n;
  const float* dem = demand + (int64_t)b * Lp;
  int run = pre;  // emitted candidates of the member before this round
  for (int r = 0; r < kRounds; ++r) {
    const int i = tile * kTile + r * kThreads + threadIdx.x;
    const bool in = i < c.n;
    const int dr = in ? __ldg(dst_rank + i) : -1;
    const unsigned bal = __ballot_sync(0xffffffffu, dr >= 0);
    __syncthreads();  // the last round's counts have been read
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_warp[w];
      before += w < warp ? v : 0;
      total += v;
    }
    const int k = run + before + __popc(bal & ((1u << lane) - 1u));
    const bool can = dr >= 0 && k < ft;
    float size = 0.0f;
    if (can) size = __ldg(c.size + (int64_t)b * c.stride[4] + i);
    if (in) inj[i] = size;
    if (can) {
      const int slot = __ldg(free_stack + (int64_t)b * P.M + ft - 1 - k);
      const int src = __ldg(c.src_node + (int64_t)b * c.stride[3] + i);
      const int dst = __ldg(c.dst_node + (int64_t)b * c.stride[2] + i);
      const int rnd =
          (int)(__ldg(c.rand + (int64_t)b * c.stride[6] + i) & 0x7FFFFFFF);
      int rt[kRouteWidth];
      min_route(T, src, dst, rnd, rt);
      const int g_s = (src / T.p) / T.a, g_d = (dst / T.p) / T.a;
      if (T.adaptive && g_s != g_d) {
        int g_i = (rnd / 7) % T.G;
        if (g_i == g_s) g_i = (g_i + 1) % T.G;
        if (g_i == g_d) g_i = (g_i + 1) % T.G;
        if (g_i == g_s) g_i = (g_i + 1) % T.G;
        int vr[kRouteWidth];
        val_route(T, src, dst, g_i, rnd, vr);
        const float cost_min = route_cost(T, dem, rt);
        const float cost_val = route_cost(T, dem, vr);
        if (cost_min > __fadd_rn(__fmul_rn(2.0f, cost_val), 1e-6f)) {
#pragma unroll
          for (int q = 0; q < kRouteWidth; ++q) rt[q] = vr[q];
        }
      }
      int hops = 0;
#pragma unroll
      for (int q = 0; q < kRouteWidth; ++q) hops += rt[q] >= 0;
      const int64_t s = (int64_t)b * P.M + slot;
      const float tb = __ldg(t + b);
      P.active[s] = 1;
      P.src_rank[s] = __ldg(c.src_rank + (int64_t)b * c.stride[0] + i);
      P.dst_rank[s] = dr;
      P.job[s] = __ldg(c.app + (int64_t)b * c.stride[5] + i);
      P.size[s] = size;
      P.bytes_rem[s] = size;
      P.inject_t[s] = tb;
      P.min_arrive[s] =
          __fadd_rn(tb, __fmul_rn((float)hops, hop_latency));
      int* row = P.routes + s * kRouteWidth;
#pragma unroll
      for (int q = 0; q < kRouteWidth; ++q) row[q] = rt[q];
    }
    run += total;
  }
}

}  // namespace

extern "C" int inject_copy_launch(const void* const* src, void* const* dst,
                                  const int64_t* bytes, int n_seg,
                                  void* stream) {
  if (n_seg <= 0) return 0;
  if (n_seg > kMaxSegs) return (int)cudaErrorInvalidValue;
  Segs s{};
  int64_t most = 0;
  for (int g = 0; g < n_seg; ++g) {
    s.src[g] = static_cast<const char*>(src[g]);
    s.dst[g] = static_cast<char*>(dst[g]);
    s.bytes[g] = bytes[g];
    most = bytes[g] > most ? bytes[g] : most;
  }
  if (most == 0) return 0;
  int64_t blocks = (most / 16 + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 1056) blocks = 1056;  // 8 a streaming multiprocessor
  if (blocks < 1) blocks = 1;
  inject_copy_kernel<<<dim3((unsigned)blocks, n_seg), kCopyThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}

extern "C" int inject_launch(
    const void* const* cand, const int64_t* cand_stride, int n,
    const int32_t* free_stack, const int32_t* free_top,
    const int32_t* dropped, const float* t, const float* demand, int Lp,
    const int32_t* local_link_id, const int32_t* global_gw,
    const int32_t* global_link_id, const int32_t* link_dst_router,
    const float* link_bw, int G, int a, int p, int cols, int lpp,
    int n_nodes, int variant_2d, int adaptive, float hop_latency,
    void* const* pool_rows, int B, int M, int tiles, int32_t* tile_count,
    int32_t* free_top_out, int32_t* dropped_out, float* inj_bytes,
    int64_t* tally, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (tiles < 1 || (int64_t)tiles * kTile < n || n < 0)
    return (int)cudaErrorInvalidValue;
  Cands c;
  c.src_rank = static_cast<const int32_t*>(cand[0]);
  c.dst_rank = static_cast<const int32_t*>(cand[1]);
  c.dst_node = static_cast<const int32_t*>(cand[2]);
  c.src_node = static_cast<const int32_t*>(cand[3]);
  c.size = static_cast<const float*>(cand[4]);
  c.app = static_cast<const int32_t*>(cand[5]);
  c.rand = static_cast<const int64_t*>(cand[6]);
  for (int q = 0; q < kCandCols; ++q) c.stride[q] = cand_stride[q];
  c.n = n;
  const Tables T{local_link_id, global_gw, global_link_id, link_dst_router,
                 link_bw, G, a, p, cols, lpp, n_nodes, variant_2d, adaptive};
  Pool P;
  P.active = static_cast<uint8_t*>(pool_rows[0]);
  P.src_rank = static_cast<int32_t*>(pool_rows[1]);
  P.dst_rank = static_cast<int32_t*>(pool_rows[2]);
  P.job = static_cast<int32_t*>(pool_rows[3]);
  P.size = static_cast<float*>(pool_rows[4]);
  P.bytes_rem = static_cast<float*>(pool_rows[5]);
  P.inject_t = static_cast<float*>(pool_rows[6]);
  P.min_arrive = static_cast<float*>(pool_rows[7]);
  P.routes = static_cast<int32_t*>(pool_rows[8]);
  P.M = M;
  const dim3 grid(tiles, B);
  inject_count_kernel<<<grid, kThreads, 0, s>>>(c.dst_rank, c.stride[1], n,
                                                tiles, tile_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inject_route_kernel<<<grid, kThreads, 0, s>>>(
      c, tile_count, tiles, free_stack, free_top, dropped, t, demand, Lp, T,
      hop_latency, P, free_top_out, dropped_out, inj_bytes,
      reinterpret_cast<unsigned long long*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* inject_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
