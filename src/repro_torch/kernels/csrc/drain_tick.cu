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
// one sequential TPU grid. GPU blocks run in no order, so the two phases
// are two launches on one stream: kernel 1 counts with int32 atomics (exact
// in any order), kernel 2 does the whole drain for one message per thread.
// The count table is (L+1) int32 per member: 215 KB for the paper's 1D
// dragonfly and 296 KB for the 2D one, at or above the 227 KB of shared
// memory one block may use, so it stays in device memory and the 50 MB L2
// holds it. The ragged edge (M not a multiple of the block) is masked here;
// nothing is padded. The byte deltas are float atomics, so their sums are
// taken in run-to-run varying order (metrics only; the integer trajectory
// does not read them).
//
// Bound on an H100 (3.35 TB/s): memory. Per member and tick the kernel must
// read routes (M*K*4 B), bytes_rem, min_arrive, job (M*4 B each), active
// (M B), bw_eff and link_dst_router ((L+1)*4 B each) and write new_rem,
// rate (M*4 B each), delivered (M B) and the two delta tables. At paper 1D
// (M=65536, K=10, L+1=53857, workload1's 5 apps x 1056 routers) that is
// 4.73 MB, about 1.41 us; the arithmetic is a few operations per byte. Two
// launches of a few microseconds each dominate at this size.
//
// Exactness: the share divide and multiply use __fdiv_rn / __fmul_rn and
// the file is compiled without fast math and with --fmad=false, so every
// float result is the correctly rounded IEEE value the reference computes.
// The delivery threshold is the float literal 1e-6f: with a double literal
// the compare would run in double and deliver on another tick.
//
// nvcc-flags: --fmad=false

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void count_kernel(const int32_t* __restrict__ routes,
                             const uint8_t* __restrict__ active,
                             int M, int K, int Lp,
                             int32_t* __restrict__ count) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (m >= M) return;
  const int64_t msg = (int64_t)b * M + m;
  if (!active[msg]) return;
  const int32_t* row = routes + msg * K;
  int32_t* cnt = count + (int64_t)b * Lp;
  for (int k = 0; k < K; ++k) {
    const int32_t l = row[k];
    if (l >= 0) atomicAdd(cnt + l, 1);
  }
}

__global__ void drain_kernel(const int32_t* __restrict__ routes,
                             const float* __restrict__ bytes_rem,
                             const uint8_t* __restrict__ active,
                             const int32_t* __restrict__ job,
                             const float* __restrict__ min_arrive,
                             const float* __restrict__ t, float dt,
                             const float* __restrict__ bw, int64_t bw_stride,
                             const int32_t* __restrict__ link_dst_router,
                             const int32_t* __restrict__ count,
                             int M, int K, int Lp, int n_apps, int n_routers,
                             float* __restrict__ new_rem,
                             float* __restrict__ rate_out,
                             uint8_t* __restrict__ delivered,
                             float* __restrict__ link_bytes_delta,
                             float* __restrict__ router_win_delta) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (m >= M) return;
  const int64_t msg = (int64_t)b * M + m;
  const bool act = active[msg] != 0;
  const float rem = bytes_rem[msg];
  const int32_t* row = routes + msg * K;
  const int32_t* cnt = count + (int64_t)b * Lp;
  const float* bw_b = bw + (int64_t)b * bw_stride;

  float rmin = INFINITY;
  if (act) {
    for (int k = 0; k < K; ++k) {
      const int32_t l = row[k];
      if (l < 0) continue;
      const float n = fmaxf((float)cnt[l], 1.0f);
      const float share = __fmul_rn(__fdiv_rn(bw_b[l], n), 1e-6f);
      rmin = fminf(rmin, share);
    }
  }
  const float rate = (act && isfinite(rmin)) ? rmin : 0.0f;
  const float drain = fminf(__fmul_rn(rate, dt), rem);
  const float left = __fsub_rn(rem, drain);
  new_rem[msg] = left;
  rate_out[msg] = rate;
  delivered[msg] = (act && left <= 1e-6f && t[b] >= min_arrive[msg]) ? 1 : 0;

  if (!act) return;
  float* lb = link_bytes_delta + (int64_t)b * Lp;
  float* rw = router_win_delta
      + ((int64_t)b * n_apps + job[msg]) * (int64_t)n_routers;
  for (int k = 0; k < K; ++k) {
    const int32_t l = row[k];
    if (l < 0) continue;
    atomicAdd(lb + l, drain);
    atomicAdd(rw + link_dst_router[l], drain);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Zeroes the count table and the
// two delta tables, launches both kernels on ``stream`` and returns the
// first CUDA error (0 on success). Allocates nothing.
extern "C" int drain_tick_launch(
    const int32_t* routes, const float* bytes_rem, const uint8_t* active,
    const int32_t* job, const float* min_arrive, const float* t, float dt,
    const float* bw, int64_t bw_stride, const int32_t* link_dst_router,
    int B, int M, int K, int Lp, int n_apps, int n_routers,
    int32_t* count, float* new_rem, float* rate, uint8_t* delivered,
    float* link_bytes_delta, float* router_win_delta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  err = cudaMemsetAsync(count, 0, sizeof(int32_t) * (size_t)B * Lp, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(link_bytes_delta, 0, sizeof(float) * (size_t)B * Lp, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(router_win_delta, 0,
                        sizeof(float) * (size_t)B * n_apps * n_routers, s);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || B == 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  count_kernel<<<grid, kThreads, 0, s>>>(routes, active, M, K, Lp, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  drain_kernel<<<grid, kThreads, 0, s>>>(
      routes, bytes_rem, active, job, min_arrive, t, dt, bw, bw_stride,
      link_dst_router, count, M, K, Lp, n_apps, n_routers, new_rem, rate,
      delivered, link_bytes_delta, router_win_delta);
  return (int)cudaGetLastError();
}

extern "C" const char* drain_tick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
