// The route-rate-drain of one member's message pool for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/router_tick.py::
// router_rate_drain_pallas. It computes the same function as
// repro_torch.kernels.router_tick.router_rate_drain_plain, with the same
// float operations:
//   rate  r[m] = min over the valid route links l of share[l]
//                (0 if the message is inactive or the min is not finite)
//   drain d[m] = min(r * dt, rem)
//   new_rem    = rem - d
//   drained    = active & new_rem <= 1e-6f
//
// Design. One thread per message; a thread reads its route row of K link
// ids and gathers the share of each link. The Pallas kernel keeps the
// share table resident in VMEM; here it stays in device memory and the
// 50 MB L2 holds it (L * 4 B = 215 KB for the paper's 1D dragonfly and
// 296 KB for the 2D one, above the 227 KB of shared memory a block may
// use, and read through the read-only cache). Nothing is padded: the
// ragged edge of M is masked. Nothing is summed, so the result does not
// depend on an order.
//
// Bound on an H100 (3.35 TB/s): memory. Per call the kernel must read
// routes (M*K*4 B), bytes_rem (M*4 B), active (M B) and the share table
// (L*4 B), and write new_rem, rate (M*4 B each) and drained (M B). At the
// paper's 1D shapes (M=65536, K=10, L=53856) that is 3.7 MB, about 1.1 us;
// the arithmetic is one compare per route entry.
//
// Exactness: the multiply and the subtract use __fmul_rn / __fsub_rn (never
// contracted into an FMA) and the file is compiled without fast math, so
// every result is the correctly rounded IEEE value the reference computes.
// The drained threshold is the float literal 1e-6f, as the reference's
// float32 compare.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void rate_drain_kernel(const int32_t* __restrict__ routes,
                                  const float* __restrict__ bytes_rem,
                                  const uint8_t* __restrict__ active,
                                  const float* __restrict__ share, float dt,
                                  int M, int K,
                                  float* __restrict__ new_rem,
                                  float* __restrict__ rate_out,
                                  uint8_t* __restrict__ drained) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const bool act = active[m] != 0;
  const float rem = bytes_rem[m];
  float rmin = INFINITY;
  if (act) {
    const int32_t* row = routes + (int64_t)m * K;
    for (int k = 0; k < K; ++k) {
      const int32_t l = row[k];
      if (l >= 0) rmin = fminf(rmin, __ldg(share + l));
    }
  }
  const float rate = (act && isfinite(rmin)) ? rmin : 0.0f;
  const float drain = fminf(__fmul_rn(rate, dt), rem);
  const float left = __fsub_rn(rem, drain);
  new_rem[m] = left;
  rate_out[m] = rate;
  drained[m] = (act && left <= 1e-6f) ? 1 : 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches the kernel on
// ``stream`` and returns the launch's CUDA error (0 on success). Allocates
// nothing.
extern "C" int router_rate_drain_launch(
    const int32_t* routes, const float* bytes_rem, const uint8_t* active,
    const float* share, float dt, int M, int K, float* new_rem, float* rate,
    uint8_t* drained, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rate_drain_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      routes, bytes_rem, active, share, dt, M, K, new_rem, rate, drained);
  return (int)cudaGetLastError();
}

extern "C" const char* router_rate_drain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
