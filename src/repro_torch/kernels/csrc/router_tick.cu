// The route-rate-drain of one member's message pool for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/router_tick.py::
// router_rate_drain_pallas. It computes the same function as
// repro_torch.kernels.router_tick.router_rate_drain_plain, with the same
// float operations:
//   rate  r[m] = min over the valid route links l of share[l], NaN if one
//                of them is NaN (0 if the message is inactive or the min
//                is not finite)
//   drain d[m] = min(r * dt, rem)
//   new_rem    = rem - d
//   drained    = active & new_rem <= 1e-6f
//
// Bound on an H100 (3.35 TB/s): memory. Per call the kernel must read
// routes (M*K*4 B), bytes_rem (M*4 B), active (M B) and the share table
// (L*4 B), and write new_rem, rate (M*4 B each) and drained (M B). At the
// paper's 1D shapes (M=65536, K=10, L=53857) that is 3.7 MB, about 1.1 us;
// the arithmetic is one compare per route entry. What holds a call is not
// that: measured (tools/sim_kernels_ab.py), an empty launch of the grid
// takes about 1.6-1.8 us in a CUDA graph, and the random gathers of half
// a pool's 655,360 route entries about 2.4 us more, each gather a 32-byte
// sector from the L2 and, in its warp's load, a line of its own for the
// L1 to look up. No block shape, messages a thread or cache policy moved
// them; the share table does not fit beside the rows in one SM's shared
// memory on the 2D dragonfly, and copying all of it into every SM would
// move more bytes than the gathers do.
//
// Design. A thread takes kPerThread consecutive messages (one: more made
// the live pool slower and the random one no faster). It loads their
// flags and remaining bytes, then the route rows of its active messages
// only (a warp whose messages are all inactive issues no row load), then
// gathers the share of every valid route link. At the paper's route width
// K = 10, a compile-time instantiation loads a 40-byte row as five
// aligned 8-byte words and issues all its gathers before the first
// compare, so a message costs three dependent trips to the L2 (flags,
// row, shares), not one pair of trips per route link. The share table
// stays in device memory (the 50 MB L2 holds it: L * 4 B is 215 KB for
// the paper's 1D dragonfly and 296 KB for the 2D one). With kPerThread > 1
// the flags, the remaining bytes and the three outputs move as one vector
// access each. Other widths, and tensors not aligned for the vector
// accesses, take a generic path: one message a thread, its route links
// gathered kBatch at a time. The ragged edge of M is masked; nothing is
// padded. Nothing is summed, so no result depends on an order. kThreads
// and kPerThread were chosen by measurement: tools/sim_kernels_ab.py
// builds this file with other values.
//
// Exactness: the multiply and the subtract use __fmul_rn / __fsub_rn (never
// contracted into an FMA) and the file is compiled without fast math, so
// every result is the correctly rounded IEEE value the reference computes.
// The running minimum keeps a NaN (sim_rows::nan_min), as jnp.min and
// torch.amin do; fminf would drop it and give a NaN share's message a
// rate. The drain's min(r * dt, rem) stays fminf: a NaN rem gives a NaN
// new_rem and a false drained either way, and the drain itself is not an
// output. The drained threshold is the float literal 1e-6f, as the
// reference's float32 compare.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sim_rows.cuh"

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kPerThread = 1;   // consecutive messages a thread (1, 2 or 4)
constexpr int kPaperK = 10;     // the route width instantiated at compile time
constexpr int kGenericThreads = 256;
constexpr int kBatch = 8;       // generic path: route links gathered together

// The vector types of kPerThread floats and of kPerThread flag bytes.
template <int P> struct Vec;
template <> struct Vec<1> { using F = float;  using B = unsigned char; };
template <> struct Vec<2> { using F = float2; using B = unsigned short; };
template <> struct Vec<4> { using F = float4; using B = unsigned int; };

__device__ __forceinline__ void finish(bool act, float rem, float rmin,
                                       float dt, float& left, float& rate,
                                       unsigned char& drained) {
  rate = (act && isfinite(rmin)) ? rmin : 0.0f;
  const float drain = fminf(__fmul_rn(rate, dt), rem);
  left = __fsub_rn(rem, drain);
  drained = (act && left <= 1e-6f) ? 1 : 0;
}

// kPerThread messages a thread at the compile-time route width K.
template <int K, int P>
__global__ void __launch_bounds__(kThreads)
rate_drain_kernel(const int32_t* __restrict__ routes,
                  const float* __restrict__ bytes_rem,
                  const uint8_t* __restrict__ active,
                  const float* __restrict__ share, float dt, int M,
                  float* __restrict__ new_rem, float* __restrict__ rate_out,
                  uint8_t* __restrict__ drained) {
  using VF = typename Vec<P>::F;
  using VB = typename Vec<P>::B;
  static_assert(K % 2 == 0, "rows are loaded as 8-byte words");
  const int64_t m0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * P;
  if (m0 >= M) return;
  const bool whole = m0 + P <= M;  // false only at the ragged edge

  float rem[P];
  unsigned char flag[P];
  if (whole) {
    const VF r = __ldg(reinterpret_cast<const VF*>(bytes_rem + m0));
    const VB a = __ldg(reinterpret_cast<const VB*>(active + m0));
    memcpy(rem, &r, sizeof r);
    memcpy(flag, &a, sizeof a);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool in = m0 + j < M;
      rem[j] = in ? bytes_rem[m0 + j] : 0.0f;
      flag[j] = in ? active[m0 + j] : 0;
    }
  }

  // every row word of the active messages, then every gather
  int32_t l[P][K];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int2* row = reinterpret_cast<const int2*>(routes + (m0 + j) * K);
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      const int2 w = flag[j] ? __ldg(row + k) : make_int2(-1, -1);
      l[j][2 * k] = w.x;
      l[j][2 * k + 1] = w.y;
    }
  }
  float s[P][K];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[j][k] = l[j][k] >= 0 ? __ldg(share + l[j][k]) : INFINITY;

  float left[P], rate[P];
  unsigned char out[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float rmin = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) rmin = sim_rows::nan_min(rmin, s[j][k]);
    finish(flag[j] != 0, rem[j], rmin, dt, left[j], rate[j], out[j]);
  }

  if (whole) {
    VF v;
    VB b;
    memcpy(&v, left, sizeof v);
    *reinterpret_cast<VF*>(new_rem + m0) = v;
    memcpy(&v, rate, sizeof v);
    *reinterpret_cast<VF*>(rate_out + m0) = v;
    memcpy(&b, out, sizeof b);
    *reinterpret_cast<VB*>(drained + m0) = b;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (m0 + j < M) {
        new_rem[m0 + j] = left[j];
        rate_out[m0 + j] = rate[j];
        drained[m0 + j] = out[j];
      }
  }
}

// One message a thread at any route width and alignment.
__global__ void rate_drain_generic_kernel(
    const int32_t* __restrict__ routes, const float* __restrict__ bytes_rem,
    const uint8_t* __restrict__ active, const float* __restrict__ share,
    float dt, int M, int K, float* __restrict__ new_rem,
    float* __restrict__ rate_out, uint8_t* __restrict__ drained) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const bool act = active[m] != 0;
  const float rem = bytes_rem[m];
  float rmin = INFINITY;
  if (act) {
    const int32_t* row = routes + (int64_t)m * K;
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      int32_t l[kBatch];
      float s[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) l[j] = k0 + j < K ? row[k0 + j] : -1;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        s[j] = l[j] >= 0 ? __ldg(share + l[j]) : INFINITY;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) rmin = sim_rows::nan_min(rmin, s[j]);
    }
  }
  float left, rate;
  unsigned char out;
  finish(act, rem, rmin, dt, left, rate, out);
  new_rem[m] = left;
  rate_out[m] = rate;
  drained[m] = out;
}

bool aligned(const void* p, unsigned bytes) {
  return ((uintptr_t)p & (bytes - 1u)) == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches one kernel on
// ``stream`` and returns the launch's CUDA error (0 on success). Allocates
// nothing. The compile-time path needs K = 10, 8-byte aligned routes and
// the other tensors aligned for kPerThread-wide accesses (as the wrapper's
// fresh outputs and whole tensors are); anything else takes the generic
// path, with the same results.
extern "C" int router_rate_drain_launch(
    const int32_t* routes, const float* bytes_rem, const uint8_t* active,
    const float* share, float dt, int M, int K, float* new_rem, float* rate,
    uint8_t* drained, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr unsigned kF = 4u * kPerThread, kB = kPerThread;
  if (K == kPaperK && aligned(routes, 8) && aligned(bytes_rem, kF) &&
      aligned(new_rem, kF) && aligned(rate, kF) && aligned(active, kB) &&
      aligned(drained, kB)) {
    const int64_t threads = ((int64_t)M + kPerThread - 1) / kPerThread;
    rate_drain_kernel<kPaperK, kPerThread>
        <<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            routes, bytes_rem, active, share, dt, M, new_rem, rate, drained);
  } else {
    rate_drain_generic_kernel<<<(M + kGenericThreads - 1) / kGenericThreads,
                                kGenericThreads, 0, s>>>(
        routes, bytes_rem, active, share, dt, M, K, new_rem, rate, drained);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* router_rate_drain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
