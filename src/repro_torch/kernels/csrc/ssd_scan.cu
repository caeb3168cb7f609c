// The Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas.
// It computes the same function as repro_torch.kernels.ssd_scan.
// ssd_scan_plain. For each (batch * head) row and each chunk of Q steps,
// with cs = cumsum(dt * A) over the chunk and h the state entering it:
//   y = (C Bᵀ ∘ L)(x·dt) + (C h) ∘ exp(cs),   L[t,s] = exp(cs_t - cs_s), s <= t
//   h ← h·exp(cs[-1]) + Bᵀ((x·dt) ∘ exp(cs[-1] - cs))
//
// Design. The TPU kernel walks the chunks as a sequential grid axis and
// carries h in VMEM. GPU blocks run in no order, so one block takes one row
// and loops over its nc chunks, and h (ds x hd f32, 32 KiB at full width)
// stays in shared memory from the first chunk to the last. Per chunk the
// block stages x·dt (Q x hd) and B (Q x ds, rows padded by one float so
// that threads reading different rows hit different banks) in shared
// memory. C Bᵀ ∘ L (Q x Q, 64 KiB at Q = 128) does not fit beside them: it
// is computed kTileRows rows of t at a time, from a tile of C of as many
// rows, and each tile of y is finished before the next tile starts. At
// full width (Q = 128, hd = 64, ds = 128) that is 166,400 bytes of dynamic
// shared memory, above the 48 KiB default, so the launch raises the limit
// with cudaFuncSetAttribute. Mamba-2 here has one SSM group: B and C are
// the same for every head of a batch row, and the rows of one group read
// the same B and C (heads_per_group rows per group, no copies).
//
// Every product is an fp32 FMA on the CUDA cores (no tensor cores, no
// TF32, no fast-math exp). A thread carries kMicro rows of an output in
// registers, so each value it reads of the other operand serves kMicro
// FMAs. The chunk's cumsum is taken serially by one thread, in the order
// torch.cumsum takes it on the CPU; the dot products are serial FMA chains.
// The plain version's matrix products sum in another order, so the two
// agree to a tolerance (stated where they are compared), not bit for bit.
//
// Bound on an H100: operations. The causal half of C Bᵀ (once per group
// and chunk), the causal half of its product with x·dt, C h and the state
// update (per row and chunk) come to 43.6 GFLOP at the prefill shapes
// (BH = 256 rows in 8 groups, nc = 32, Q = 128, hd = 64, ds = 128): 0.65 ms
// at 67 TFLOP/s (fp32 outside the tensor cores), against 0.17 ms for the
// 0.58 GB the call must move at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 32;  // rows t of C Bᵀ ∘ L held at a time
constexpr int kMicro = 4;      // output rows a thread carries in registers

size_t smem_bytes(int Q, int hd, int ds) {
  const size_t floats = (size_t)ds * hd        // h
                      + (size_t)Q * hd         // x·dt
                      + (size_t)Q * (ds + 1)   // B, padded rows
                      + (size_t)kTileRows * ds // tile of C
                      + (size_t)kTileRows * Q  // tile of C Bᵀ ∘ L
                      + 4 * (size_t)Q          // dt, cs, exp(cs), exp(cs[-1]-cs)
                      + kMicro;                // slack: rows past the edge
  return floats * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, int nc, int Q, int hd, int ds,
                int heads_per_group, float* __restrict__ y,
                float* __restrict__ hout) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int g = bh / heads_per_group;
  const int tid = threadIdx.x;
  const int Bp = ds + 1;
  float* h = smem;
  float* xdt = h + ds * hd;
  float* Bs = xdt + Q * hd;
  float* Ct = Bs + Q * Bp;
  float* S = Ct + kTileRows * ds;
  float* dts = S + kTileRows * Q;
  float* cs = dts + Q;
  float* ecs = cs + Q;
  float* dout = ecs + Q;
  const float a = A[bh];

  for (int e = tid; e < ds * hd; e += kThreads) h[e] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int64_t row = (int64_t)bh * nc + c;   // chunk of x, dt, y
    const int64_t grow = (int64_t)g * nc + c;   // chunk of B, C
    const float* xc = x + row * Q * hd;
    const float* Bc = Bm + grow * Q * ds;
    const float* Cc = Cm + grow * Q * ds;
    float* yc = y + row * Q * hd;

    __syncthreads();  // the previous chunk is done with xdt, Bs, dts, h
    for (int q = tid; q < Q; q += kThreads) dts[q] = dt[row * Q + q];
    for (int e = tid; e < Q * ds; e += kThreads)
      Bs[(e / ds) * Bp + e % ds] = Bc[e];
    for (int e = tid; e < Q * hd; e += kThreads) xdt[e] = xc[e];
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int q = 0; q < Q; ++q) {
        run = __fadd_rn(run, __fmul_rn(dts[q], a));
        cs[q] = run;
      }
    }
    for (int e = tid; e < Q * hd; e += kThreads)
      xdt[e] = __fmul_rn(xdt[e], dts[e / hd]);
    __syncthreads();
    const float last = cs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) {
      ecs[q] = expf(cs[q]);
      dout[q] = expf(last - cs[q]);
    }
    const float seg = expf(last);
    __syncthreads();

    for (int t0 = 0; t0 < Q; t0 += kTileRows) {
      const int nt = min(kTileRows, Q - t0);
      const int groups = (nt + kMicro - 1) / kMicro;
      for (int e = tid; e < nt * ds; e += kThreads)
        Ct[e] = Cc[(int64_t)t0 * ds + e];
      __syncthreads();

      // S[i][s] = (C_t · B_s) * exp(cs_t - cs_s) for s <= t, else 0
      for (int e = tid; e < groups * Q; e += kThreads) {
        const int i0 = (e / Q) * kMicro;
        const int s = e % Q;
        float acc[kMicro];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) acc[r] = 0.0f;
        if (s <= t0 + min(i0 + kMicro, nt) - 1) {
          const float* bs = Bs + s * Bp;
          const float* ct = Ct + i0 * ds;
          for (int k = 0; k < ds; ++k) {
            const float b = bs[k];
#pragma unroll
            for (int r = 0; r < kMicro; ++r)
              acc[r] = fmaf(ct[r * ds + k], b, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const int i = i0 + r;
          if (i < nt) {
            const int t = t0 + i;
            S[i * Q + s] =
                s <= t ? __fmul_rn(acc[r], expf(cs[t] - cs[s])) : 0.0f;
          }
        }
      }
      __syncthreads();

      // y[t][d] = sum_{s<=t} S[i][s] xdt[s][d] + exp(cs_t) sum_n C[t][n] h[n][d]
      for (int e = tid; e < groups * hd; e += kThreads) {
        const int i0 = (e / hd) * kMicro;
        const int d = e % hd;
        const int s_end = t0 + min(i0 + kMicro, nt);
        float ai[kMicro], ah[kMicro];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) ai[r] = ah[r] = 0.0f;
        const float* srow = S + i0 * Q;
        for (int s = 0; s < s_end; ++s) {
          const float xv = xdt[s * hd + d];
#pragma unroll
          for (int r = 0; r < kMicro; ++r)
            ai[r] = fmaf(srow[r * Q + s], xv, ai[r]);
        }
        const float* ct = Ct + i0 * ds;
        for (int n = 0; n < ds; ++n) {
          const float hv = h[n * hd + d];
#pragma unroll
          for (int r = 0; r < kMicro; ++r)
            ah[r] = fmaf(ct[r * ds + n], hv, ah[r]);
        }
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const int i = i0 + r;
          if (i < nt) {
            const int t = t0 + i;
            yc[(int64_t)t * hd + d] = __fadd_rn(ai[r], __fmul_rn(ah[r], ecs[t]));
          }
        }
      }
      __syncthreads();  // Ct and S are refilled by the next tile
    }

    // h ← h·exp(cs[-1]) + Bᵀ (x·dt ∘ exp(cs[-1] - cs))
    for (int e = tid; e < Q * hd; e += kThreads)
      xdt[e] = __fmul_rn(xdt[e], dout[e / hd]);
    __syncthreads();
    const int hgroups = (ds + kMicro - 1) / kMicro;
    for (int e = tid; e < hgroups * hd; e += kThreads) {
      const int n0 = (e / hd) * kMicro;
      const int d = e % hd;
      float acc[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) acc[r] = 0.0f;
      for (int q = 0; q < Q; ++q) {
        const float xv = xdt[q * hd + d];
        const float* bq = Bs + q * Bp + n0;
#pragma unroll
        for (int r = 0; r < kMicro; ++r) acc[r] = fmaf(bq[r], xv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const int n = n0 + r;
        if (n < ds) {
          float* hp = h + n * hd + d;
          *hp = __fadd_rn(__fmul_rn(*hp, seg), acc[r]);
        }
      }
    }
  }
  __syncthreads();
  float* ho = hout + (int64_t)bh * ds * hd;
  for (int e = tid; e < ds * hd; e += kThreads) ho[e] = h[e];
}

}  // namespace

// Plain C entry point, loaded with ctypes. x (BH, nc, Q, hd), dt (BH, nc, Q),
// A (BH,), B and C (BH / heads_per_group, nc, Q, ds), all f32 and
// contiguous; row bh reads B and C of group bh / heads_per_group. Writes
// y (BH, nc, Q, hd) and the final state h (BH, ds, hd). Launches on
// ``stream`` and returns the first CUDA error (0 on success);
// cudaErrorInvalidValue when the shapes need more shared memory than a
// block may have. Allocates nothing.
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* Bm,
                               const float* Cm, int BH, int nc, int Q,
                               int hd, int ds, int heads_per_group, float* y,
                               float* hout, void* stream) {
  if (BH == 0) return 0;
  const size_t bytes = smem_bytes(Q, hd, ds);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<BH, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, nc, Q, hd, ds, heads_per_group, y, hout);
  return (int)cudaGetLastError();
}

extern "C" size_t ssd_scan_smem_bytes(int Q, int hd, int ds) {
  return smem_bytes(Q, hd, ds);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
