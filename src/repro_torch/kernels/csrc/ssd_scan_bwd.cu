// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), fp32 on
// the CUDA cores.
//
// No TPU kernel corresponds: the JAX package differentiates its jnp
// ssd_chunked (src/repro/models/mamba2.py:71) and never calls its Pallas
// scan in training. This kernel is the gradient of csrc/ssd_scan.cu, and
// computes what autograd through repro_torch.kernels.ssd_scan.
// ssd_scan_plain gives. Per (batch * head) row, with the forward
//   y = (C Bᵀ ∘ L)(x·dt) + (C h) ∘ exp(cs),  L[t,s] = exp(cs_t - cs_s), s <= t
//   h ← h·exp(cs[-1]) + Bᵀ((x·dt) ∘ exp(cs[-1] - cs)),  cs = cumsum(dt·A)
// and dy (dh of the final state: given, or 0), it takes the chunks in
// reverse with dh the gradient of the state leaving the chunk:
//   d(x·dt) = (C Bᵀ ∘ L)ᵀ dy + exp(cs[-1] - cs) ∘ (B dh)
//   dC = (dM ∘ L) B + exp(cs) ∘ (dy h_inᵀ),   dM = dy (x·dt)ᵀ (causal)
//   dB = (dM ∘ L)ᵀ C + exp(cs[-1] - cs) ∘ ((x·dt) dhᵀ)
//   d cs from L, exp(cs) (exp(cs_t) times the row sum of C ∘ (dy h_inᵀ),
//   from dC's own product: C h_in is never formed) and exp(cs[-1] - cs),
//   then a reverse cumsum into d(dt·A), which gives ddt (with
//   x · d(x·dt)) and dA
//   dh_in = exp(cs[-1]) dh + Cᵀ(exp(cs) ∘ dy)
// The states entering the chunks are recomputed first by a forward pass
// over the chunks (with the forward kernel's arithmetic) into a scratch
// tensor. dB and dC are written per row; the wrapper sums a group's rows.
//
// Bound on an H100: operations. At the training shapes of mamba2_370m
// (BH = 256 rows in 8 groups, nc = 32, Q = 128, hd = 64, ds = 128) the
// products come to 138.4 GFLOP of fp32 FMAs (the causal halves of dM,
// (dM ∘ L) B, (dM ∘ L)ᵀ C and (C Bᵀ ∘ L)ᵀ dy and of C Bᵀ once per group;
// B dh, dy h_inᵀ, (x·dt) dhᵀ, Cᵀ(exp(cs) ∘ dy) and the state
// recomputation, Q·ds·hd each), 2.07 ms at 67 TFLOP/s, against 0.88 GB
// of inputs read once and outputs written once (x, dy, dx; dt, ddt; A,
// dA; B, C, dB, dC a group: 0.26 ms at 3.35 TB/s).
// chip_smoke's ssd_bwd_bound_ms works it out from the shapes.
//
// Design: a simple kernel that is right. A pre-pass, one block per group
// and chunk, writes C Bᵀ of the chunk in both layouts, [t][s] and [s][t]
// (zero above the diagonal), so that the scan's reads of rows and of
// columns are both coalesced. The scan, one block of 512 threads per row
// (one block an SM at the training shapes: 187,904 bytes of shared
// memory), keeps in shared memory (padded strides against bank
// conflicts) dh, h_in, x·dt, one Q x Q matrix (dM, then dM ∘ L; then a
// Q x hd one reused for B dh and d(x·dt)), the chunk's vectors and the
// dC pass's partial row sums of C ∘ (dy h_inᵀ); B, C, dy and x are read from device memory (B and C of a
// group from L2). Every product is a pass of 4 x 4 register micro-tiles
// (a thread loads 4 + 4 operands a step of k for 16 FMAs; the first
// design, one output a thread, took 47.6 ms a call at these shapes on an
// H100 80GB HBM3 at 700 W), each output one fmaf
// chain over k in order; sums over a row go through a fixed warp
// butterfly; one thread takes the serial cumsums. No atomics: two calls
// on the same inputs give the same bits. Tensor cores, TMA and cp.async
// staging are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;  // output rows of a thread's micro-tile
constexpr int kC = 4;  // output columns of a thread's micro-tile

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The scan block's shared memory, in floats: dh and h_in (ds x (hd + 1)),
// x·dt (Q x (hd + 1)), the matrix S (Q x (Q + 1), or Q x (hd + 1) if
// larger), the chunk's vectors, the block's partial sums and the dC
// pass's partial row sums (one a row and column tile).
struct BwdSmem {
  int hs, qs;  // row strides: hd + 1, Q + 1
  int tc;      // column tiles of a Q x ds output
  int dh, hin, xdt, S, dts, cs, ecs, dout, dcs, gd, dtx, red, rp, total;
  __host__ __device__ BwdSmem(int Q, int hd, int ds) {
    hs = hd + 1;
    qs = Q + 1;
    dh = 0;
    hin = dh + ds * hs;
    xdt = hin + ds * hs;
    S = xdt + Q * hs;
    const int s_size = Q * qs > Q * hs ? Q * qs : Q * hs;
    dts = S + s_size;
    cs = dts + Q;
    ecs = cs + Q;
    dout = ecs + Q;
    dcs = dout + Q;
    gd = dcs + Q;
    dtx = gd + Q;
    red = dtx + Q;
    rp = red + kThreads;
    tc = cdiv(ds, kC);
    total = rp + cdiv(Q, kR) * kR * tc;
  }
};

size_t bwd_smem_bytes(int Q, int hd, int ds) {
  return sizeof(float) * (size_t)BwdSmem(Q, hd, ds).total;
}

size_t cb_smem_bytes(int Q, int ds) {
  return sizeof(float) * 2 * (size_t)Q * (ds + 1);
}

// The sum of v over the warp's 32 lanes, in the same order in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C Bᵀ of one chunk of one group, one block per (group, chunk):
// cb[t][s] = sum_n C[t][n] B[s][n] for s <= t (0 above the diagonal), one
// fmaf chain in increasing n as the forward's pre-pass takes it, written
// as cb_ts[t][s] and cb_st[s][t].
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  int Q, int ds, float* __restrict__ cb_ts,
                  float* __restrict__ cb_st) {
  extern __shared__ __align__(16) float smem[];
  const int ls = ds + 1;
  float* c_s = smem;
  float* b_s = smem + Q * ls;
  const int64_t gc = blockIdx.x;
  const float* Bc = Bm + gc * Q * ds;
  const float* Cc = Cm + gc * Q * ds;
  for (int e = threadIdx.x; e < Q * ds; e += kThreads) {
    const int r = e / ds, n = e % ds;
    c_s[r * ls + n] = Cc[e];
    b_s[r * ls + n] = Bc[e];
  }
  __syncthreads();
  float* ts = cb_ts + gc * Q * Q;
  float* st = cb_st + gc * Q * Q;
  for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
    const int t = e / Q, s = e % Q;
    float acc = 0.0f;
    if (s <= t)
      for (int n = 0; n < ds; ++n)
        acc = fmaf(c_s[t * ls + n], b_s[s * ls + n], acc);
    ts[e] = acc;
    st[(int64_t)s * Q + t] = acc;
  }
}

// A thread's kR x kC micro-tile of an output: acc[i][j] += A(i, k) B(k, j)
// for k = k0 .. k1 - 1 in order, one fmaf chain per output. A step of k
// loads kR values of A and kC of B for kR * kC FMAs.
template <typename FA, typename FB>
__device__ __forceinline__ void tile_mac(int k0, int k1, FA&& A, FB&& B,
                                         float (&acc)[kR][kC]) {
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    float av[kR], bv[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = A(i, k);
#pragma unroll
    for (int j = 0; j < kC; ++j) bv[j] = B(k, j);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The micro-tiles of a rows x cols output, the column tile fastest (so a
// warp's lanes take neighbouring columns), spread over the block: calls
// f(r0, c0, r[kR], c[kC]) for each of this thread's tiles, with r and c
// the tile's row and column indices clamped into the output (for loads;
// an output is stored only where r0 + i < rows and c0 + j < cols).
template <typename F>
__device__ __forceinline__ void for_tiles(int rows, int cols, F&& f) {
  const int tc = cdiv(cols, kC);
  const int n = cdiv(rows, kR) * tc;
  for (int m = threadIdx.x; m < n; m += kThreads) {
    const int r0 = (m / tc) * kR, c0 = (m % tc) * kC;
    int r[kR], c[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) r[i] = min(r0 + i, rows - 1);
#pragma unroll
    for (int j = 0; j < kC; ++j) c[j] = min(c0 + j, cols - 1);
    f(r0, c0, r, c);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
}

// The scan's backward, one block per row; see the note at the top.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dy,
               const float* __restrict__ dh_final,
               const float* __restrict__ cb_ts,
               const float* __restrict__ cb_st, float* __restrict__ hs,
               int nc, int Q, int hd, int ds, int heads_per_group,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA, float* __restrict__ dB,
               float* __restrict__ dC) {
  extern __shared__ __align__(16) float smem[];
  const BwdSmem L(Q, hd, ds);
  float* dh = smem + L.dh;
  float* hin = smem + L.hin;
  float* xdt = smem + L.xdt;
  float* S = smem + L.S;
  float* dts = smem + L.dts;
  float* cs = smem + L.cs;
  float* ecs = smem + L.ecs;
  float* dout = smem + L.dout;
  float* dcs = smem + L.dcs;
  float* gd = smem + L.gd;
  float* dtx = smem + L.dtx;
  float* red = smem + L.red;
  float* rp = smem + L.rp;
  const int HS = L.hs, QS = L.qs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int g = bh / heads_per_group;
  const float a = A[bh];
  const int64_t QHD = (int64_t)Q * hd;

  // dt, cs = cumsum(dt·A) (serially, in the forward's order), x·dt,
  // exp(cs) and exp(cs[-1] - cs) of chunk c; ends with a barrier.
  auto prologue = [&](int c) {
    const int64_t row = (int64_t)bh * nc + c;
    const float* xc = x + row * QHD;
    for (int q = tid; q < Q; q += kThreads) dts[q] = dt[row * Q + q];
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int q = 0; q < Q; ++q) {
        run = __fadd_rn(run, __fmul_rn(dts[q], a));
        cs[q] = run;
      }
    }
    for (int e = tid; e < Q * hd; e += kThreads)
      xdt[(e / hd) * HS + e % hd] = __fmul_rn(xc[e], dts[e / hd]);
    __syncthreads();
    const float last = cs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) {
      ecs[q] = expf(cs[q]);
      dout[q] = expf(last - cs[q]);
    }
    __syncthreads();
  };

  // the states entering the chunks, into hs (dh holds the running state):
  // h ← h·exp(cs[-1]) + Bᵀ((x·dt) ∘ exp(cs[-1] - cs)), the forward's
  // arithmetic
  for (int e = tid; e < ds * hd; e += kThreads) dh[(e / hd) * HS + e % hd] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    prologue(c);
    for (int e = tid; e < Q * hd; e += kThreads) {
      float* p = xdt + (e / hd) * HS + e % hd;
      *p = __fmul_rn(*p, dout[e / hd]);
    }
    __syncthreads();
    const float* Bc = Bm + ((int64_t)g * nc + c) * Q * ds;
    const float seg = expf(cs[Q - 1]);
    float* hc = hs + ((int64_t)bh * nc + c) * ds * hd;
    for_tiles(ds, hd, [&](int r0, int c0, const int (&n)[kR],
                          const int (&d)[kC]) {
      float acc[kR][kC];
      zero(acc);
      tile_mac(0, Q, [&](int i, int s) { return Bc[(int64_t)s * ds + n[i]]; },
               [&](int s, int j) { return xdt[s * HS + d[j]]; }, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < ds && c0 + j < hd) {
            float* p = dh + n[i] * HS + d[j];
            const float v = *p;
            hc[n[i] * hd + d[j]] = v;
            *p = __fadd_rn(__fmul_rn(v, seg), acc[i][j]);
          }
    });
    __syncthreads();
  }

  // the chunks in reverse, dh the gradient of the state leaving chunk c
  for (int e = tid; e < ds * hd; e += kThreads)
    dh[(e / hd) * HS + e % hd] =
        dh_final ? dh_final[(int64_t)bh * ds * hd + e] : 0.0f;
  float dA_acc = 0.0f;  // thread 0's
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t row = (int64_t)bh * nc + c;
    const int64_t grow = (int64_t)g * nc + c;
    const float* xc = x + row * QHD;
    const float* dyc = dy + row * QHD;
    const float* Bc = Bm + grow * Q * ds;
    const float* Cc = Cm + grow * Q * ds;
    const float* cts = cb_ts + grow * Q * Q;
    const float* cst = cb_st + grow * Q * Q;
    const float* hc = hs + row * ds * hd;
    for (int e = tid; e < ds * hd; e += kThreads)
      hin[(e / hd) * HS + e % hd] = hc[e];
    prologue(c);
    const float seg = expf(cs[Q - 1]);

    // S = dM: dM[t][s] = dy_t · (x·dt)_s for s <= t (0 above)
    for_tiles(Q, Q, [&](int r0, int c0, const int (&t)[kR],
                        const int (&sv)[kC]) {
      float acc[kR][kC];
      zero(acc);
      if (c0 <= r0 + kR - 1)
        tile_mac(0, hd, [&](int i, int d) { return dyc[(int64_t)t[i] * hd + d]; },
                 [&](int d, int j) { return xdt[sv[j] * HS + d]; }, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < Q && c0 + j < Q)
            S[(r0 + i) * QS + c0 + j] = c0 + j <= r0 + i ? acc[i][j] : 0.0f;
    });
    __syncthreads();
    // through L: P = dM ∘ C Bᵀ ∘ L adds to d cs_t along its row and
    // takes from d cs_s along its column
    for (int t = warp; t < Q; t += kWarps) {
      float row_sum = 0.0f, col_sum = 0.0f;
      for (int s = lane; s <= t; s += 32)
        row_sum += S[t * QS + s] * cts[(int64_t)t * Q + s] *
                   expf(cs[t] - cs[s]);
      for (int u = t + lane; u < Q; u += 32)
        col_sum += S[u * QS + t] * cst[(int64_t)t * Q + u] *
                   expf(cs[u] - cs[t]);
      row_sum = warp_sum(row_sum);
      col_sum = warp_sum(col_sum);
      if (lane == 0) dcs[t] = row_sum - col_sum;
    }
    __syncthreads();
    // S = dM ∘ L, the gradient of C Bᵀ
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int t = e / Q, s = e % Q;
      if (s <= t) S[t * QS + s] *= expf(cs[t] - cs[s]);
    }
    __syncthreads();
    // dC = (dM ∘ L) B + exp(cs) ∘ (dy h_inᵀ), per row; rp takes each
    // tile's row sums of C ∘ (dy h_inᵀ), the exp(cs) term of d cs
    float* dCc = dC + row * Q * ds;
    for_tiles(Q, ds, [&](int r0, int c0, const int (&t)[kR],
                         const int (&n)[kC]) {
      float acc[kR][kC], acc2[kR][kC];
      zero(acc);
      zero(acc2);
      tile_mac(0, min(Q, r0 + kR),
               [&](int i, int s) { return S[t[i] * QS + s]; },
               [&](int s, int j) { return Bc[(int64_t)s * ds + n[j]]; }, acc);
      tile_mac(0, hd, [&](int i, int d) { return dyc[(int64_t)t[i] * hd + d]; },
               [&](int d, int j) { return hin[n[j] * HS + d]; }, acc2);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < Q && c0 + j < ds) {
            dCc[(int64_t)t[i] * ds + n[j]] = acc[i][j] + ecs[t[i]] * acc2[i][j];
            part = fmaf(Cc[(int64_t)t[i] * ds + n[j]], acc2[i][j], part);
          }
        rp[(r0 + i) * L.tc + c0 / kC] = part;
      }
    });
    // dB = (dM ∘ L)ᵀ C + exp(cs[-1] - cs) ∘ ((x·dt) dhᵀ), per row
    float* dBc = dB + row * Q * ds;
    for_tiles(Q, ds, [&](int r0, int c0, const int (&sv)[kR],
                         const int (&n)[kC]) {
      float acc[kR][kC], acc2[kR][kC];
      zero(acc);
      zero(acc2);
      tile_mac(r0, Q, [&](int i, int t) { return S[t * QS + sv[i]]; },
               [&](int t, int j) { return Cc[(int64_t)t * ds + n[j]]; }, acc);
      tile_mac(0, hd, [&](int i, int d) { return xdt[sv[i] * HS + d]; },
               [&](int d, int j) { return dh[n[j] * HS + d]; }, acc2);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < Q && c0 + j < ds)
            dBc[(int64_t)sv[i] * ds + n[j]] =
                acc[i][j] + dout[sv[i]] * acc2[i][j];
    });
    __syncthreads();
    // S = du = B dh
    for_tiles(Q, hd, [&](int r0, int c0, const int (&sv)[kR],
                         const int (&d)[kC]) {
      float acc[kR][kC];
      zero(acc);
      tile_mac(0, ds, [&](int i, int n) { return Bc[(int64_t)sv[i] * ds + n]; },
               [&](int n, int j) { return dh[n * HS + d[j]]; }, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < Q && c0 + j < hd) S[sv[i] * HS + d[j]] = acc[i][j];
    });
    __syncthreads();
    // through exp(cs[-1] - cs): gd = dout ∘ (du · x·dt) adds to d cs[-1]
    // and takes from d cs_s
    for (int s = warp; s < Q; s += kWarps) {
      float v = 0.0f;
      for (int d = lane; d < hd; d += 32) v += S[s * HS + d] * xdt[s * HS + d];
      v = warp_sum(v);
      if (lane == 0) {
        gd[s] = dout[s] * v;
        dcs[s] -= gd[s];
      }
    }
    __syncthreads();
    // S = d(x·dt) = (C Bᵀ ∘ L)ᵀ dy + dout ∘ du; dx = dt ∘ d(x·dt)
    float* dxc = dx + row * QHD;
    for_tiles(Q, hd, [&](int r0, int c0, const int (&sv)[kR],
                         const int (&d)[kC]) {
      float acc[kR][kC];
      zero(acc);
      tile_mac(r0, Q,
               [&](int i, int t) {
                 return t >= sv[i] ? cst[(int64_t)sv[i] * Q + t] *
                                         expf(cs[t] - cs[sv[i]])
                                   : 0.0f;
               },
               [&](int t, int j) { return dyc[(int64_t)t * hd + d[j]]; }, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < Q && c0 + j < hd) {
            float* p = S + sv[i] * HS + d[j];
            const float v = acc[i][j] + dout[sv[i]] * *p;
            *p = v;
            dxc[(int64_t)sv[i] * hd + d[j]] = dts[sv[i]] * v;
          }
    });
    __syncthreads();
    // dtx = x · d(x·dt), row by row
    for (int s = warp; s < Q; s += kWarps) {
      float v = 0.0f;
      for (int d = lane; d < hd; d += 32)
        v += xc[(int64_t)s * hd + d] * S[s * HS + d];
      v = warp_sum(v);
      if (lane == 0) dtx[s] = v;
    }
    __syncthreads();
    // the block's partial sums of dh ∘ h_in; through exp(cs):
    // d cs_t += exp(cs_t) (dy_t · (C h_in)_t), which is exp(cs_t) times
    // the row sum of C ∘ (dy h_inᵀ), summed from rp in tile order
    {
      float v = 0.0f;
      for (int e = tid; e < ds * hd; e += kThreads) {
        const int i = (e / hd) * HS + e % hd;
        v = fmaf(dh[i], hin[i], v);
      }
      red[tid] = v;
    }
    for (int t = tid; t < Q; t += kThreads) {
      float v = 0.0f;
      for (int k = 0; k < L.tc; ++k) v += rp[t * L.tc + k];
      dcs[t] += ecs[t] * v;
    }
    __syncthreads();
    // through exp(cs[-1]) and the gd terms: d cs[-1]; then the reverse
    // cumsum into d(dt·A), ddt and dA
    if (tid == 0) {
      float dseg = 0.0f;
      for (int i = 0; i < kThreads; ++i) dseg += red[i];
      float tot = 0.0f;
      for (int s = 0; s < Q; ++s) tot += gd[s];
      dcs[Q - 1] += tot + seg * dseg;
      // dA summed a chunk at a time, then over the chunks: a serial sum
      // of all nc * Q terms loses more to rounding
      float run = 0.0f, part = 0.0f;
      float* ddtc = ddt + row * Q;
      for (int q = Q - 1; q >= 0; --q) {
        run += dcs[q];
        ddtc[q] = dtx[q] + a * run;
        part += dts[q] * run;
      }
      dA_acc += part;
    }
    // dh_in = exp(cs[-1]) dh + Cᵀ (exp(cs) ∘ dy)
    for_tiles(ds, hd, [&](int r0, int c0, const int (&n)[kR],
                          const int (&d)[kC]) {
      float acc[kR][kC];
      zero(acc);
      tile_mac(0, Q,
               [&](int i, int t) { return Cc[(int64_t)t * ds + n[i]] * ecs[t]; },
               [&](int t, int j) { return dyc[(int64_t)t * hd + d[j]]; }, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          if (r0 + i < ds && c0 + j < hd) {
            float* p = dh + n[i] * HS + d[j];
            *p = seg * *p + acc[i][j];
          }
    });
    __syncthreads();
  }
  if (tid == 0) dA[bh] = dA_acc;
}

// Raise both kernels' dynamic shared-memory limits to what the shapes
// need; cudaErrorInvalidValue when a block may not have that much.
int prepare(int Q, int hd, int ds, size_t* bwd_bytes, size_t* cb_bytes) {
  *bwd_bytes = bwd_smem_bytes(Q, hd, ds);
  *cb_bytes = cb_smem_bytes(Q, ds);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (*bwd_bytes > (size_t)optin || *cb_bytes > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*bwd_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(ssd_bwd_cb_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*cb_bytes);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and dy (BH, nc, Q, hd), dt (BH,
// nc, Q), A (BH,), B and C (BH / heads_per_group, nc, Q, ds), dh_final (BH,
// ds, hd) or null (a zero gradient of the final state), all f32 and
// contiguous. Scratch: cb_ts and cb_st (BH / heads_per_group, nc, Q, Q),
// hs (BH, nc, ds, hd). Writes dx (BH, nc, Q, hd), ddt (BH, nc, Q), dA
// (BH,), and dB and dC per row (BH, nc, Q, ds). Launches the pre-pass and
// the backward on ``stream``; returns the first CUDA error (0 on
// success), cudaErrorInvalidValue when the shapes need more shared memory
// than a block may have. Allocates nothing.
extern "C" int ssd_scan_bwd_launch(const float* x, const float* dt,
                                   const float* A, const float* Bm,
                                   const float* Cm, const float* dy,
                                   const float* dh_final, float* cb_ts,
                                   float* cb_st, float* hs, int BH, int nc,
                                   int Q, int hd, int ds, int heads_per_group,
                                   float* dx, float* ddt, float* dA, float* dB,
                                   float* dC, void* stream) {
  if (BH == 0) return 0;
  size_t bwd_bytes = 0, cb_bytes = 0;
  const int err = prepare(Q, hd, ds, &bwd_bytes, &cb_bytes);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = BH / heads_per_group;
  if (nc > 0) {
    ssd_bwd_cb_kernel<<<groups * nc, kThreads, cb_bytes, s>>>(Bm, Cm, Q, ds,
                                                              cb_ts, cb_st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_bwd_kernel<<<BH, kThreads, bwd_bytes, s>>>(
      x, dt, A, Bm, Cm, dy, dh_final, cb_ts, cb_st, hs, nc, Q, hd, ds,
      heads_per_group, dx, ddt, dA, dB, dC);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a backward block takes at these shapes.
extern "C" size_t ssd_scan_bwd_smem_bytes(int Q, int hd, int ds) {
  return bwd_smem_bytes(Q, hd, ds);
}

// Blocks of the backward and of its pre-pass that one SM holds at once at
// these shapes, as the occupancy calculator gives them; returns a CUDA
// error.
extern "C" int ssd_scan_bwd_blocks_per_sm(int Q, int hd, int ds, int* bwd,
                                          int* pre) {
  size_t bwd_bytes = 0, cb_bytes = 0;
  int err = prepare(Q, hd, ds, &bwd_bytes, &cb_bytes);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      bwd, ssd_bwd_kernel, kThreads, bwd_bytes);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      pre, ssd_bwd_cb_kernel, kThreads, cb_bytes);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
