// The Mamba-2 SSD chunk scan for Hopper (sm_90a), in fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas.
// It computes the same function as repro_torch.kernels.ssd_scan.
// ssd_scan_plain. For each (batch * head) row and each chunk of Q steps,
// with cs = cumsum(dt * A) over the chunk and h the state entering it:
//   y = (C Bᵀ ∘ L)(x·dt) + (C h) ∘ exp(cs),   L[t,s] = exp(cs_t - cs_s), s <= t
//   h ← h·exp(cs[-1]) + Bᵀ((x·dt) ∘ exp(cs[-1] - cs))
// Row bh reads B and C of group bh / heads_per_group. Mamba-2 here has one
// SSM group per batch row, so the 32 heads of a batch row share B and C.
//
// Bound on an H100: operations. The causal half of C Bᵀ once per group and
// chunk, and per row and chunk the causal half of its product with x·dt,
// C h and the state update, come to 43.6 GFLOP at the prefill shapes
// (BH = 256 rows in 8 groups, nc = 32, Q = 128, hd = 64, ds = 128): 0.65 ms
// at 67 TFLOP/s (fp32 outside the tensor cores), against 0.17 ms for the
// 0.58 GB the call must move at 3.35 TB/s.
//
// Design: two kernels a call. The previous design (one kernel, 512
// threads, 4 x 1 micro-tiles) ran at 11.6x this bound for three causes;
// what each part does about them:
// 1. Redundant work. ssd_scan_cb_kernel, one block per group and chunk,
//    writes C Bᵀ of the chunk (its causal lower triangle, t >= s; (G, nc,
//    Q, Q) laid out [s][t]) and Cᵀ ((G, nc, ds, Q)) into scratch tensors
//    that the wrapper allocates (16.8 MB each at the prefill shapes, read
//    back from L2 by the group's rows). Before, each of a group's 32 rows
//    computed C Bᵀ again: 17 of the 60 GFLOP that kernel did.
// 2. Shared-memory instructions. ssd_scan_kernel, one block of 256 threads
//    per row, loops over the row's chunks with h (ds x hd) and x·dt
//    (Q x hd) resident in shared memory. The three products of a chunk,
//    C h and (C Bᵀ ∘ L)(x·dt) into y, then Bᵀ(x·dt ∘ exp(cs[-1] - cs))
//    into h, are outer-product micro-kernels: a thread owns 8 x 4 outputs
//    in registers and, at each k, reads 8 values of the row operand and 4
//    of the column operand as three 16-byte loads for 32 FMAs (before:
//    five scalar loads for four FMAs). The operands are staged k-major in
//    tiles of kTileK rows: Cᵀ and B row by row, and S = C Bᵀ ∘ L from the
//    scratch, each thread multiplying the entries it copied by
//    exp(cs_t - cs_s) once they have landed.
// 3. Occupancy. The tiles stream through a ring of two slots by cp.async
//    (16-byte copies where rows allow it), the next tile landing while the
//    current one is used, instead of holding B and a tile of C: 100,352
//    bytes of shared memory at full width (before 166,400), and
//    __launch_bounds__ caps the registers at 128 a thread, so two blocks
//    fit on an SM and the 256 rows of the prefill shapes run in one wave
//    on 132 SMs (before: one block an SM, two waves).
// The main path's shapes (Q 128, hd 64, ds 128) get an instantiation with
// them fixed at compile time, so that the index arithmetic folds into
// constants and the registers fit without spilling; other shapes take the
// generic one. Output tiles beyond 256 micro-tiles (ceil(Q/8) * ceil(hd/4)
// > 256, and the same for h) are covered in passes that stage the operands
// again.
//
// Arithmetic, as in the previous kernel (the two give the same bits):
// every product is an fp32 FMA on the CUDA cores (no tensor cores, no
// TF32, no fast-math exp). Each output is one serial fmaf chain in
// increasing k: C Bᵀ over n, C h over n, S (x·dt) over s up to the last
// row of the thread's micro-tile (S is 0 above the diagonal), the state
// update over q. Then y = ai + ah·exp(cs_t) and h ← h·exp(cs[-1]) + acc,
// each operation rounded by itself. One thread takes the chunk's cumsum
// serially, in the order torch.cumsum takes it on the CPU. The plain
// version's matrix products sum in another order, so the two agree to a
// tolerance (stated where they are compared), not bit for bit. Nothing is
// summed with atomics, so two calls on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;  // k rows of an operand tile
constexpr int kRows = 8;    // output rows of a thread's micro-tile
constexpr int kCols = 4;    // output columns of a thread's micro-tile

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }

// The scan kernel's shared memory, in floats: h at 0, then x·dt, the two
// tile slots, and the chunk's dt, cs, exp(cs) and exp(cs[-1] - cs). Every array starts on a 16-byte
// boundary and every row stride is a multiple of 4 floats (float4 loads).
struct ScanSmem {
  int hdp;    // row stride of h and x·dt: hd rounded up to kCols
  int width;  // row stride of a tile: max(Q, ds) rounded up to kRows
  int xdt, tiles, dts, cs, ecs, dout, total;
  __host__ __device__ ScanSmem(int Q, int hd, int ds) {
    const int Qp = round_up(Q, 4);
    hdp = round_up(hd, kCols);
    width = round_up(Q > ds ? Q : ds, kRows);
    xdt = ds * hdp;
    tiles = xdt + Q * hdp;
    dts = tiles + 2 * kTileK * width;
    cs = dts + Qp;
    ecs = cs + Qp;
    dout = ecs + Qp;
    total = dout + Qp;
  }
};

size_t scan_smem_bytes(int Q, int hd, int ds) {
  return sizeof(float) * (size_t)ScanSmem(Q, hd, ds).total;
}

size_t cb_smem_bytes(int Q) {
  return sizeof(float) * 2 * kTileK * (size_t)round_up(Q, kRows);
}

// Walks e = threadIdx.x, threadIdx.x + kThreads, ... over a row-major range
// of ``cols`` columns as (row r, column c), without a division a step.
struct Walk {
  int r, c, cols, dr, dc;
  __device__ explicit Walk(int cols_)
      : r(threadIdx.x / cols_), c(threadIdx.x % cols_), cols(cols_),
        dr(kThreads / cols_), dc(kThreads % cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// One float (cp_async) or four (cp_async4, both addresses on 16-byte
// boundaries) from device memory into shared memory, asynchronously
// (cp.async): the copy lands while the thread goes on, and is visible to
// the thread after cp_async_wait and to the block after a barrier that
// follows it.
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tile[k][j] = src[(k0 + k) * ld + j] for k < kn and j0 <= j < ld, as
// asynchronous copies: of 16 bytes when ``vec`` (ld and j0 multiples of 4,
// src on a 16-byte boundary), else of 4.
__device__ __forceinline__ void stage_rows(float* tile, int width,
                                           const float* __restrict__ src,
                                           int ld, int j0, int k0, int kn,
                                           bool vec) {
  if (vec) {
    for (Walk w((ld - j0) / 4); w.r < kn; w.next()) {
      const int j = j0 + 4 * w.c;
      cp_async4(tile + w.r * width + j, src + (int64_t)(k0 + w.r) * ld + j);
    }
  } else {
    for (Walk w(ld - j0); w.r < kn; w.next()) {
      const int j = j0 + w.c;
      cp_async(tile + w.r * width + j, src + (int64_t)(k0 + w.r) * ld + j);
    }
  }
}

// m[r][j] = m[r][j] * f[r] for r < rows, j < ld (a multiple of 4).
__device__ __forceinline__ void scale_rows(float* m, int rows, int ld,
                                           const float* f) {
  for (Walk w(ld / 4); w.r < rows; w.next()) {
    float4* p = reinterpret_cast<float4*>(m + w.r * ld + 4 * w.c);
    const float g = f[w.r];
    float4 v = *p;
    v.x = __fmul_rn(v.x, g);
    v.y = __fmul_rn(v.y, g);
    v.z = __fmul_rn(v.z, g);
    v.w = __fmul_rn(v.w, g);
    *p = v;
  }
}

// tile[k][j] = src[j * ld + k0 + k] for k < kn, j < rows: columns k0.. of a
// row-major matrix, k-major. A thread copies a run of 8 consecutive k of
// one row (one 32-byte sector); a warp's threads take consecutive j, so
// their stores fall in distinct banks.
__device__ __forceinline__ void stage_transposed(
    float* tile, int width, const float* __restrict__ src, int rows, int ld,
    int k0, int kn) {
  const int runs = cdiv(kn, 8) * rows;
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int j = r % rows;
    const int kb = (r / rows) * 8;
    const float* s = src + (int64_t)j * ld + k0 + kb;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (kb + i < kn) tile[(kb + i) * width + j] = s[i];
  }
}

// acc[r][c] = fmaf(a[k * lda + r], b[k * ldb + c], acc[r][c]) for k = 0 ..
// kn - 1 in order: one serial FMA chain per output. a and b lie on 16-byte
// boundaries and lda, ldb are multiples of 4, so a step of k is R/4 + C/4
// float4 loads from shared memory for R * C FMAs.
template <int R, int C>
__device__ __forceinline__ void micro_mma(const float* a, int lda,
                                          const float* b, int ldb, int kn,
                                          float (&acc)[R][C]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * lda + i);
      av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(b + k * ldb + i);
      bv[i] = v.x; bv[i + 1] = v.y; bv[i + 2] = v.z; bv[i + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
}

// C Bᵀ and Cᵀ of one chunk of one group, one block per (group, chunk):
// cb[s][t] = sum_n C[t][n] B[s][n] for s <= t, one serial fmaf chain in
// increasing n, and ct_out[n][t] = C[t][n], the layout the scan's C h
// tiles copy row by row. A thread owns an 8 x 8 block of (t, s); blocks that
// hold no s <= t are skipped, and entries above the diagonal are not
// written.
__global__ void __launch_bounds__(kThreads)
ssd_scan_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                   int Q, int ds, float* __restrict__ cb,
                   float* __restrict__ ct_out) {
  extern __shared__ __align__(16) float smem[];
  const int width = round_up(Q, kRows);
  float* ct = smem;                   // Cᵀ tile, [n][t]
  float* bt = smem + kTileK * width;  // Bᵀ tile, [n][s]
  const int64_t gc = blockIdx.x;
  const float* Bc = Bm + gc * Q * ds;
  const float* Cc = Cm + gc * Q * ds;
  float* out = cb + gc * Q * Q;
  float* ct_chunk = ct_out + gc * ds * Q;
  const int nb = cdiv(Q, kRows);
  const int blocks = nb * nb;
  for (int m0 = 0; m0 < blocks; m0 += kThreads) {
    const int m = m0 + threadIdx.x;
    const int tb = m % nb, sb = m / nb;  // a warp's stores run along t
    const bool live = m < blocks && sb <= tb;
    float acc[kRows][kRows];
    zero(acc);
    for (int n0 = 0; n0 < ds; n0 += kTileK) {
      const int kn = min(kTileK, ds - n0);
      __syncthreads();  // the previous tile has been read
      stage_transposed(ct, width, Cc, Q, ds, n0, kn);
      stage_transposed(bt, width, Bc, Q, ds, n0, kn);
      __syncthreads();
      if (m0 == 0)
        for (Walk w(Q); w.r < kn; w.next())
          ct_chunk[(int64_t)(n0 + w.r) * Q + w.c] = ct[w.r * width + w.c];
      if (live)
        micro_mma(ct + tb * kRows, width, bt + sb * kRows, width, kn, acc);
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kRows; ++c) {
          const int t = tb * kRows + r, s = sb * kRows + c;
          if (t < Q && s <= t) out[(int64_t)s * Q + t] = acc[r][c];
        }
    }
  }
}

// The scan, one block per row over its chunks. A chunk is a prologue (x·dt
// and the cumsum), then ``steps`` steps, each of which uses one staged
// operand tile while the next step's tile is staged into the other slot:
// per y pass, the ceil(ds/kTileK) tiles of Cᵀ (for C h) and the
// ceil(Q/kTileK) tiles of Sᵀ (for S (x·dt)), after which the pass's y is
// written; per h pass, the ceil(Q/kTileK) tiles of B, after which the
// pass's h is updated. A nonzero kQ, kHd or kDs fixes Q, hd or ds at
// compile time (the arguments then go unread), so that the index arithmetic
// folds into constants.
template <int kQ, int kHd, int kDs>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ ct, const float* __restrict__ cb,
                int nc, int Q_, int hd_, int ds_, int heads_per_group,
                float* __restrict__ y, float* __restrict__ hout) {
  extern __shared__ __align__(16) float smem[];
  const int Q = kQ ? kQ : Q_, hd = kHd ? kHd : hd_, ds = kDs ? kDs : ds_;
  const ScanSmem L(Q, hd, ds);
  const int hdp = L.hdp, width = L.width;
  const int bh = blockIdx.x;
  const int g = bh / heads_per_group;
  const int tid = threadIdx.x;
  float* h = smem;
  float* xdt = smem + L.xdt;
  float* dts = smem + L.dts;
  float* cs = smem + L.cs;
  float* ecs = smem + L.ecs;
  float* dout = smem + L.dout;
  const float a = A[bh];
  // 16-byte copies where every row of a source starts on a 16-byte boundary
  // (the scratch tensors are the wrapper's own allocations)
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_q = Q % 4 == 0 && aligned(ct) && aligned(cb);
  const bool vec_b = ds % 4 == 0 && aligned(Bm);
  const bool vec_x = hd % 4 == 0 && aligned(x);

  // h starts at 0, and the padding of every array holds finite values
  for (int e = tid; e < L.total; e += kThreads) smem[e] = 0.0f;

  const int n_ct = cdiv(ds, kTileK), n_st = cdiv(Q, kTileK);
  const int y_step = n_ct + n_st;  // steps of a y pass
  const int col_tiles = cdiv(hd, kCols);
  const int y_tiles = cdiv(Q, kRows) * col_tiles;
  const int h_tiles = cdiv(ds, kRows) * col_tiles;
  const int y_steps = cdiv(y_tiles, kThreads) * y_step;
  const int steps = y_steps + cdiv(h_tiles, kThreads) * n_st;

  for (int c = 0; c < nc; ++c) {
    const int64_t row = (int64_t)bh * nc + c;  // chunk of x, dt, y
    const int64_t grow = (int64_t)g * nc + c;  // chunk of B, C, C Bᵀ
    const float* xc = x + row * Q * hd;
    const float* dtc = dt + row * Q;
    const float* Bc = Bm + grow * Q * ds;
    const float* ctc = ct + grow * ds * Q;
    const float* cbc = cb + grow * Q * Q;
    float* yc = y + row * Q * hd;

    // Step i's operand tile into slot i % 2: asynchronous copies, then
    // (finish) what a thread does to its own copies once they have landed.
    // A tile of Sᵀ holds rows s0.. of C Bᵀ for t >= s0 (s0 is a multiple of
    // kRows, so no micro-tile that reads it has a row t < s0), and is
    // finished into Sᵀ[s - s0][t] = C Bᵀ[s][t] * exp(cs_t - cs_s), s <= t.
    auto tile_of = [&](int i) {
      return smem + L.tiles + (i & 1) * kTileK * width;
    };
    auto st_start = [&](int i) {  // s0 of step i, or -1 if it is no Sᵀ tile
      const int j = i % y_step;
      return i < y_steps && j >= n_ct ? (j - n_ct) * kTileK : -1;
    };
    auto stage = [&](int i) {
      float* tile = tile_of(i);
      if (i >= y_steps) {
        const int q0 = ((i - y_steps) % n_st) * kTileK;
        stage_rows(tile, width, Bc, ds, 0, q0, min(kTileK, Q - q0), vec_b);
        return;
      }
      const int s0 = st_start(i);
      if (s0 < 0) {
        const int n0 = (i % y_step) * kTileK;
        stage_rows(tile, width, ctc, Q, 0, n0, min(kTileK, ds - n0), vec_q);
        return;
      }
      stage_rows(tile, width, cbc, Q, s0, s0, min(kTileK, Q - s0), vec_q);
    };
    auto finish = [&](int i) {  // entries above the diagonal become 0
      const int s0 = st_start(i);
      if (s0 < 0) return;
      float* tile = tile_of(i);
      const int kn = min(kTileK, Q - s0);
      const auto l = [&](float v, int s, int t) {
        return s <= t ? __fmul_rn(v, expf(cs[t] - cs[s])) : 0.0f;
      };
      if (vec_q) {  // the float4s this thread copied
        for (Walk w((Q - s0) / 4); w.r < kn; w.next()) {
          const int s = s0 + w.r, t = s0 + 4 * w.c;
          float4* p = reinterpret_cast<float4*>(tile + w.r * width + t);
          float4 v = *p;
          v.x = l(v.x, s, t);
          v.y = l(v.y, s, t + 1);
          v.z = l(v.z, s, t + 2);
          v.w = l(v.w, s, t + 3);
          *p = v;
        }
      } else {
        for (Walk w(Q - s0); w.r < kn; w.next()) {
          float* p = tile + w.r * width + s0 + w.c;
          *p = l(*p, s0 + w.r, s0 + w.c);
        }
      }
    };

    __syncthreads();  // the previous chunk is done with x·dt and the tiles
    if (vec_x) {
      for (Walk w(hd / 4); w.r < Q; w.next())
        cp_async4(xdt + w.r * hdp + 4 * w.c, xc + w.r * hd + 4 * w.c);
    } else {
      for (Walk w(hd); w.r < Q; w.next())
        cp_async(xdt + w.r * hdp + w.c, xc + w.r * hd + w.c);
    }
    for (int q = tid; q < Q; q += kThreads) cp_async(dts + q, dtc + q);
    stage(0);  // a Cᵀ tile: needs no cs
    cp_async_wait();
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
#pragma unroll 8
      for (int q = 0; q < Q; ++q) {
        run = __fadd_rn(run, __fmul_rn(dts[q], a));
        cs[q] = run;
      }
    }
    scale_rows(xdt, Q, hdp, dts);  // the padding columns stay 0
    __syncthreads();
    const float last = cs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) {
      ecs[q] = expf(cs[q]);
      dout[q] = expf(last - cs[q]);
    }
    const float seg = expf(last);
    finish(0);
    __syncthreads();

    // y passes: acc = C h (ah), acc2 = S (x·dt) (ai); h passes: acc =
    // Bᵀ (x·dt ∘ exp(cs[-1] - cs))
    float acc[kRows][kCols], acc2[kRows][kCols];
    zero(acc);
    zero(acc2);
    for (int i = 0; i < steps; ++i) {
      if (i + 1 < steps) stage(i + 1);
      const float* tile = smem + L.tiles + (i & 1) * kTileK * width;
      if (i < y_steps) {
        const int j = i % y_step;
        const int m = (i / y_step) * kThreads + tid;
        if (m < y_tiles) {
          const int t0 = (m / col_tiles) * kRows;
          const int d0 = (m % col_tiles) * kCols;
          if (j < n_ct) {
            const int n0 = j * kTileK;
            micro_mma(tile + t0, width, h + n0 * hdp + d0, hdp,
                      min(kTileK, ds - n0), acc);
          } else {
            // S is 0 above the diagonal: stop after the micro-tile's last row
            const int s0 = (j - n_ct) * kTileK;
            const int kn = min(min(kTileK, Q - s0), t0 + kRows - s0);
            if (kn > 0)
              micro_mma(tile + t0, width, xdt + s0 * hdp + d0, hdp, kn, acc2);
          }
          if (j == y_step - 1) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int cc = 0; cc < kCols; ++cc) {
                const int t = t0 + r, d = d0 + cc;
                if (t < Q && d < hd)
                  yc[(int64_t)t * hd + d] =
                      __fadd_rn(acc2[r][cc], __fmul_rn(acc[r][cc], ecs[t]));
              }
            zero(acc);
            zero(acc2);
          }
        }
      } else {
        const int j = (i - y_steps) % n_st;
        const int m = ((i - y_steps) / n_st) * kThreads + tid;
        if (m < h_tiles) {
          const int n0 = (m / col_tiles) * kRows;
          const int d0 = (m % col_tiles) * kCols;
          const int q0 = j * kTileK;
          micro_mma(tile + n0, width, xdt + q0 * hdp + d0, hdp,
                    min(kTileK, Q - q0), acc);
          if (j == n_st - 1) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int cc = 0; cc < kCols; ++cc) {
                const int n = n0 + r, d = d0 + cc;
                if (n < ds && d < hd) {
                  float* hp = h + n * hdp + d;
                  *hp = __fadd_rn(__fmul_rn(*hp, seg), acc[r][cc]);
                }
              }
            zero(acc);
          }
        }
      }
      cp_async_wait();
      if (i + 1 < steps) finish(i + 1);
      if (i == y_steps - 1) {
        __syncthreads();  // every product with x·dt of the y passes is done
        scale_rows(xdt, Q, hdp, dout);
      }
      __syncthreads();  // tile i + 1 is in; slot i % 2 is free
    }
  }
  __syncthreads();
  float* ho = hout + (int64_t)bh * ds * hd;
  for (Walk w(hd); w.r < ds; w.next())
    ho[w.r * hd + w.c] = h[w.r * hdp + w.c];
}

// The main path's shapes (mamba2_370m: chunk 128, head 64, state 128) take
// the instantiation with them fixed at compile time; other shapes the
// generic one. ``f`` is called with a pointer to the kernel to launch.
template <typename F>
auto with_scan_kernel(int Q, int hd, int ds, F&& f) {
  if (Q == 128 && hd == 64 && ds == 128) return f(ssd_scan_kernel<128, 64, 128>);
  return f(ssd_scan_kernel<0, 0, 0>);
}

// Raise both kernels' dynamic shared-memory limits to what the shapes
// need; cudaErrorInvalidValue when a block may not have that much.
template <typename K>
int prepare(K scan, int Q, int hd, int ds, size_t* scan_bytes,
            size_t* cb_bytes) {
  *scan_bytes = scan_smem_bytes(Q, hd, ds);
  *cb_bytes = cb_smem_bytes(Q);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (*scan_bytes > (size_t)optin || *cb_bytes > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*scan_bytes);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's shared memory, so that two blocks fit beside each other
  err = cudaFuncSetAttribute(scan,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(ssd_scan_cb_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*cb_bytes);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x (BH, nc, Q, hd), dt (BH, nc, Q),
// A (BH,), B and C (BH / heads_per_group, nc, Q, ds), all f32 and
// contiguous; row bh reads B and C of group bh / heads_per_group. cb and ct
// are scratch of (BH / heads_per_group, nc, Q, Q) and (BH / heads_per_group,
// nc, ds, Q) f32, for C Bᵀ and Cᵀ. Writes y (BH, nc, Q, hd) and the final
// state h (BH, ds, hd). Launches the pre-pass and the scan on ``stream`` and
// returns the first CUDA error (0 on success); cudaErrorInvalidValue when
// the shapes need more shared memory than a block may have. Allocates
// nothing.
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* Bm,
                               const float* Cm, float* cb, float* ct,
                               int BH, int nc, int Q, int hd, int ds,
                               int heads_per_group, float* y, float* hout,
                               void* stream) {
  if (BH == 0) return 0;
  return with_scan_kernel(Q, hd, ds, [&](auto scan) {
    size_t scan_bytes = 0, cb_bytes = 0;
    const int err = prepare(scan, Q, hd, ds, &scan_bytes, &cb_bytes);
    if (err != 0) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int groups = BH / heads_per_group;
    if (nc > 0) {
      ssd_scan_cb_kernel<<<groups * nc, kThreads, cb_bytes, s>>>(Bm, Cm, Q,
                                                                 ds, cb, ct);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    scan<<<BH, kThreads, scan_bytes, s>>>(x, dt, A, Bm, ct, cb, nc, Q, hd, ds,
                                          heads_per_group, y, hout);
    return (int)cudaGetLastError();
  });
}

// Bytes of dynamic shared memory a scan block takes at these shapes (the
// pre-pass takes less).
extern "C" size_t ssd_scan_smem_bytes(int Q, int hd, int ds) {
  return scan_smem_bytes(Q, hd, ds);
}

// Blocks of the scan and of the pre-pass that one SM holds at once at these
// shapes, as the occupancy calculator gives them; returns a CUDA error.
extern "C" int ssd_scan_blocks_per_sm(int Q, int hd, int ds, int* scan,
                                      int* pre) {
  return with_scan_kernel(Q, hd, ds, [&](auto kernel) {
    size_t scan_bytes = 0, cb_bytes = 0;
    int err = prepare(kernel, Q, hd, ds, &scan_bytes, &cb_bytes);
    if (err != 0) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        scan, kernel, kThreads, scan_bytes);
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        pre, ssd_scan_cb_kernel, kThreads, cb_bytes);
  });
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
