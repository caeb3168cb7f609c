// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), its
// products on the tensor cores in 3xTF32.
//
// No TPU kernel corresponds: the JAX package differentiates its jnp
// ssd_chunked (src/repro/models/mamba2.py:71) and never calls its Pallas
// scan in training. This is the gradient of csrc/ssd_scan.cu, and computes
// what autograd through repro_torch.kernels.ssd_scan.ssd_scan_plain gives.
// Per (batch * head) row, with the forward
//   y = (C Bᵀ ∘ L)(x·dt) + (C h) ∘ exp(cs),  L[t,s] = exp(cs_t - cs_s), s <= t
//   h ← h·exp(cs[-1]) + Bᵀ((x·dt) ∘ exp(cs[-1] - cs)),  cs = cumsum(dt·A)
// and dy (dh of the final state: given, or 0), with h_in the state entering
// chunk c and dh the gradient of the state leaving it:
//   d(x·dt) = (C Bᵀ ∘ L)ᵀ dy + exp(cs[-1] - cs) ∘ (B dh)
//   dC = (dM ∘ L) B + exp(cs) ∘ (dy h_inᵀ),   dM = dy (x·dt)ᵀ (causal)
//   dB = (dM ∘ L)ᵀ C + exp(cs[-1] - cs) ∘ ((x·dt) dhᵀ)
//   d cs from L, exp(cs) (exp(cs_t) times the row sum of C ∘ (dy h_inᵀ):
//   C h_in is never formed) and exp(cs[-1] - cs), then a reverse cumsum
//   into d(dt·A), which gives ddt (with x · d(x·dt)) and dA
//   dh_in = exp(cs[-1]) dh + Cᵀ(exp(cs) ∘ dy)
// Given h_in and dh, everything a chunk needs is local to it (cs is a
// cumsum within the chunk). Only two recurrences over the chunks are
// serial: the states forward and dh backward.
//
// Bound on an H100: operations. At the training shapes of mamba2_370m
// (BH = 256 rows in 8 groups, nc = 32, Q = 128, hd = 64, ds = 128) the
// products come to 138.4 GFLOP (the causal halves of dM, (dM ∘ L) B,
// (dM ∘ L)ᵀ C and (C Bᵀ ∘ L)ᵀ dy and of C Bᵀ once per group; B dh,
// dy h_inᵀ, (x·dt) dhᵀ, Cᵀ(exp(cs) ∘ dy) and the chunk-local states,
// Q·ds·hd each): 2.07 ms at the fp32 rate outside the tensor cores (67
// TFLOP/s), and, as three TF32 products each, 0.84 ms at the TF32 rate
// (495 TFLOP/s), against 0.88 GB of inputs read once and outputs written
// once (x, dy, dx; dt, ddt; A, dA; B, C, dB, dC a group: 0.26 ms at 3.35
// TB/s). chip_smoke's ssd_bwd_bound_ms works them out from the shapes.
//
// Design: four kernels a call.
// 1. ssd_bwd_cb_kernel, one block per (group, chunk): C Bᵀ of the chunk,
//    [t][s], 0 above the diagonal, into scratch.
// 2. ssd_bwd_states_kernel, one block per row over its chunks: the chunk
//    cumsums into scratch (one lane a chunk, each in the forward's order),
//    then the two recurrences, their chunk-local products (Bᵀ((x·dt) ∘
//    exp(cs[-1] - cs)) and Cᵀ(exp(cs) ∘ dy)) in turn with the carries, the
//    states and dh written per chunk, [d][n]. 256 blocks at two an SM fill
//    the card in one wave at the training shapes; splitting a row's state
//    across blocks gained nothing (the SM's throughput, not the chain,
//    bounds it), and a kernel a stage (the chunk-local products in
//    parallel, then elementwise recurrences) moved 1.07 GB more.
// 3. ssd_bwd_main_kernel, one block per (row, chunk), 8,192 blocks at the
//    training shapes, two an SM (115,328 bytes of shared memory, registers
//    capped at 128): L formed once in shared memory (one expf an entry),
//    then the chunk's products in three two-phase block products, each
//    output one accumulator over both phases: d(x·dt) = exp(cs[-1] - cs) ∘
//    (B dh) + (C Bᵀ ∘ L)ᵀ dy, whose C Bᵀ slabs are scaled by L as they
//    land; dM, turned in place into dM ∘ L with the row and column sums of
//    dM ∘ C Bᵀ ∘ L; dB; dC, which reads dM ∘ L with k fastest where dB
//    reads it k-major; then the reverse cumsum as a warp scan into ddt
//    and the chunk's part of dA. dB and dC are written per row. The terms
//    of d cs and ddt that need x (x · d(x·dt) and du · x) come from sums
//    the products hold anyway (the column sums above before dt, and the
//    row sums of B ∘ (x dhᵀ) from dB's first phase), so no step reads x
//    outside the staging. Outputs larger than L2 (dx, the per-row dB and
//    dC, the states kernel's states and dh) are stored as streaming, to
//    leave L2 to the group's B, C and C Bᵀ that every row reads.
// 4. ssd_bwd_reduce_kernel: dA summed over the chunks, dB and dC over a
//    group's rows, each in a fixed order.
// A product is an mma.sync m16n8k8 TF32 pass: a warp takes 32 x 32 outputs
// (2 m-tiles of 16 rows by 4 n-tiles of 8 columns; at two blocks an SM a
// 64 x 32 tile spilled), its m-tiles folded so that a warp pairs rows at
// the chunk's start with rows at its end and the causal products give
// every warp the same work, and the causal bounds are kept per m-tile.
// Operands in device memory are staged by cp.async in slabs of 16 k, in
// their own layout (16-byte copies either way): [k][i] rows 8 mod 32
// floats long where the operand is stored k-major, [i][k] rows of 20
// floats where it is stored with k fastest, both free of bank conflicts
// for the fragment loads. The main kernel keeps one slab in flight while
// it uses another, the states kernel three. A slab that needs scaling
// (x·dt·exp(cs[-1] - cs), exp(cs) ∘ dy, C Bᵀ ∘ L) is scaled in place by
// the threads that copied it once their copies have landed, so no expf is
// inside a k-loop. A row's sums over a tile's columns go over the quad by
// shuffles, and over the tiles in tile order through shared memory.
//
// Arithmetic: 3xTF32, each operand split as hi = tf32(a), rounded to
// nearest, and lo = a - hi, which the tensor cores read as TF32 rounded
// toward zero; lo·hi + hi·lo + hi·hi (lo·lo dropped) of each k-step of 8
// summed on the tensor cores from 0, then added to the output's fp32
// accumulator by a rounded add. The tensor cores' own fp32 accumulation
// does not round to nearest: chained over a whole product it took dA's
// error to a float64 version to 5.3x the plain float32 version's at
// jamba's shape, and with a rounded add a step every output stays within
// 1.2x. Rounding lo to nearest as well added an instruction to each split
// and left the errors no smaller.
// No atomics, so two calls on the same inputs give the same bits. The main
// path's shapes (Q 128, hd 64, ds 128) get instantiations with them fixed
// at compile time; other shapes take the generic ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 16;  // k of a staged slab
constexpr int kRowStride = kTileK + 4;  // of a slab stored [i][k]
constexpr int kEdge = 64;   // warp tiles cover whole multiples of it
// per-warp-tile row and column sums of an epilogue
constexpr int kPartials = kWarps * kEdge + kWarps * kEdge;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Row stride of a staged slab, or of the resident Q x Q matrix, holding m
// columns: room for whole warp tiles past the edge, 8 mod 32 floats so
// that a warp's fragment loads (8 rows of k apart by the stride, 4 columns
// apart by one float) fall in 32 distinct banks.
__host__ __device__ inline int slab_width(int m) {
  return round_up(m, kEdge) + 8;
}

// A staged slab of an operand with m rows or columns: [k][i] (kTileK rows
// of slab_width(m)) for an operand stored k-major, [i][k] (rows of
// kRowStride, 4 mod 32 floats: a warp's fragment loads, 8 rows apart by the
// stride and 4 k apart by one float, fall in 32 distinct banks) for one
// stored with k fastest.
__host__ __device__ inline int slab_floats(int m) {
  return imax(kTileK * slab_width(m), round_up(m, kEdge) * kRowStride);
}

// Slots of staged slabs (an A and a B slab each) in a kernel's ring: the
// main kernel keeps two, so that two of its blocks fit an SM beside their
// Q x Q matrices; the states kernel, one block a row walking the row's
// chunks, four, three slabs in flight to hide device memory's latency.
constexpr int kMainStages = 2;
constexpr int kStatesStages = 4;

// The slots of staged slabs, or the per-tile sums of an epilogue, whichever
// is larger (they are never in use at once).
__host__ __device__ inline int ring_floats(int Q, int hd, int ds,
                                           int stages) {
  return imax(stages * 2 * slab_floats(imax(Q, imax(hd, ds))), kPartials);
}

// The main kernel's shared memory, in floats: the Q x Q matrix X (L, then
// dM ∘ L; zero past Q up to whole warp tiles), the ring, and the chunk's
// vectors. Every array starts on a 16-byte boundary.
struct MainSmem {
  int xw, qp;
  int X, ring, dts, cs, ecs, dout, drow, dcol, dce, gd, dtx, red, total;
  __host__ __device__ MainSmem(int Q, int hd, int ds) {
    xw = slab_width(Q);
    qp = round_up(Q, 4);
    X = 0;
    ring = X + round_up(Q, kEdge) * xw;
    dts = ring + ring_floats(Q, hd, ds, kMainStages);
    cs = dts + qp;
    ecs = cs + qp;
    dout = ecs + qp;
    drow = dout + qp;
    dcol = drow + qp;
    dce = dcol + qp;
    gd = dce + qp;
    dtx = gd + qp;
    red = dtx + qp;
    total = red + 32;
  }
};

// The states kernel's: the ring (its A slabs hd wide, its B slabs ds),
// the running state (hd x ds) and the chunk's vectors.
struct StatesSmem {
  int qp, ring, state, dts, cs, ecs, dout, total;
  __host__ __device__ StatesSmem(int Q, int hd, int ds) {
    qp = round_up(Q, 4);
    ring = 0;
    state = imax(kStatesStages * (slab_floats(hd) + slab_floats(ds)),
                 kPartials);
    dts = state + round_up(hd * ds, 4);
    cs = dts + qp;
    ecs = cs + qp;
    dout = ecs + qp;
    total = dout + qp;
  }
};

size_t main_smem_bytes(int Q, int hd, int ds) {
  return sizeof(float) * (size_t)MainSmem(Q, hd, ds).total;
}
size_t states_smem_bytes(int Q, int hd, int ds) {
  return sizeof(float) * (size_t)StatesSmem(Q, hd, ds).total;
}
size_t cb_smem_bytes(int Q) {
  return sizeof(float) * (size_t)(kMainStages * 2 * slab_floats(Q));
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
// boundaries) from device memory into shared memory, asynchronously: the
// copy is visible to the thread once cp_async_wait<n> has found no more
// than n of its later groups (cp_async_commit) pending, and to the block
// after a barrier that follows that.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sum of v over the warp's 32 lanes, in the same order in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of every thread's v, in a fixed order, to every thread; red
// holds kWarps floats of shared memory. Two barriers.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// An operand of a block product: element (k, i), k < K, i < n, at p[k * ld
// + i] (k-major) or p[i * ld + k] (k fastest): in device memory, staged a
// slab at a time; or resident in shared memory at res (p null). A staged
// k-major slab may be scaled once it has landed: v·f1[k] (then ·f2[k]), or
// v·fm[k * fml + i].
struct Operand {
  const float* p;
  const float* res;
  int ld;
  bool kmajor;
  const float* f1;
  const float* f2;
  const float* fm;
  int fml;
};

__device__ __forceinline__ Operand rows_of(const float* p, int ld) {
  Operand o{};
  o.p = p;
  o.ld = ld;
  o.kmajor = true;
  return o;
}

__device__ __forceinline__ Operand cols_of(const float* p, int ld) {
  Operand o{};
  o.p = p;
  o.ld = ld;
  return o;
}

__device__ __forceinline__ Operand resident(const float* s, int ld,
                                            bool kmajor) {
  Operand o{};
  o.res = s;
  o.ld = ld;
  o.kmajor = kmajor;
  return o;
}

// Whether a k-major operand's rows of n floats go by 16-byte copies.
__device__ __forceinline__ bool vec_rows(const Operand& o, int n) {
  return n % 4 == 0 && o.ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(o.p) % 16 == 0;
}

// The slab of elements (k0 + k, i) of o for k < kn, i < n, as asynchronous
// copies of o's rows: [k][i] at slab[k * w + i] (o k-major), else [i][k]
// at slab[i * kRowStride + k]. The k from kn up to a multiple of 8 (the
// products' step) are set to 0.
__device__ __forceinline__ void stage(float* slab, int w, const Operand& o,
                                      int n, int k0, int kn) {
  const int pad = round_up(kn, 8) - kn;
  if (!o.kmajor) {
    if (pad > 0)
      for (Walk q(pad); q.r < n; q.next())
        slab[q.r * kRowStride + kn + q.c] = 0.0f;
    if (kn == kTileK && o.ld % 4 == 0 &&
        reinterpret_cast<uintptr_t>(o.p) % 16 == 0) {
      for (Walk q(kTileK / 4); q.r < n; q.next())
        cp_async4(slab + q.r * kRowStride + 4 * q.c,
                  o.p + (int64_t)q.r * o.ld + k0 + 4 * q.c);
    } else {
      for (Walk q(kn); q.r < n; q.next())
        cp_async(slab + q.r * kRowStride + q.c,
                 o.p + (int64_t)q.r * o.ld + k0 + q.c);
    }
    return;
  }
  for (Walk q(w); q.r < pad; q.next()) slab[(kn + q.r) * w + q.c] = 0.0f;
  if (vec_rows(o, n)) {
    for (Walk q(n / 4); q.r < kn; q.next())
      cp_async4(slab + q.r * w + 4 * q.c,
                o.p + (int64_t)(k0 + q.r) * o.ld + 4 * q.c);
  } else {
    for (Walk q(n); q.r < kn; q.next())
      cp_async(slab + q.r * w + q.c, o.p + (int64_t)(k0 + q.r) * o.ld + q.c);
  }
}

__device__ __forceinline__ float scaled(const Operand& o, int k, int i,
                                        float v) {
  if (o.fm) return __fmul_rn(v, o.fm[k * o.fml + i]);
  v = __fmul_rn(v, o.f1[k]);
  return o.f2 ? __fmul_rn(v, o.f2[k]) : v;
}

// Scales the entries of a staged k-major slab that this thread copied
// (the walk of ``stage``), once they have landed.
__device__ __forceinline__ void finish(float* slab, int w, const Operand& o,
                                       int n, int k0, int kn) {
  if (!o.f1 && !o.fm) return;
  if (vec_rows(o, n)) {
    for (Walk q(n / 4); q.r < kn; q.next()) {
      float4* p = reinterpret_cast<float4*>(slab + q.r * w + 4 * q.c);
      const int k = k0 + q.r, i = 4 * q.c;
      float4 v = *p;
      v.x = scaled(o, k, i, v.x);
      v.y = scaled(o, k, i + 1, v.y);
      v.z = scaled(o, k, i + 2, v.z);
      v.w = scaled(o, k, i + 3, v.w);
      *p = v;
    }
  } else {
    for (Walk q(n); q.r < kn; q.next()) {
      float* p = slab + q.r * w + q.c;
      *p = scaled(o, k0 + q.r, q.c, *p);
    }
  }
}

// A float as TF32 (round to nearest, ties away), in a 32-bit register.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 21 bits: hi = tf32(x), and lo = x - hi, exact in
// fp32, which the tensor cores take as TF32 by dropping its low 13 bits
// (an error below 2^-21 |x|, as |x - hi| <= 2^-11 |x|).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b on the tensor cores: a 16 x 8 (row-major fragment), b 8 x 8
// (column-major), c 16 x 8, fp32 accumulation. Lane l = 4 g + t holds a at
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), b at (t, g), (t + 4, g),
// and c at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Which k a 16-row m-tile at row r sums over: all; k >= r (an operand zero
// for k below the row); k < r + 16 (zero above it); or, for an 8-column
// n-tile at column c, none when c > r + 15 (a causal output, which is 0
// above the diagonal).
enum KRange { kAll, kFromRow, kToRow, kLower };

// One product of a block_product: sum over k < K of A(k, m) B(k, n), the
// k of an m-tile limited by ``mode``.
struct Phase {
  int K;
  Operand A, B;
  int mode;
};

// The m-tile (16 rows) at position p of the folded order 0, n - 1, 1,
// n - 2, ... of n m-tiles, and the position of m-tile u. A warp takes MT
// consecutive positions, so that its rows pair the chunk's start with its
// end and the causal products give every warp the same work.
__device__ __forceinline__ int unfold(int p, int n) {
  return p % 2 == 0 ? p / 2 : n - 1 - p / 2;
}
__device__ __forceinline__ int fold(int u, int n) {
  return u < (n + 1) / 2 ? 2 * u : 2 * (n - 1 - u) + 1;
}

// Where a lane's accumulators of a warp tile lie: m-tile mt's first row,
// the tile's first column, and the lane's place in its fragments.
template <int MT>
struct Frag {
  int rows[MT];
  int c0, g, t;
  // the row of acc[mt][.][2h + e], the column of acc[.][nt][2h + e]
  __device__ int row(int mt, int h) const { return rows[mt] + g + 8 * h; }
  __device__ int col(int nt) const { return c0 + 8 * nt + 2 * t; }
};

// The sum of v over a quad (the 4 lanes that share g), and over the 8
// lanes that share t; the same order in every lane.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// A mid step that does nothing.
struct NoMid {
  template <typename F, typename T>
  __device__ void operator()(const F&, T&) const {}
};

// out[m][n] = P1(m, n), then mid, then + P2(m, n), for m < M, n < N, on
// the tensor cores in 3xTF32: each operand split as hi + lo, and lo·hi +
// hi·lo + hi·hi of each k-step added in fp32 (lo·lo dropped). A warp takes a tile
// of MT m-tiles (16 rows, in the folded order) by NT n-tiles (8 columns),
// in passes of kWarps tiles (n fastest). mid(f, acc) runs on each live
// tile between the phases. The staged operands of both phases stream
// through the ring's STAGES slots, slabs of kTileK rows of k, STAGES - 1
// of them in flight while one is used. Then epi(p, f, acc) on each live
// tile (p: its index in the pass), a barrier, post(m0, tn) by every thread
// (m0: the pass's first tile, tn: tiles a row), a barrier. Every thread
// must call it; mid and epi run on whole warps.
template <int MT, int NT, int STAGES, typename Mid, typename Epi,
          typename Post>
__device__ __forceinline__ void block_product2(int M, int N, const Phase& P1,
                                               const Phase& P2, float* ring,
                                               Mid&& mid, Epi&& epi,
                                               Post&& post) {
  constexpr int WM = 16 * MT, WN = 8 * NT;
  const int wa = slab_width(M), wb = slab_width(N);
  const int sa = slab_floats(M), slot = sa + slab_floats(N);
  const int tn = cdiv(N, WN), tm = cdiv(M, WM), tiles = tm * tn;
  const int n1 = cdiv(P1.K, kTileK), nk = n1 + cdiv(P2.K, kTileK);
  const int lane = threadIdx.x & 31;
  const auto slab = [&](int i) { return ring + (i % STAGES) * slot; };
  // each use of a phase names P1 or P2 itself, so that both stay in
  // registers (a reference chosen at run time would put them in memory)
  const auto stage_slab = [&](int i) {
    const auto go = [&](const Phase& P, int k0) {
      const int kn = min(kTileK, P.K - k0);
      if (P.A.p) stage(slab(i), wa, P.A, M, k0, kn);
      if (P.B.p) stage(slab(i) + sa, wb, P.B, N, k0, kn);
    };
    if (i < n1)
      go(P1, i * kTileK);
    else
      go(P2, (i - n1) * kTileK);
  };
  const auto finish_slab = [&](int i) {
    const auto go = [&](const Phase& P, int k0) {
      const int kn = min(kTileK, P.K - k0);
      if (P.A.p) finish(slab(i), wa, P.A, M, k0, kn);
      if (P.B.p) finish(slab(i) + sa, wb, P.B, N, k0, kn);
    };
    if (i < n1)
      go(P1, i * kTileK);
    else
      go(P2, (i - n1) * kTileK);
  };
  for (int m0 = 0; m0 < tiles; m0 += kWarps) {
    const int wt = m0 + (threadIdx.x >> 5);
    const bool live = wt < tiles;
    Frag<MT> f;
    f.g = lane >> 2;
    f.t = lane & 3;
    f.c0 = (wt % tn) * WN;
    int rmin = M, rmax = -16;  // of the m-tiles inside M
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      f.rows[mt] = 16 * unfold((wt / tn) * MT + mt, tm * MT);
      if (f.rows[mt] < M) {
        rmin = min(rmin, f.rows[mt]);
        rmax = max(rmax, f.rows[mt]);
      }
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    // slab i of phase P (first k k0) into the accumulators
    const auto compute = [&](const Phase& P, int i, int k0) {
      if (!live) return;
      const int kn = min(kTileK, P.K - k0);
      int k_lo = k0, k_hi = k0 + round_up(kn, 8);
      if (P.mode == kFromRow) k_lo = max(k_lo, rmin);
      if (P.mode == kToRow) k_hi = min(k_hi, rmax + 16);
      // element (k, i) of A at a_base[(k - a_k0) * lda + i] (k-major) or
      // a_base[i * lda + k - a_k0], the same for B
      const float* a_base = P.A.p ? slab(i) : P.A.res;
      const int a_k0 = P.A.p ? k0 : 0;
      const int lda = !P.A.p ? P.A.ld : P.A.kmajor ? wa : kRowStride;
      const float* b_base = P.B.p ? slab(i) + sa : P.B.res;
      const int b_k0 = P.B.p ? k0 : 0;
      const int ldb = !P.B.p ? P.B.ld : P.B.kmajor ? wb : kRowStride;
      for (int k = k_lo; k < k_hi; k += 8) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = f.c0 + 8 * nt + f.g;
          const float* b = P.B.kmajor ? b_base + (k - b_k0 + f.t) * ldb + n
                                      : b_base + n * ldb + k - b_k0 + f.t;
          const int b4 = P.B.kmajor ? 4 * ldb : 4;
          split(b[0], bh[nt][0], bl[nt][0]);
          split(b[b4], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = f.rows[mt];
          if (r >= M || (P.mode == kFromRow && k < r) ||
              (P.mode == kToRow && k >= r + 16))
            continue;
          const int m = r + f.g;
          const float* a = P.A.kmajor ? a_base + (k - a_k0 + f.t) * lda + m
                                      : a_base + m * lda + k - a_k0 + f.t;
          const int a4 = P.A.kmajor ? 4 * lda : 4;
          const int a8 = P.A.kmajor ? 8 : 8 * lda;
          uint32_t ah[4], al[4];
          split(a[0], ah[0], al[0]);
          split(a[a8], ah[1], al[1]);
          split(a[a4], ah[2], al[2]);
          split(a[a4 + a8], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (P.mode == kLower && f.c0 + 8 * nt > r + 15) continue;
            // this k-step alone, then a rounded add (see Arithmetic)
            float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(step, al, bh[nt]);
            mma_tf32(step, ah, bl[nt]);
            mma_tf32(step, ah, bh[nt]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += step[e];
          }
        }
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nk) stage_slab(i);
      cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of slab i
      finish_slab(i);
      // slab i is in everywhere, and every warp is done with slab i - 1,
      // whose slot slab i + STAGES - 1 takes
      __syncthreads();
      if (i + STAGES - 1 < nk) stage_slab(i + STAGES - 1);
      cp_async_commit();
      if (i < n1)
        compute(P1, i, i * kTileK);
      else
        compute(P2, i, (i - n1) * kTileK);
      if (i == n1 - 1 && live) mid(f, acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the epilogue's sums
    if (live) epi(wt - m0, f, acc);
    __syncthreads();
    post(m0, tn);
    __syncthreads();
  }
}

template <int MT, int NT, int STAGES, typename Epi, typename Post>
__device__ __forceinline__ void block_product(int M, int N, const Phase& P,
                                              float* ring, Epi&& epi,
                                              Post&& post) {
  block_product2<MT, NT, STAGES>(M, N, P, Phase{}, ring, NoMid{}, epi, post);
}

// p[c], p[c + 1] of a row of n floats: one 8-byte access where both lie in
// the row and on an 8-byte boundary, else one a float (0 past n).
__device__ __forceinline__ float2 load2(const float* p, int c, int n) {
  if (c + 1 < n && reinterpret_cast<uintptr_t>(p + c) % 8 == 0)
    return *reinterpret_cast<const float2*>(p + c);
  float2 v;
  v.x = c < n ? p[c] : 0.0f;
  v.y = c + 1 < n ? p[c + 1] : 0.0f;
  return v;
}

// a[0], a[1] of the columns c, c + 1 of a tile, 0 for a column past n (an
// accumulator there holds whatever a slab held past an operand's edge)
__device__ __forceinline__ float2 within(const float* a, int c, int n) {
  float2 v;
  v.x = c < n ? a[0] : 0.0f;
  v.y = c + 1 < n ? a[1] : 0.0f;
  return v;
}

// p[c] = x, p[c + 1] = y of a row of n floats, as load2 reads them; with
// ``stream``, marked to leave the caches first (outputs larger than L2 that
// no block of the same kernel reads again)
__device__ __forceinline__ void store2(float* p, int c, int n, float x,
                                       float y, bool stream = false) {
  if (c + 1 < n && reinterpret_cast<uintptr_t>(p + c) % 8 == 0) {
    float2 v;
    v.x = x;
    v.y = y;
    if (stream)
      __stcs(reinterpret_cast<float2*>(p + c), v);
    else
      *reinterpret_cast<float2*>(p + c) = v;
    return;
  }
  if (c < n) p[c] = x;
  if (c + 1 < n) p[c + 1] = y;
}

// Sums, for each q < n, the per-warp-tile sums of the pass's tiles that
// hold q, in tile order, into out[q]: as a row, part[p * WM + (the row's
// place in its tile)] over the tn tiles of its row of tiles; as a column,
// part[p * WN + q % WN] over the tm tiles of its column of tiles.
template <int MT>
__device__ __forceinline__ void add_row_sums(const float* part, int n,
                                             int m0, int tn, float* out) {
  const int mts = cdiv(n, 16 * MT) * MT;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int pos = fold(q / 16, mts);
    const int lr = (pos % MT) * 16 + q % 16;
    float v = 0.0f;
    for (int ct = 0; ct < tn; ++ct) {
      const int p = (pos / MT) * tn + ct - m0;
      if (p >= 0 && p < kWarps) v += part[p * 16 * MT + lr];
    }
    out[q] += v;
  }
}

template <int WN>
__device__ __forceinline__ void add_col_sums(const float* part, int n,
                                             int tm, int m0, int tn,
                                             float* out) {
  for (int q = threadIdx.x; q < n; q += kThreads) {
    float v = 0.0f;
    for (int rt = 0; rt < tm; ++rt) {
      const int p = rt * tn + q / WN - m0;
      if (p >= 0 && p < kWarps) v += part[p * WN + q % WN];
    }
    out[q] += v;
  }
}

// A post step that does nothing.
struct NoPost {
  __device__ void operator()(int, int) const {}
};

// C Bᵀ of one chunk of one group, one block per (group, chunk): cb[t][s] =
// sum_n C[t][n] B[s][n] for s <= t, 0 above the diagonal.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  int Q, int ds, float* __restrict__ cb) {
  extern __shared__ __align__(16) float smem[];
  const int64_t gc = blockIdx.x;
  const float* Bc = Bm + gc * Q * ds;
  const float* Cc = Cm + gc * Q * ds;
  float* out = cb + gc * Q * Q;
  block_product<2, 4, kMainStages>(
      Q, Q, Phase{ds, cols_of(Cc, ds), cols_of(Bc, ds), kLower}, smem,
      [&](int, const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = f.row(mt, h);
            if (t >= Q) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int s = f.col(nt);
              store2(out + t * Q, s, Q, s <= t ? acc[mt][nt][2 * h] : 0.0f,
                     s + 1 <= t ? acc[mt][nt][2 * h + 1] : 0.0f);
            }
          }
      },
      NoPost{});
}

// Per row, over its chunks: cs = cumsum(dt·A) of every chunk into scratch,
// one lane a chunk, each in the forward's order, and exp(cs[-1]); then the
// states entering the chunks, h_in[0] = 0 and h_in[c + 1] = h_in[c]·
// exp(cs_c[-1]) + Bᵀ((x·dt) ∘ exp(cs_c[-1] - cs_c)) (the forward's
// arithmetic, with the chunk-local product on the tensor cores), and dh
// leaving them, dh[nc - 1] = dh_final or 0 and dh[c - 1] = exp(cs_c[-1])·
// dh[c] + Cᵀ(exp(cs_c) ∘ dy_c). Both are (hd, ds), [d][n]; the one in hand
// stays in shared memory for the next chunk's carry. A nonzero kQ, kHd or
// kDs fixes Q, hd or ds at compile time.
template <int kQ, int kHd, int kDs>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_states_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_final, int nc, int Q_,
                      int hd_, int ds_, int heads_per_group,
                      float* __restrict__ cs_out, float* __restrict__ seg_out,
                      float* __restrict__ hs, float* __restrict__ dhs) {
  extern __shared__ __align__(16) float smem[];
  const int Q = kQ ? kQ : Q_, hd = kHd ? kHd : hd_, ds = kDs ? kDs : ds_;
  const StatesSmem L(Q, hd, ds);
  const int bh = blockIdx.x;
  const int64_t g = bh / heads_per_group;
  const int64_t hds = (int64_t)hd * ds;
  float* ring = smem + L.ring;
  float* state = smem + L.state;  // h, then dh, of the chunk in hand
  float* dts = smem + L.dts;
  float* cs = smem + L.cs;
  float* ecs = smem + L.ecs;
  float* dout = smem + L.dout;
  float* h_row = hs + (int64_t)bh * nc * hds;
  float* g_row = dhs + (int64_t)bh * nc * hds;
  const float a = A[bh];
  if (threadIdx.x < 32)
    for (int c = threadIdx.x; c < nc; c += 32) {
      const int64_t row = (int64_t)bh * nc + c;
      float run = 0.0f;
      for (int q = 0; q < Q; ++q) {
        run = __fadd_rn(run, __fmul_rn(dt[row * Q + q], a));
        cs_out[row * Q + q] = run;
      }
      seg_out[row] = expf(run);
    }
  for (int64_t e = threadIdx.x; e < hds; e += kThreads) {
    h_row[e] = 0.0f;
    state[e] = 0.0f;
  }
  __syncthreads();
  // chunk c's dt, cs, exp(cs) and exp(cs[-1] - cs); returns exp(cs[-1])
  const auto prologue = [&](int c) {
    const int64_t row = (int64_t)bh * nc + c;
    for (int q = threadIdx.x; q < Q; q += kThreads) {
      dts[q] = dt[row * Q + q];
      cs[q] = cs_out[row * Q + q];
    }
    __syncthreads();
    const float last = cs[Q - 1];
    for (int q = threadIdx.x; q < Q; q += kThreads) {
      ecs[q] = expf(cs[q]);
      dout[q] = expf(last - cs[q]);
    }
    __syncthreads();
    return seg_out[row];
  };
  // state = state·seg + acc (fmaf when fused), one element each, into
  // shared memory and out
  const auto carry = [&](float* out, float seg, bool fused) {
    return [=](int, const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = f.row(mt, h);
          if (d >= hd) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = f.col(nt);
            const float2 v = load2(state + d * ds, n, ds);
            const float* s = acc[mt][nt] + 2 * h;
            const float x = fused ? fmaf(seg, v.x, s[0])
                                  : __fadd_rn(__fmul_rn(v.x, seg), s[0]);
            const float y = fused ? fmaf(seg, v.y, s[1])
                                  : __fadd_rn(__fmul_rn(v.y, seg), s[1]);
            store2(state + d * ds, n, ds, x, y);
            store2(out + d * ds, n, ds, x, y, true);
          }
        }
    };
  };
  for (int c = 0; c + 1 < nc; ++c) {  // h_in[c + 1]
    const float seg = prologue(c);
    const int64_t row = (int64_t)bh * nc + c;
    Operand xo = rows_of(x + row * Q * hd, hd);
    xo.f1 = dts;
    xo.f2 = dout;
    block_product<2, 4, kStatesStages>(
        hd, ds, Phase{Q, xo, rows_of(Bm + (g * nc + c) * Q * ds, ds), kAll},
        ring, carry(h_row + (c + 1) * hds, seg, false),
        NoPost{});
  }
  for (int64_t e = threadIdx.x; e < hds; e += kThreads) {
    state[e] = dh_final ? dh_final[bh * hds + (e % ds) * hd + e / ds] : 0.0f;
    g_row[(nc - 1) * hds + e] = state[e];
  }
  __syncthreads();
  for (int c = nc - 1; c > 0; --c) {  // dh[c - 1]
    const float seg = prologue(c);
    const int64_t row = (int64_t)bh * nc + c;
    Operand yo = rows_of(dy + row * Q * hd, hd);
    yo.f1 = ecs;
    block_product<2, 4, kStatesStages>(
        hd, ds, Phase{Q, yo, rows_of(Cm + (g * nc + c) * Q * ds, ds), kAll},
        ring, carry(g_row + (c - 1) * hds, seg, true),
        NoPost{});
  }
}

// The backward of one chunk of one row, one block per (row, chunk); see
// the note at the top. Writes dx, ddt, the chunk's part of dA and the
// row's dB and dC of the chunk.
template <int kQ, int kHd, int kDs>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_main_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dy,
                    const float* __restrict__ cb,
                    const float* __restrict__ cs_in,
                    const float* __restrict__ seg_in,
                    const float* __restrict__ hs,
                    const float* __restrict__ dhs, int nc, int Q_, int hd_,
                    int ds_, int heads_per_group, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA_part,
                    float* __restrict__ dB_rows, float* __restrict__ dC_rows) {
  extern __shared__ __align__(16) float smem[];
  const int Q = kQ ? kQ : Q_, hd = kHd ? kHd : hd_, ds = kDs ? kDs : ds_;
  const MainSmem L(Q, hd, ds);
  const int xw = L.xw;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;  // bh * nc + c
  const int bh = (int)(row / nc), c = (int)(row % nc);
  const int64_t grow = (int64_t)(bh / heads_per_group) * nc + c;
  const int64_t hds = (int64_t)hd * ds;
  const float* xc = x + row * Q * hd;
  const float* dyc = dy + row * Q * hd;
  const float* Bc = Bm + grow * Q * ds;
  const float* Cc = Cm + grow * Q * ds;
  const float* cbc = cb + grow * Q * Q;
  const float* hc = hs + row * hds;
  const float* dhc = dhs + row * hds;
  float* dxc = dx + row * Q * hd;
  float* dBc = dB_rows + row * Q * ds;
  float* dCc = dC_rows + row * Q * ds;
  float* X = smem + L.X;
  float* ring = smem + L.ring;
  float* dts = smem + L.dts;
  float* cs = smem + L.cs;
  float* ecs = smem + L.ecs;
  float* dout = smem + L.dout;
  float* drow = smem + L.drow;
  float* dcol = smem + L.dcol;
  float* dce = smem + L.dce;
  float* gd = smem + L.gd;
  float* dtx = smem + L.dtx;
  float* dcs = drow;  // d cs once the row and column sums are taken
  float* rev = dcol;  // its reverse cumsum
  float* red = smem + L.red;
  float* rowp = ring;                 // per-warp-tile row sums
  float* colp = ring + kWarps * kEdge;  // per-warp-tile column sums
  const float a = A[bh];
  const float seg = seg_in[row];

  for (int q = tid; q < Q; q += kThreads) {
    dts[q] = dt[row * Q + q];
    cs[q] = cs_in[row * Q + q];
  }
  for (int e = tid; e < L.red - L.drow; e += kThreads) drow[e] = 0.0f;
  __syncthreads();
  const float last = cs[Q - 1];
  for (int q = tid; q < Q; q += kThreads) {
    ecs[q] = expf(cs[q]);
    dout[q] = expf(last - cs[q]);
  }
  // X = L, one expf an entry; 0 above the diagonal and past Q
  for (Walk w(xw); w.r < round_up(Q, kEdge); w.next())
    X[w.r * xw + w.c] =
        w.r < Q && w.c <= w.r ? expf(cs[w.r] - cs[w.c]) : 0.0f;
  __syncthreads();

  // du = B dh, then d(x·dt) = exp(cs[-1] - cs) ∘ du + (C Bᵀ ∘ L)ᵀ dy
  // (the C Bᵀ slabs scaled by L as they land) and dx = dt ∘ d(x·dt)
  {
    Operand cbl = rows_of(cbc, Q);
    cbl.fm = X;
    cbl.fml = xw;
    block_product2<2, 4, kMainStages>(
        Q, hd, Phase{ds, cols_of(Bc, ds), cols_of(dhc, ds), kAll},
        Phase{Q, cbl, rows_of(dyc, hd), kFromRow}, ring,
        [&](const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = min(f.row(mt, h), Q - 1);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float& a = acc[mt][nt][2 * h + e];
                  a = __fmul_rn(dout[s], a);
                }
            }
        },
        [&](int, const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = f.row(mt, h);
              if (s >= Q) continue;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const float* a = acc[mt][nt] + 2 * h;
                store2(dxc + s * hd, f.col(nt), hd, __fmul_rn(dts[s], a[0]),
                       __fmul_rn(dts[s], a[1]), true);
              }
            }
        },
        NoPost{});
  }

  // dM = dy (x·dt)ᵀ (causal); X becomes dM ∘ L, and P = dM ∘ L ∘ C Bᵀ
  // adds to d cs_t along its row and takes from d cs_s along its column.
  // The column sums are taken before dM's factor dt_s: so they are also
  // x_s · ((C Bᵀ ∘ L)ᵀ dy)_s, a part of x · d(x·dt)
  block_product<2, 4, kMainStages>(
      Q, Q, Phase{hd, cols_of(dyc, hd), cols_of(xc, hd), kLower}, ring,
      [&](int p, const Frag<2>& f, float (&acc)[2][4][4]) {
        float cpart[4][2] = {};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = f.row(mt, h);
            float rpart = 0.0f;
            if (t < Q) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                // L is 0 above the diagonal, and so is every product with
                // it
                const int s = f.col(nt);
                float2* xp = reinterpret_cast<float2*>(X + t * xw + s);
                float2 l = *xp;
                const float2 cb2 = load2(cbc + t * Q, s, Q);
                const float2 dm = within(acc[mt][nt] + 2 * h, s, Q);
                const float dt0 = dts[min(s, Q - 1)];
                const float dt1 = dts[min(s + 1, Q - 1)];
                const float p0 = __fmul_rn(__fmul_rn(dm.x, l.x), cb2.x);
                const float p1 = __fmul_rn(__fmul_rn(dm.y, l.y), cb2.y);
                l.x = __fmul_rn(__fmul_rn(dm.x, dt0), l.x);
                l.y = __fmul_rn(__fmul_rn(dm.y, dt1), l.y);
                *xp = l;
                rpart += __fmul_rn(p0, dt0);
                rpart += __fmul_rn(p1, dt1);
                cpart[nt][0] += p0;
                cpart[nt][1] += p1;
              }
            }
            rpart = quad_sum(rpart);
            if (f.t == 0) rowp[p * 32 + mt * 16 + f.g + 8 * h] = rpart;
          }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = column_sum(cpart[nt][e]);
            if (f.g == 0) colp[p * 32 + nt * 8 + 2 * f.t + e] = v;
          }
      },
      [&](int m0, int tn) {
        add_row_sums<2>(rowp, Q, m0, tn, drow);
        add_col_sums<32>(colp, Q, cdiv(Q, 32), m0, tn, dcol);
      });

  // dB = exp(cs[-1] - cs) ∘ ((x·dt) dhᵀ) + (dM ∘ L)ᵀ C, per row; between
  // the two, q_s = the row sum of B ∘ (x dhᵀ), which is du_s · x_s: through
  // exp(cs[-1] - cs), gd = exp(cs[-1] - cs) ∘ dt ∘ q adds to d cs[-1] and
  // takes from d cs_s, and exp(cs[-1] - cs) ∘ q is the rest of x ·
  // d(x·dt). A row's sums over a warp tile's columns are kept by the
  // quad's lane t = mt.
  {
    float keep[2];
    block_product2<2, 4, kMainStages>(
        Q, ds, Phase{hd, cols_of(xc, hd), rows_of(dhc, ds), kAll},
        Phase{Q, resident(X, xw, true), rows_of(Cc, ds), kFromRow}, ring,
        [&](const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = min(f.row(mt, h), Q - 1);
              float v = 0.0f;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const float2 bv = load2(Bc + s * ds, f.col(nt), ds);
                float* a = acc[mt][nt] + 2 * h;
                const float2 xdh = within(a, f.col(nt), ds);
                v = fmaf(bv.x, xdh.x, v);
                v = fmaf(bv.y, xdh.y, v);
                a[0] = __fmul_rn(__fmul_rn(a[0], dts[s]), dout[s]);
                a[1] = __fmul_rn(__fmul_rn(a[1], dts[s]), dout[s]);
              }
              v = quad_sum(v);
              if (f.t == mt) keep[h] = v;
            }
        },
        [&](int p, const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = f.row(mt, h);
              if (f.t == mt) rowp[p * 32 + mt * 16 + f.g + 8 * h] = keep[h];
              if (s >= Q) continue;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                store2(dBc + s * ds, f.col(nt), ds, acc[mt][nt][2 * h],
                       acc[mt][nt][2 * h + 1], true);
            }
        },
        [&](int m0, int tn) { add_row_sums<2>(rowp, Q, m0, tn, gd); });
  }

  // dC = exp(cs) ∘ (dy h_inᵀ) + (dM ∘ L) B, per row; between the two, the
  // row sums of C ∘ (dy h_inᵀ), the exp(cs) term of d cs
  {
    float keep[2];
    block_product2<2, 4, kMainStages>(
        Q, ds, Phase{hd, cols_of(dyc, hd), rows_of(hc, ds), kAll},
        Phase{Q, resident(X, xw, false), rows_of(Bc, ds), kToRow}, ring,
        [&](const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = min(f.row(mt, h), Q - 1);
              float v = 0.0f;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const float2 cv = load2(Cc + t * ds, f.col(nt), ds);
                float* a = acc[mt][nt] + 2 * h;
                const float2 dyh = within(a, f.col(nt), ds);
                v = fmaf(cv.x, dyh.x, v);
                v = fmaf(cv.y, dyh.y, v);
                a[0] = __fmul_rn(a[0], ecs[t]);
                a[1] = __fmul_rn(a[1], ecs[t]);
              }
              v = quad_sum(v);
              if (f.t == mt) keep[h] = v;
            }
        },
        [&](int p, const Frag<2>& f, float (&acc)[2][4][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = f.row(mt, h);
              if (f.t == mt) rowp[p * 32 + mt * 16 + f.g + 8 * h] = keep[h];
              if (t >= Q) continue;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                store2(dCc + t * ds, f.col(nt), ds, acc[mt][nt][2 * h],
                       acc[mt][nt][2 * h + 1], true);
            }
        },
        [&](int m0, int tn) { add_row_sums<2>(rowp, Q, m0, tn, dce); });
  }

  // d cs: through L, exp(cs[-1] - cs) and exp(cs); then d cs[-1] through
  // exp(cs[-1]) (the sum of dh ∘ h_in) and the gd terms
  float v = 0.0f;
  for (int e = tid; e < hds; e += kThreads) v = fmaf(dhc[e], hc[e], v);
  const float dseg = block_sum(v, red);
  // gd holds q, dcol the column sums before dt
  float gsum = 0.0f;
  for (int q = tid; q < Q; q += kThreads) {
    const float dq = __fmul_rn(dout[q], gd[q]);
    dtx[q] = __fadd_rn(dcol[q], dq);
    gd[q] = __fmul_rn(dts[q], dq);
    gsum += gd[q];
    dcs[q] = __fadd_rn(
        __fsub_rn(__fsub_rn(drow[q], __fmul_rn(dts[q], dcol[q])), gd[q]),
        __fmul_rn(ecs[q], dce[q]));
  }
  const float gtot = block_sum(gsum, red);
  if (tid == 0) dcs[Q - 1] += gtot + seg * dseg;
  __syncthreads();
  // the reverse cumsum of d cs, a warp scan from the chunk's end
  if (tid < 32) {
    float carry = 0.0f;
    for (int base = 0; base < Q; base += 32) {
      const int r = base + tid;  // steps from the end
      float s = r < Q ? dcs[Q - 1 - r] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += u;
      }
      if (r < Q) rev[Q - 1 - r] = carry + s;
      carry += __shfl_sync(0xffffffffu, s, 31);
    }
  }
  __syncthreads();
  float part = 0.0f;
  for (int q = tid; q < Q; q += kThreads) {
    ddt[row * Q + q] = fmaf(a, rev[q], dtx[q]);
    part = fmaf(dts[q], rev[q], part);
  }
  const float dA_c = block_sum(part, red);
  if (tid == 0) dA_part[row] = dA_c;
}

// dA[bh] = the sum of its chunks' parts in chunk order; with more than one
// row a group, dB and dC of a group the sums of its rows' in row order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dA_part, int BH, int nc,
                      int groups, int heads_per_group, int64_t per_row,
                      const float* __restrict__ dB_rows,
                      const float* __restrict__ dC_rows,
                      float* __restrict__ dA, float* __restrict__ dB,
                      float* __restrict__ dC) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx < BH) {
    float v = 0.0f;
    for (int c = 0; c < nc; ++c) v += dA_part[idx * nc + c];
    dA[idx] = v;
  }
  if (heads_per_group > 1 && idx < groups * per_row) {
    const int64_t g = idx / per_row, r = idx % per_row;
    const int64_t base = g * heads_per_group * per_row + r;
    float b = 0.0f, cc = 0.0f;
    for (int h = 0; h < heads_per_group; ++h) {
      b += dB_rows[base + h * per_row];
      cc += dC_rows[base + h * per_row];
    }
    dB[idx] = b;
    dC[idx] = cc;
  }
}

// The main path's shapes (mamba2_370m: chunk 128, head 64, state 128) take
// the instantiations with them fixed at compile time; other shapes the
// generic ones. ``f`` is called with the states and the main kernel.
template <typename F>
auto with_kernels(int Q, int hd, int ds, F&& f) {
  if (Q == 128 && hd == 64 && ds == 128)
    return f(ssd_bwd_states_kernel<128, 64, 128>,
             ssd_bwd_main_kernel<128, 64, 128>);
  return f(ssd_bwd_states_kernel<0, 0, 0>, ssd_bwd_main_kernel<0, 0, 0>);
}

struct Sizes {
  size_t cb, states, main;
};

// Raise the kernels' dynamic shared-memory limits to what the shapes need,
// with all of an SM's shared memory carved out for the two that hold two
// blocks an SM; cudaErrorInvalidValue when a block may not have that much.
template <typename KL, typename KM>
int prepare(KL states_k, KM main_k, int Q, int hd, int ds, Sizes* z) {
  z->cb = cb_smem_bytes(Q);
  z->states = states_smem_bytes(Q, hd, ds);
  z->main = main_smem_bytes(Q, hd, ds);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (z->main > (size_t)optin || z->states > (size_t)optin ||
      z->cb > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_bwd_cb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)z->cb);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      states_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)z->states);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(main_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)z->main);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(states_k,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      main_k, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and dy (BH, nc, Q, hd), dt
// (BH, nc, Q), A (BH,), B and C (G, nc, Q, ds) with G = BH /
// heads_per_group, dh_final (BH, ds, hd) or null (a zero gradient of the
// final state), all f32 and contiguous. Scratch: cb (G, nc, Q, Q), cs (BH,
// nc, Q), seg and dA_part (BH, nc), hs and dhs (BH, nc, hd, ds), and, with
// more than one row a group, dB_rows and dC_rows (BH, nc, Q, ds) (with one,
// pass dB and dC there). Writes dx (BH, nc, Q, hd), ddt (BH, nc, Q), dA
// (BH,), dB and dC (G, nc, Q, ds). Launches the four kernels on ``stream``;
// returns the first CUDA error (0 on success), cudaErrorInvalidValue when
// the shapes need more shared memory than a block may have. Allocates
// nothing.
extern "C" int ssd_scan_bwd_launch(
    const float* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* dy, const float* dh_final, float* cb,
    float* cs, float* seg, float* hs, float* dhs, float* dA_part,
    float* dB_rows, float* dC_rows, int BH, int nc, int Q, int hd, int ds,
    int heads_per_group, float* dx, float* ddt, float* dA, float* dB,
    float* dC, void* stream) {
  if (BH == 0) return 0;
  return with_kernels(Q, hd, ds, [&](auto states_k, auto main_k) {
    Sizes z;
    int err = prepare(states_k, main_k, Q, hd, ds, &z);
    if (err != 0) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int groups = BH / heads_per_group;
    const int64_t per_row = (int64_t)nc * Q * ds;
    const auto check = [] { return (int)cudaGetLastError(); };
    if (nc > 0) {
      ssd_bwd_cb_kernel<<<groups * nc, kThreads, z.cb, s>>>(Bm, Cm, Q, ds,
                                                            cb);
      if ((err = check())) return err;
      states_k<<<BH, kThreads, z.states, s>>>(x, dt, A, Bm, Cm, dy, dh_final,
                                             nc, Q, hd, ds, heads_per_group,
                                             cs, seg, hs, dhs);
      if ((err = check())) return err;
      main_k<<<BH * nc, kThreads, z.main, s>>>(
          x, dt, A, Bm, Cm, dy, cb, cs, seg, hs, dhs, nc, Q, hd, ds,
          heads_per_group, dx, ddt, dA_part, dB_rows, dC_rows);
      if ((err = check())) return err;
    }
    const int64_t n = heads_per_group > 1 && groups * per_row > BH
                          ? groups * per_row
                          : BH;
    ssd_bwd_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(dA_part, BH, nc, groups,
                                              heads_per_group, per_row,
                                              dB_rows, dC_rows, dA, dB, dC);
    return check();
  });
}

// Per kernel of a call, in launch order (C Bᵀ, the states, the main pass,
// the sums): the bytes of dynamic shared memory a block takes at these
// shapes, and the blocks one SM holds at once, as the occupancy calculator
// gives them; returns a CUDA error.
extern "C" int ssd_scan_bwd_kernel_info(int Q, int hd, int ds,
                                        long long* smem_bytes, int* blocks) {
  return with_kernels(Q, hd, ds, [&](auto states_k, auto main_k) {
    Sizes z;
    int err = prepare(states_k, main_k, Q, hd, ds, &z);
    if (err != 0) return err;
    const size_t bytes[4] = {z.cb, z.states, z.main, 0};
    for (int i = 0; i < 4; ++i) smem_bytes[i] = (long long)bytes[i];
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks[0], ssd_bwd_cb_kernel, kThreads, z.cb)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks[1], states_k, kThreads, z.states)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks[2], main_k, kThreads, z.main)))
      return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[3], ssd_bwd_reduce_kernel, kThreads, 0);
  });
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
