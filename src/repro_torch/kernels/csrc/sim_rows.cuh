// Route rows of the simulator's message pool, staged for one warp (sm_90a).
//
// Shared by drain_tick.cu and link_demand.cu. The pool's routes are a
// contiguous (B, M, K) int32 tensor, so the K-word rows of 32 consecutive
// messages are one contiguous run of 32 * K words (1,280 bytes at the
// paper's K = 10). A warp copies that run into its slice of shared memory
// with 16-byte loads (scalar loads for the few words before the first
// 16-byte boundary and after the last), every lane on neighbouring
// addresses, and each lane then reads its own row from shared memory. A
// warp whose 32 messages are all inactive reads no row at all.
//
// nan_min, the least share on a route, serves drain_tick.cu and
// router_tick.cu; allow_smem, the launchers' opt-in of dynamic shared
// memory, drain_tick.cu and link_demand.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sim_rows {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxStageBytes = 48 * 1024;  // without the opt-in attribute

// Copy ``n_words`` words from ``src`` (4-byte aligned) to ``dst`` in shared
// memory; every lane of the warp calls it. Ends with __syncwarp.
__device__ __forceinline__ void warp_stage(const int32_t* __restrict__ src,
                                           int n_words, int32_t* dst,
                                           int lane) {
  int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  if (head > n_words) head = n_words;
  if (lane < head) dst[lane] = __ldg(src + lane);
  const int n_vec = (n_words - head) >> 2;
  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  for (int i = lane; i < n_vec; i += 32) {
    const int4 v = __ldg(src4 + i);
    int32_t* d = dst + head + 4 * i;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = head + 4 * n_vec + lane; i < n_words; i += 32)
    dst[i] = __ldg(src + i);
  __syncwarp();
}

// The smaller of a and b, and NaN if either is NaN, as jnp.min and
// torch.amin take a minimum (fminf returns the other operand and so drops
// a NaN): PTX min.NaN (sm_80 and later), one instruction as min is.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Warps per block for kernels that stage 32 rows of K words per warp:
// eight while the rows fit the 48 KB of shared memory a block gets
// without the opt-in attribute (K <= 48), fewer for longer rows; 0 if one
// warp's rows do not fit (K > 384).
inline int warps_per_block(int K) {
  const int per_warp = 32 * K * (int)sizeof(int32_t);
  int w = kMaxStageBytes / (per_warp > 0 ? per_warp : 1);
  return w > 8 ? 8 : w;
}

// Devices a launcher keeps an opt-in record for.
constexpr int kMaxDevices = 64;

// Raise ``func``'s limit of dynamic shared memory to ``bytes`` on the
// current device unless ``allowed[device]`` (the launcher's record, zero
// at first) already covers it. An attribute holds for the device it was
// set on, so each device keeps its own record: the engine's replicas run
// the same launcher on several cards, one host thread a card.
template <typename F>
inline cudaError_t allow_smem(F* func, int bytes, int* allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[device] = bytes;
  return err;
}

}  // namespace sim_rows
