// The simulator's link demand, summed serially in index order (sm_90a).
//
// Not a port of a TPU kernel: the JAX engine takes this sum with a jnp
// scatter-add (src/repro/netsim/engine.py:805, the link demand of the
// injection step), which XLA on the CPU adds serially in index order.
// It computes the same function as repro_torch.kernels.link_demand.
// link_demand_plain on the CPU: for every (member, link) g,
//   demand[g] = ((0 + v_0) + v_1) + ...
// over the remaining bytes v_j of the active messages whose route crosses
// the link, in the order of their flat (member, message, route slot)
// index. UGAL compares these sums, so every bit counts: PyTorch's CUDA
// index_put_(accumulate=True) sums the duplicates of one index in another
// order, and at the first sampled tick of the paper-scale 1D dragonfly
// run 201 of its 53,857 sums differed from the CPU's in the last bits.
//
// Design. The wrapper sorts the (member, link) keys of all route entries
// with a stable sort (inactive entries and padding get a key past the
// last link) and finds where each key's run starts. This kernel takes
// one thread per (member, link) and adds its run serially with
// correctly rounded float adds (__fadd_rn), so the result is the serial
// sum whatever the order of the threads.
//
// Bound on an H100: memory. The sorted values (4 B per route entry) and
// the run starts (8 B per link) are read once and the sums (4 B per link)
// written once; one add per valid route entry. A long run is one thread's
// serial loop, which the bound does not see.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void serial_run_sum_kernel(const float* __restrict__ vals,
                                      const int64_t* __restrict__ starts,
                                      int64_t n_keys,
                                      float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_keys) return;
  float acc = 0.0f;
  const int64_t end = starts[g + 1];
  for (int64_t j = starts[g]; j < end; ++j) acc = __fadd_rn(acc, vals[j]);
  out[g] = acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes. ``vals`` holds the values in
// key order, ``starts`` (n_keys + 1) where each key's run starts and the
// last run ends. Writes ``out`` (n_keys). Launches on ``stream`` and
// returns the launch's CUDA error (0 on success). Allocates nothing.
extern "C" int link_demand_launch(const float* vals, const int64_t* starts,
                                  int64_t n_keys, float* out, void* stream) {
  if (n_keys == 0) return 0;
  const int64_t blocks = (n_keys + kThreads - 1) / kThreads;
  serial_run_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      vals, starts, n_keys, out);
  return (int)cudaGetLastError();
}

extern "C" const char* link_demand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
