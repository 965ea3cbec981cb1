// Blocked Multi-Jump: pointer jumping with continuous write-back over
// vertex tiles in ascending order, one sweep or sweeps to a fixpoint.
//
// Replaces: src/repro/kernels/multi_jump/multi_jump.py, _multi_jump_kernel
// / multi_jump_pallas (entries ops.multi_jump and ops.full_compress). On
// the TPU a sequential 1-D grid over vertex tiles chases each tile
// ``rounds`` levels against the live workspace, so tile i sees the writes
// of tiles < i and round 2 sees round 1 of its own tile; full_compress
// repeats sweeps until nothing changes, at most 64.
//
// Here ONE block runs every sweep. Per tile and round: each thread reads
// pi[t[j]] for its slots (t in shared memory); barrier; writes the tile
// back; barrier. A sweep changed pi iff some slot's final value differs
// from its value when the tile was loaded (a tile is written only while
// it is processed), which a block-wide OR collects. The sweeps run to a
// fixpoint inside the one launch, so full_compress needs no host round
// trip per sweep. The result is bit-equal to the sequential plain
// version (ref_multi_jump_sweep, repeated).
//
// Bound on this card: device-memory latency. A sweep is V random gathers
// per round, but the tile order is a dependence chain, so one SM walks
// it at one memory round trip per tile and round. Simple and right
// first; a faster form must overlap tiles that do not read each other.
#include <cuda_runtime.h>

namespace {

__global__ void multi_jump_kernel(int* pi, long long num_nodes, int tile,
                                  int rounds, int max_sweeps,
                                  int* __restrict__ sweeps_out) {
  extern __shared__ int sm[];
  int* t = sm;           // [tile] current chase values
  int* old = sm + tile;  // [tile] values when the tile was loaded
  int sweeps = 0;
  while (sweeps < max_sweeps) {
    int changed = 0;
    for (long long start = 0; start < num_nodes; start += tile) {
      for (int j = threadIdx.x; j < tile; j += blockDim.x) {
        const int x = __ldcg(pi + start + j);
        t[j] = x;
        old[j] = x;
      }
      for (int r = 0; r < rounds; ++r) {
        for (int j = threadIdx.x; j < tile; j += blockDim.x)
          t[j] = __ldcg(pi + t[j]);
        __syncthreads();
        for (int j = threadIdx.x; j < tile; j += blockDim.x)
          __stcg(pi + start + j, t[j]);
        __syncthreads();
      }
      for (int j = threadIdx.x; j < tile; j += blockDim.x)
        changed |= (t[j] != old[j]);
    }
    ++sweeps;
    if (!__syncthreads_or(changed)) break;
  }
  if (threadIdx.x == 0) *sweeps_out = sweeps;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs up to ``max_sweeps`` blocked sweeps over ``pi`` (int32 [V], V a
// multiple of ``tile``) in place, stopping after the first sweep that
// changed nothing; writes the sweep count to ``sweeps_out``. Returns the
// CUDA error code.
int multi_jump_sweeps(void* pi, long long num_nodes, int tile, int rounds,
                      int max_sweeps, void* sweeps_out, void* stream) {
  const int threads = tile >= 1024 ? 1024 : ((tile + 31) / 32) * 32;
  const size_t smem = 2 * sizeof(int) * (size_t)tile;
  multi_jump_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pi), num_nodes, tile, rounds, max_sweeps,
      static_cast<int*>(sweeps_out));
  return cudaGetLastError();
}

}  // extern "C"
