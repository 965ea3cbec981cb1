// Edge-tiled hook: gather, bounded root chase, high-low rule and
// scatter-min, over edge tiles in ascending order.
//
// Replaces: src/repro/kernels/hook/hook.py, _hook_kernel / hook_pallas
// (entry ops.hook_edges_pallas). On the TPU the 1-D grid over edge tiles
// runs in order with pi resident in VMEM, so tile t sees the hooks of
// tiles < t while every read inside a tile comes from one snapshot.
//
// Here ONE block walks the tiles in order. Per tile: every thread
// gathers and lifts its slots into shared (hi, lo) pairs; barrier;
// atomicMin(pi[hi], lo); barrier. Slots past the edge count are the
// reference's (0, 0) padding and are hooked as such. The result is
// bit-equal to the sequential-tile plain version (ref_hook_tiled).
//
// Bound on this card: device-memory latency, not bandwidth. The work is
// (2 + 2 * lift_steps) dependent random gathers and one atomic per edge,
// but the tile order is a true dependence chain (tile t reads what tile
// t-1 wrote), so a single SM walks it and each tile costs about
// 2 + lift_steps memory round trips. The design keeps the order exactly
// and spends nothing on making the chain shorter: it is the simple,
// right form; a faster one must overlap tiles whose reads and writes do
// not meet.
#include <cuda_runtime.h>

namespace {

__global__ void hook_tiles_kernel(int* pi, const int* __restrict__ edges,
                                  long long num_edges, long long num_tiles,
                                  int tile, int lift_steps) {
  extern __shared__ int2 hl[];  // [tile] (hi, lo)
  for (long long t = 0; t < num_tiles; ++t) {
    const long long base = t * tile;
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      const long long e = base + j;
      int u = 0, v = 0;
      if (e < num_edges) {
        u = __ldg(edges + 2 * e);
        v = __ldg(edges + 2 * e + 1);
      }
      int pu = __ldcg(pi + u);
      int pv = __ldcg(pi + v);
      for (int k = 0; k < lift_steps; ++k) {
        pu = __ldcg(pi + pu);
        pv = __ldcg(pi + pv);
      }
      hl[j] = make_int2(max(pu, pv), min(pu, pv));
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      atomicMin(pi + hl[j].x, hl[j].y);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hooks ``num_edges`` rows of ``edges`` (int32 [E, 2]) into ``pi`` in
// place, ``tile`` edges per step (the edge list is treated as padded
// with (0, 0) rows to a multiple of ``tile``). Returns the CUDA error.
int hook_tiles(void* pi, const void* edges, long long num_edges, int tile,
               int lift_steps, void* stream) {
  const long long num_tiles = (num_edges + tile - 1) / tile;
  if (num_tiles == 0) return cudaSuccess;
  const int threads = tile >= 1024 ? 1024 : ((tile + 31) / 32) * 32;
  const size_t smem = sizeof(int2) * (size_t)tile;
  hook_tiles_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pi), static_cast<const int*>(edges), num_edges,
      num_tiles, tile, lift_steps);
  return cudaGetLastError();
}

}  // extern "C"
