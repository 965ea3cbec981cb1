// Hook: gather, bounded root chase, high-low rule and scatter-min.
//
// Replaces: src/repro/kernels/hook/hook.py, _hook_kernel / hook_pallas.
// On the TPU the 1-D grid over edge tiles runs in order with pi resident
// in VMEM, so tile t sees the hooks of tiles < t while every read inside
// a tile comes from one snapshot. Two bodies:
//
// hook_tiles (entry ops.hook_edges_pallas): the TPU kernel's tile order,
// bit-equal to the sequential-tile plain version (ref_hook_tiled). ONE
// block walks the tiles in order. Per tile: every thread gathers and
// lifts its slots into shared (hi, lo) pairs; barrier; atomicMin(pi[hi],
// lo) where lo < pi[hi]; barrier. Slots past the edge count are the
// reference's (0, 0) padding and are hooked as such. The tile order is a
// true dependence chain (tile t reads what tile t-1 wrote), so one SM
// walks it and each tile costs about 2 + lift_steps memory round trips:
// device-memory latency, not bandwidth, bounds it.
//
// hook_snapshot (entry ops.hook_edges_snapshot): the TPU kernel at ONE
// tile over the whole edge list, i.e. every edge reads the same snapshot
// (ref_hook_round, the torch-ops hook_edges). That form has no order to
// keep: a grid-stride loop on every SM gathers and lifts from the
// untouched input pi (read-only in the launch, so __ldg) and applies
// atomicMin(out[hi], lo) to the wrapper's clone. min is order-free, so
// the result is deterministic and bit-equal to hook_edges.
//
// Both bodies skip an atomicMin whose value is not below the live
// out[hi] (read through L2): pi only falls while hooking, so such an
// atomic changes nothing. On power-law graphs most hooks of a segment
// land on one hub root and are such no-ops; issued, they would serialise
// on one address.
//
// Bound on this card: device-memory bytes for the snapshot body. Each
// edge is read once (8 bytes) and makes 2 + 2 * lift_steps random 4-byte
// gathers (a 32-byte sector each once pi outgrows the 50 MB L2) and at
// most one atomic; pi is read and the result written once.
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
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      const int2 h = hl[j];
      if (h.y < __ldcg(pi + h.x)) atomicMin(pi + h.x, h.y);
    }
    __syncthreads();
  }
}

constexpr int kSnapshotThreads = 256;

__global__ void __launch_bounds__(kSnapshotThreads)
hook_snapshot_kernel(const int* __restrict__ pi, int* out,
                     const int* __restrict__ edges, long long num_edges,
                     int lift_steps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < num_edges; e += stride) {
    int pu = __ldg(pi + __ldg(edges + 2 * e));
    int pv = __ldg(pi + __ldg(edges + 2 * e + 1));
    for (int k = 0; k < lift_steps; ++k) {
      pu = __ldg(pi + pu);
      pv = __ldg(pi + pv);
    }
    const int hi = max(pu, pv);
    const int lo = min(pu, pv);
    if (lo < __ldcg(out + hi)) atomicMin(out + hi, lo);
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

// Hooks ``num_edges`` rows of ``edges`` (int32 [E, 2]) into ``out``, all
// from the one snapshot ``pi`` (not written); ``out`` holds a copy of
// ``pi`` on entry. Returns the CUDA error.
int hook_snapshot(const void* pi, void* out, const void* edges,
                  long long num_edges, int lift_steps, void* stream) {
  if (num_edges == 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hook_snapshot_kernel, kSnapshotThreads, 0);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM, never more than the edges need
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long want = (num_edges + kSnapshotThreads - 1) /
                         kSnapshotThreads;
  if (want < blocks) blocks = want;
  hook_snapshot_kernel<<<(unsigned)blocks, kSnapshotThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pi), static_cast<int*>(out),
      static_cast<const int*>(edges), num_edges, lift_steps);
  return cudaGetLastError();
}

}  // extern "C"
