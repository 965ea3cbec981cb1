// Multi-Jump compress: two bodies in one library.
//
// Replaces: src/repro/kernels/multi_jump/multi_jump.py, _multi_jump_kernel
// / multi_jump_pallas (entries ops.multi_jump and ops.full_compress). On
// the TPU a sequential 1-D grid over vertex tiles chases each tile
// ``rounds`` levels against the live workspace, so tile i sees the writes
// of tiles < i and round 2 sees round 1 of its own tile; full_compress
// repeats sweeps until nothing changes, at most 64.
//
// 1. multi_jump_kernel (entry multi_jump_sweeps; ops.multi_jump, one
//    sweep, and ops.sequential_sweeps): ONE block runs the sweeps in the
//    TPU's order. Per tile and round: each thread reads pi[t[j]] for its
//    slots (t in shared memory); barrier; writes the tile back; barrier.
//    A sweep changed pi iff some slot's final value differs from its
//    value when the tile was loaded, which a block-wide OR collects. The
//    result is bit-equal to the sequential plain version
//    (ref_multi_jump_sweep, repeated). Bound: device-memory latency, one
//    SM walking a dependence chain at one round trip per tile and round.
//
// 2. compress_roots_kernel (entry compress_roots; ops.full_compress): the
//    fixpoint, on every SM. full_compress only needs the fixpoint, every
//    vertex pointing at its root, and on a forest that does not depend on
//    the order of the work, and the sequential sweeps reach it well inside
//    their 64-sweep cap: pointers only move up, so each of a sweep's two
//    rounds moves a pointer at least as far as its target's pointer
//    reached at the sweep's start, and a sweep at least triples the least
//    distance to the root; a tree of depth d < 2^31 is flat after
//    ceil(log3 d) <= 20 sweeps, and the next one changes nothing. (Hooks
//    write pi[hi] = lo with lo <= hi and pi starts as arange, so the main
//    path's pi is always a forest.)
//    One cooperative launch over all SMs; a grid-stride loop hands each
//    thread four vertices at a time (one 16-byte load of their pi) and
//    chases the four side by side, so four dependent load chains are in
//    flight per thread. Rounds, each ended by a grid barrier:
//      each vertex v: x = pi[v]; up to S times: q = pi[x]; stop if q == x
//      (x is a root), else x = q; then pi[v] = x (only v's thread
//      writes pi[v]); v stays OPEN if no root was seen.
//    S is 64 in the first round and 2 after it. The launch ends after the
//    first round that leaves no vertex open, and after 32 rounds at most.
//    Why this is exact on every forest: every value stored is an ancestor
//    of v, and a root r keeps pi[r] = r (its thread sees q == r at once),
//    so when no vertex is open every pi[v] is v's root: the fixpoint that
//    ref_full_compress returns. Why it ends: a pointer only moves up and
//    each round's first step reads live values at least as far up as
//    pi[pi[v]] at the round's start, so round k leaves every pointer at
//    least min(2^k, its depth) levels up; every vertex of a forest of
//    depth < 2^31 sees its root by round 31, and round 32 is the cap for
//    any other int32 input (a cycle): at most 1 + 64 + 31 * 3 = 158 loads
//    a vertex, less than the 64 * 3 of 64 sequential sweeps, so a corrupt
//    pi returns instead of hanging the card.
//    Whether a vertex is still open is ORed per block and raised into a
//    round-tagged flag with atomicMax; the flag word is zeroed by the
//    caller. The tag only grows, so a block that reads it late, after
//    faster blocks raised the next round's tag, still reads one >= its
//    round, as it must: they went on because this round left a vertex
//    open. Bound: device-memory bytes: one coalesced read of pi, one
//    gather of pi[pi[v]] (a 32-byte sector once pi outgrows the 50 MB L2)
//    and one write of pi per round; on the main path pi[v] <= v sends a
//    chase to lower ids, whose threads mostly ran before, so chases are
//    short.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void multi_jump_kernel(int* pi, long long num_nodes, int tile,
                                  int rounds, int max_sweeps) {
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
}

constexpr int kRootThreads = 256;
constexpr int kFirstSteps = 64;  // chase steps of a vertex in round 1
constexpr int kSteps = 2;        // ... in every later round
constexpr int kMaxRounds = 32;

// Chases the vertices x[j] of ``open`` (a bit per j) side by side for at
// most ``steps`` steps, leaving in x[j] where each chase stopped. Returns
// the bits of the chases that saw no root.
__device__ __forceinline__ int chase4(const int* pi, int (&x)[4], int open,
                                      int steps) {
  for (int s = 0; s < steps && open; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (open & (1 << j)) {
        const int q = __ldcg(pi + x[j]);
        if (q == x[j])
          open &= ~(1 << j);
        else
          x[j] = q;
      }
    }
  }
  return open;
}

__global__ void __launch_bounds__(kRootThreads)
compress_roots_kernel(int* pi, long long num_nodes, int* flag) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long quads = num_nodes / 4;
  int4* pi4 = reinterpret_cast<int4*>(pi);
  for (int round = 1;; ++round) {
    const int steps = round == 1 ? kFirstSteps : kSteps;
    int open = 0;
    for (long long g = tid; g < quads; g += stride) {
      const int4 p = __ldcg(pi4 + g);
      int x[4] = {p.x, p.y, p.z, p.w};
      open |= chase4(pi, x, 0xf, steps);
      if (x[0] != p.x || x[1] != p.y || x[2] != p.z || x[3] != p.w)
        __stcg(pi4 + g, make_int4(x[0], x[1], x[2], x[3]));
    }
    // the last num_nodes % 4 vertices, one per thread of the first block
    const long long v = quads * 4 + tid;
    if (v < num_nodes) {
      const int p = __ldcg(pi + v);
      int x[4] = {p, 0, 0, 0};
      open |= chase4(pi, x, 1, steps);
      if (x[0] != p) __stcg(pi + v, x[0]);
    }
    if (round == kMaxRounds) break;
    if (__syncthreads_or(open) && threadIdx.x == 0) atomicMax(flag, round);
    grid.sync();
    if (__ldcg(flag) < round) break;  // uniform: no vertex is open
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs up to ``max_sweeps`` blocked sweeps over ``pi`` (int32 [V], V a
// multiple of ``tile``) in place, stopping after the first sweep that
// changed nothing. Returns the CUDA error code.
int multi_jump_sweeps(void* pi, long long num_nodes, int tile, int rounds,
                      int max_sweeps, void* stream) {
  const int threads = tile >= 1024 ? 1024 : ((tile + 31) / 32) * 32;
  const size_t smem = 2 * sizeof(int) * (size_t)tile;
  multi_jump_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pi), num_nodes, tile, rounds, max_sweeps);
  return cudaGetLastError();
}

// Compresses ``pi`` (int32 [V]) in place to the fixpoint where every
// vertex points at its root, in one cooperative launch of
// compress_roots_kernel; ``flag`` is one int32 that must be 0 on entry.
// Returns the CUDA error code.
int compress_roots(void* pi, long long num_nodes, void* flag, void* stream) {
  if (num_nodes == 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, compress_roots_kernel, kRootThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // never more blocks than the quads need, never more than co-resident
  const long long want = (num_nodes / 4 + kRootThreads - 1) / kRootThreads;
  long long blocks = (long long)per_sm * sms;
  if (want < blocks) blocks = want < 1 ? 1 : want;
  int* a_pi = static_cast<int*>(pi);
  int* a_flag = static_cast<int*>(flag);
  void* args[] = {&a_pi, &num_nodes, &a_flag};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(compress_roots_kernel), dim3((unsigned)blocks),
      dim3(kRootThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
