// Fused Fig. 4 segment scan: every hook round and every compress sweep
// of one segment scan in ONE launch.
//
// Replaces: src/repro/kernels/cc_fused/cc_fused.py, _cc_fused_kernel /
// cc_fused_pallas (entries ops.fused_segment_scan and, with a batch
// axis, ops.fused_segment_scan_batched: the batched engine's scan of one
// shape bucket, which the reference runs as its jnp rounds under vmap).
// On the TPU the grid runs in order over segments and pi stays resident
// in VMEM. Four bodies here:
//   * cc_fused_kernel (one graph): the blocks of one co-resident
//     cooperative grid walk the segments together and meet at grid-wide
//     barriers, with pi in device memory;
//   * cc_fused_forest_kernel: the same walk with the spanning forest
//     recorded as it hooks (the dynamic engine's id-recording scan);
//   * cc_fused_batched_block_kernel (a bucket of graphs whose two pi
//     buffers fit one block's shared memory, V_pad <= 16,384): one block
//     a graph, pi in shared memory, block barriers only;
//   * cc_fused_batched_kernel (larger buckets): the one-graph body with
//     a batch axis, the whole bucket stepping together.
//
// For each segment i, in order:
//   1. every edge slot j < seg: mask slots >= counts[i] to (0, 0), gather
//      pi[u], pi[v], chase lift_steps levels, store (hi, lo) in scratch;
//      grid barrier (all reads come from one pi snapshot);
//   2. atomicMin(pi[hi], lo) for every slot whose lo lies below the live
//      pi[hi]; grid barrier. pi only falls in this phase, so a skipped
//      atomic was a no-op: on power-law graphs most slots of a segment
//      (and of a cleanup round) meet one hub root, and issued, those
//      no-ops serialise on one address;
//   3. Jacobi sweeps while n < fuel: B[v] = A[A[v]] for every vertex,
//      flags[i*fuel + n] = 1 if any entry changed; grid barrier; count the
//      sweep; stop (uniformly) if the flag is clear, else swap A and B;
//   4. sweeps[i] = n.
// This is the reference's snapshot hook and Jacobi sweep, so pi AND the
// per-segment sweep counts are bit-equal to the plain version. Every
// read of data written by another block in this launch goes through
// __ldcg (L2), never a possibly stale L1 line.
//
// Bound on this card: device-memory bytes. A sweep reads pi once
// (coalesced), gathers pi[pi[v]] (random 4-byte reads, a 32-byte sector
// each once pi outgrows the 50 MB L2) and writes pi once; a hook reads
// the segment's edges once and gathers (2 + 2 * lift_steps) random
// entries per edge. Operations are a few integer compares per byte.
// Design against that bound, simple first: grid-stride loops keep every
// SM busy and the sweep's pi reads and writes coalesced; the grid
// barriers replace the host round trip and kernel launch of every step;
// the random gathers are left as they are. The block body's bound and
// design are given above it.
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cc_fused_kernel(const int* __restrict__ segs, const int* __restrict__ counts,
                int* pi_a, int* pi_b, int2* hilo, int* flags,
                int* __restrict__ sweeps, long long num_nodes, int num_segments,
                long long seg, int lift_steps, int fuel) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int* A = pi_a;
  int* B = pi_b;
  for (int i = 0; i < num_segments; ++i) {
    const int cnt = counts[i];
    const int* sp = segs + 2 * seg * (long long)i;
    // 1. gather + root chase from one snapshot of A
    for (long long j = tid; j < seg; j += stride) {
      int u = 0, v = 0;
      if (j < cnt) {
        u = __ldg(sp + 2 * j);
        v = __ldg(sp + 2 * j + 1);
      }
      int pu = __ldcg(A + u);
      int pv = __ldcg(A + v);
      for (int k = 0; k < lift_steps; ++k) {
        pu = __ldcg(A + pu);
        pv = __ldcg(A + pv);
      }
      hilo[j] = make_int2(max(pu, pv), min(pu, pv));
    }
    grid.sync();
    // 2. scatter-min (each thread reads back only its own slots); an
    // atomic whose value is not below the live A[hi] is a no-op, skipped
    for (long long j = tid; j < seg; j += stride) {
      const int2 h = hilo[j];
      if (h.y < __ldcg(A + h.x)) atomicMin(A + h.x, h.y);
    }
    grid.sync();
    // 3. Jacobi pointer doubling to a fixpoint under fuel
    int n = 0;
    while (n < fuel) {
      int changed = 0;
      for (long long v = tid; v < num_nodes; v += stride) {
        const int a = __ldcg(A + v);
        const int b = __ldcg(A + a);
        __stcg(B + v, b);
        changed |= (b != a);
      }
      int* flag = flags + (long long)i * fuel + n;
      if (__syncthreads_or(changed) && threadIdx.x == 0) atomicExch(flag, 1);
      grid.sync();
      ++n;
      if (__ldcg(flag) == 0) break;  // B == A: either buffer holds pi
      int* t = A;
      A = B;
      B = t;
    }
    if (tid == 0) sweeps[i] = n;
  }
  // 4. the result must end in pi_a
  if (A != pi_a) {
    for (long long v = tid; v < num_nodes; v += stride)
      __stcg(pi_a + v, __ldcg(A + v));
  }
}


// The forest variant (entry cc_fused_forest_scan): the id-recording
// segment scan of the dynamic engine (repro_torch.core.rounds
// forest_segment_scan_ids; the reference runs it as jnp rounds under
// lax.scan), which also records the spanning forest. It replaces that
// scan's host loop, a flag read after every Jacobi sweep, where pi and
// its double buffer fit in the L2 (the caller's gate): there a sweep
// costs a few microseconds, and the host's read and relaunch were the
// whole tick. Segment i is rows [i * seg, i * seg + counts[i]) of
// edges [R, 2] and ids [R]; only those rows are hooked. For each
// segment, in order:
//   G. gather from one snapshot of A: (hi, lo) with lift_steps levels
//      of root chase, stored with hi = -1 where lo >= A[hi] (a write
//      that cannot land, and a row that cannot win); in the same phase,
//      record the winners of segment i - 1 (below);
//   H. scatter-min of the live rows, skipping a write whose lo is not
//      below the live label; a block that wrote sets landed[i]; grid
//      barrier. When the last sweep changed nothing, B is a copy of A:
//      the scatter goes into B in G's own phase and B becomes A after
//      the barrier. Otherwise (the first segment, or fuel ran out) a
//      barrier parts G from a scatter into A;
//   S. if nothing landed and the last sweep changed nothing, A is at
//      its fixpoint: the one sweep that the host loop runs would change
//      nothing, so it is billed (sweeps[i] = 1) and not run. Otherwise
//      Jacobi sweeps as in cc_fused_kernel, and in the phase of the
//      first one (A is stable there: the sweeps write B) every live row
//      with A[hi] == lo is a winner and atomicMin(winner[hi], j) keeps
//      the lowest slot.
// Recording segment i in phase G of segment i + 1 (hilo alternates
// between two buffers) saves a barrier a segment: the slot j with
// winner[hi] == j writes parents[hi] = its (u, v) and parent_eidx[hi]
// = its id, then resets winner[hi], which no other slot of the segment
// can take for its own. The last segment records after the loop. The
// winner of a row is the host's (the scatter landed on it and lowered
// the label below the snapshot; the lowest slot of a tie), so pi, the
// tables and sweeps are bit-equal to the host loop.
//
// Bound on this card: with pi L2-resident by the gate, a sweep is a
// coalesced read and write of pi and a gather of pi[pi[v]] in the L2,
// then a grid barrier; a hook is a few hundred rows' gathers. Under
// min-id hooking most vertices point at the few lowest labels (the
// roots of the largest components), so the gather sends every warp to
// the same few L2 lines, and those requests queue on one slice: each
// block copies labels [0, kHot) into shared memory at the start of a
// sweep and gathers them there (on an H100, a kron-logn21 skeleton
// scan of 3,576 sweeps over 2,097,152 vertices: 85 ms without the copy,
// 33 ms with it, at 256 threads a block). Blocks of 1,024 threads, one
// an SM, cut the barrier's arrivals (26 ms). Barriers, one a segment
// and one a sweep, are about 8 ms of it.
__device__ __forceinline__ void forest_record(
    const int* __restrict__ edges, const int* __restrict__ ids,
    const int2* hilo, int* winner, int* parents, int* parent_eidx,
    long long base, int cnt, long long tid, long long stride) {
  for (long long j = tid; j < cnt; j += stride) {
    const int hi = hilo[j].x;
    if (hi < 0 || __ldcg(winner + hi) != (int)j) continue;
    const long long row = base + j;
    __stcg(parents + 2 * (long long)hi, __ldg(edges + 2 * row));
    __stcg(parents + 2 * (long long)hi + 1, __ldg(edges + 2 * row + 1));
    __stcg(parent_eidx + hi, __ldg(ids + row));
    __stcg(winner + hi, INT_MAX);
  }
}

constexpr int kForestThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kHot = 1024;

__global__ void __launch_bounds__(kForestThreads)
cc_fused_forest_kernel(const int* __restrict__ edges,
                       const int* __restrict__ ids,
                       const int* __restrict__ counts, int* pi_a, int* pi_b,
                       int2* hilo, int* winner, int* parents,
                       int* parent_eidx, int* flags, int* landed,
                       int* __restrict__ sweeps, long long num_nodes,
                       int num_segments, long long seg, int lift_steps,
                       int fuel) {
  __shared__ int hot[kHot];
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int hot_n = num_nodes < kHot ? (int)num_nodes : kHot;
  int* A = pi_a;
  int* B = pi_b;
  bool fixed = false;  // the last sweep run changed nothing: B == A
  for (int i = 0; i < num_segments; ++i) {
    const int cnt = counts[i];
    const long long base = seg * i;
    int2* h = hilo + (i & 1) * seg;
    // G. gather from the snapshot A; record segment i - 1
    if (i > 0)
      forest_record(edges, ids, hilo + ((i - 1) & 1) * seg, winner, parents,
                    parent_eidx, base - seg, counts[i - 1], tid, stride);
    for (long long j = tid; j < cnt; j += stride) {
      int pu = __ldcg(A + __ldg(edges + 2 * (base + j)));
      int pv = __ldcg(A + __ldg(edges + 2 * (base + j) + 1));
      for (int k = 0; k < lift_steps; ++k) {
        pu = __ldcg(A + pu);
        pv = __ldcg(A + pv);
      }
      const int hi = max(pu, pv), lo = min(pu, pv);
      h[j] = make_int2(lo < __ldcg(A + hi) ? hi : -1, lo);
    }
    // H. scatter-min of the live rows, no-op writes skipped: into B, the
    // copy of the snapshot, in the same phase; else into A after a
    // barrier
    int* P = fixed ? B : A;
    if (!fixed) grid.sync();
    int wrote = 0;
    for (long long j = tid; j < cnt; j += stride) {
      const int2 r = h[j];
      if (r.x >= 0 && r.y < __ldcg(P + r.x)) {
        atomicMin(P + r.x, r.y);
        wrote = 1;
      }
    }
    if (__syncthreads_or(wrote) && threadIdx.x == 0) atomicExch(landed + i, 1);
    grid.sync();
    B = P == B ? A : B;
    A = P;
    // S. sweeps, the winners marked in the first one's phase
    if (fixed && __ldcg(landed + i) == 0) {
      if (tid == 0) sweeps[i] = 1;
      continue;
    }
    for (long long j = tid; j < cnt; j += stride) {
      const int2 r = h[j];
      if (r.x >= 0 && __ldcg(A + r.x) == r.y) atomicMin(winner + r.x, (int)j);
    }
    int n = 0;
    fixed = false;
    while (n < fuel) {
      // the lowest labels, the roots of the largest components under
      // min-id hooking, from shared memory: a gather of the same entry
      // by every warp would queue on one L2 slice
      for (int k = threadIdx.x; k < hot_n; k += blockDim.x)
        hot[k] = __ldcg(A + k);
      __syncthreads();
      // kUnroll vertices a thread in flight: their loads of A[v], then
      // of A[A[v]], then the stores (a store is a compiler barrier)
      int changed = 0;
      for (long long v0 = tid; v0 < num_nodes; v0 += kUnroll * stride) {
        int a[kUnroll], b[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long v = v0 + k * stride;
          a[k] = v < num_nodes ? __ldcg(A + v) : 0;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          b[k] = a[k] < hot_n ? hot[a[k]] : __ldcg(A + a[k]);
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long v = v0 + k * stride;
          if (v < num_nodes) {
            __stcg(B + v, b[k]);
            changed |= (b[k] != a[k]);
          }
        }
      }
      int* flag = flags + (long long)i * fuel + n;
      if (__syncthreads_or(changed) && threadIdx.x == 0) atomicExch(flag, 1);
      grid.sync();
      ++n;
      if (__ldcg(flag) == 0) {
        fixed = true;
        break;  // B == A: either buffer holds pi
      }
      int* t = A;
      A = B;
      B = t;
    }
    if (tid == 0) sweeps[i] = n;
  }
  // the last segment's winners, and the result into pi_a (the phase
  // before ended on a barrier)
  if (num_segments > 0)
    forest_record(edges, ids, hilo + ((num_segments - 1) & 1) * seg, winner,
                  parents, parent_eidx, seg * (num_segments - 1),
                  counts[num_segments - 1], tid, stride);
  if (A != pi_a) {
    for (long long v = tid; v < num_nodes; v += stride)
      __stcg(pi_a + v, __ldcg(A + v));
  }
}


// The batch axis (repro.core.batch runs one bucket of B same-shape graphs
// as one vmapped program), for the buckets whose pi does not fit one
// block (V_pad > 16,384): B graphs of V_pad = 2^log2_vp vertices each,
// pi [B * V_pad] with graph g at offset g * V_pad holding LOCAL ids,
// segments [B, S, seg, 2] in local ids, counts [B, S]. Each step above
// runs over all B graphs at once: the hooks over B * seg slots, the
// sweeps over B * V_pad entries, one grid barrier each for the whole
// bucket. The stop is uniform (a sweep runs while ANY graph changed),
// the billing per graph: a sweep that changes graph g sets g's flag
// (flags [S, fuel, B]; one atomic per (warp, graph): a warp ballot
// masked to the lanes of one graph, which are all 32 when V_pad >= 32,
// else aligned groups of V_pad), and sweeps[g, i] is 1 + the index of
// g's first sweep with no change, or the sweeps run when it has none
// (fuel). A graph at its fixpoint is not moved by the sweeps it waits
// through, so pi and sweeps equal the plain version run graph by graph,
// as the vmapped while_loop of the reference bills each graph alone.
// B * V_pad and B * seg are below 2^31 (the wrapper checks).
__global__ void __launch_bounds__(kThreads)
cc_fused_batched_kernel(const int* __restrict__ segs,
                        const int* __restrict__ counts, int* pi_a, int* pi_b,
                        int2* hilo, int* flags, int* any_flags,
                        int* __restrict__ sweeps, int batch, int log2_vp,
                        int num_segments, int seg, int lift_steps, int fuel) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int vp = 1 << log2_vp;
  const int total = batch << log2_vp;
  const long long slots = (long long)batch * seg;
  // this lane's graph-mates in the warp, and whether it leads them
  const unsigned group =
      vp >= 32 ? 0xffffffffu : ((1u << vp) - 1u) << (lane & ~(vp - 1));
  const bool leader = lane == (vp >= 32 ? 0 : (lane & ~(vp - 1)));
  int* A = pi_a;
  int* B = pi_b;
  for (int i = 0; i < num_segments; ++i) {
    // 1. gather + root chase, each graph from one snapshot of its pi
    for (long long j = tid; j < slots; j += stride) {
      const int g = (int)(j / seg);
      const int k = (int)(j - (long long)g * seg);
      const long long row = (long long)g * num_segments + i;
      int u = 0, v = 0;
      if (k < __ldg(counts + row)) {
        const int* sp = segs + 2 * (row * seg + k);
        u = __ldg(sp);
        v = __ldg(sp + 1);
      }
      const int base = g << log2_vp;
      int pu = __ldcg(A + base + u);
      int pv = __ldcg(A + base + v);
      for (int s = 0; s < lift_steps; ++s) {
        pu = __ldcg(A + base + pu);
        pv = __ldcg(A + base + pv);
      }
      hilo[j] = make_int2(base + max(pu, pv), min(pu, pv));
    }
    grid.sync();
    // 2. scatter-min, no-op atomics skipped
    for (long long j = tid; j < slots; j += stride) {
      const int2 h = hilo[j];
      if (h.y < __ldcg(A + h.x)) atomicMin(A + h.x, h.y);
    }
    grid.sync();
    // 3. Jacobi sweeps over the whole bucket while any graph changed
    int* gflags = flags + (long long)i * fuel * batch;
    int n = 0;
    while (n < fuel) {
      int changed_any = 0;
      // warp-uniform trip count, so the ballot sees every lane
      for (long long w = tid - lane; w < total; w += stride) {
        const int v = (int)w + lane;
        int changed = 0;
        if (v < total) {
          const int a = __ldcg(A + v);
          const int b = __ldcg(A + ((v >> log2_vp) << log2_vp) + a);
          __stcg(B + v, b);
          changed = b != a;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, changed) & group;
        if (hit && leader)
          atomicExch(gflags + (long long)n * batch + (v >> log2_vp), 1);
        changed_any |= changed;
      }
      int* any = any_flags + (long long)i * fuel + n;
      if (__syncthreads_or(changed_any) && threadIdx.x == 0)
        atomicExch(any, 1);
      grid.sync();
      ++n;
      if (__ldcg(any) == 0) break;  // B == A: either buffer holds pi
      int* t = A;
      A = B;
      B = t;
    }
    // 4. per-graph sweeps: 1 + the first sweep that left g unchanged
    for (long long g = tid; g < batch; g += stride) {
      int s = n;
      for (int k = 0; k < n; ++k) {
        if (__ldcg(gflags + (long long)k * batch + g) == 0) {
          s = k + 1;
          break;
        }
      }
      sweeps[g * num_segments + i] = s;
    }
  }
  if (A != pi_a) {
    for (long long v = tid; v < total; v += stride)
      __stcg(pi_a + v, __ldcg(A + v));
  }
}


// One graph a block, pi in shared memory (the bucket's graphs need no
// barrier across blocks: each owns its pi, its segments and its sweeps).
// Bound on this card, per launch: each true edge read once (8 B) and
// each graph's pi read and written once (8 B a vertex); the sweeps and
// the hooks' gathers and atomics stay in shared memory. Block b loads
// graph b's pi into buffer ``cur``; then for each segment i:
//   1. hook: copy cur to nxt; every slot j < counts[b, i] gathers pi[u],
//      pi[v] and their lift_steps ancestors from cur (the snapshot) and
//      takes atomicMin(nxt[hi], lo), skipped where lo is not below the
//      live nxt[hi]; the masked slots are all the edge (0, 0), so one
//      thread hooks it once for all of them; barrier; nxt is pi now;
//   2. Jacobi sweeps while n < fuel: nxt[v] = cur[cur[v]] (the roles
//      swapped after each), the change flag from __syncthreads_or; the
//      block stops when its own graph stops changing;
//   3. sweeps[b, i] = n, the last sweep (the one that changed nothing)
//      counted, as the plain version counts it.
// pi is written back once. The snapshot and the live buffer are apart,
// so the hook is the reference's; a sweep reads one buffer and writes
// the other, the reference's Jacobi step; and a graph stops when it
// alone has stopped, as the reference's vmapped while_loop bills it: pi
// and sweeps are bit-equal to the plain version. Edges are read with
// four slots a thread in flight before their gathers. A block has
// V_pad / 8 threads, at least a warp and at most 1,024.
__global__ void __launch_bounds__(1024)
cc_fused_batched_block_kernel(const int* __restrict__ segs,
                              const int* __restrict__ counts,
                              const int* __restrict__ pi_in,
                              int* __restrict__ pi_out,
                              int* __restrict__ sweeps, int log2_vp,
                              int num_segments, int seg, int lift_steps,
                              int fuel) {
  extern __shared__ int smem[];
  const int vp = 1 << log2_vp;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const long long base = (long long)blockIdx.x << log2_vp;
  int* cur = smem;
  int* nxt = smem + vp;
  // each thread copies, sweeps and writes back the same vertices, so no
  // barrier is needed before the first copy
  for (int v = t; v < vp; v += nt) cur[v] = __ldg(pi_in + base + v);
  for (int i = 0; i < num_segments; ++i) {
    const long long row = (long long)blockIdx.x * num_segments + i;
    const int cnt = min(max(__ldg(counts + row), 0), seg);
    const int* sp = segs + 2 * row * seg;
    // 1. hook from the snapshot cur into nxt
    for (int v = t; v < vp; v += nt) nxt[v] = cur[v];
    __syncthreads();
    if (cnt < seg && t == 0) {
      int p = cur[0];
      for (int s = 0; s < lift_steps; ++s) p = cur[p];
      atomicMin(nxt + p, p);
    }
    for (int j0 = t; j0 < cnt; j0 += 4 * nt) {
      int eu[4], ev[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k * nt;
        eu[k] = ev[k] = 0;
        if (j < cnt) {
          eu[k] = __ldg(sp + 2 * j);
          ev[k] = __ldg(sp + 2 * j + 1);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k * nt >= cnt) break;
        int pu = cur[eu[k]];
        int pv = cur[ev[k]];
        for (int s = 0; s < lift_steps; ++s) {
          pu = cur[pu];
          pv = cur[pv];
        }
        const int hi = max(pu, pv), lo = min(pu, pv);
        if (lo < nxt[hi]) atomicMin(nxt + hi, lo);
      }
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    // 2. Jacobi sweeps to this graph's fixpoint under fuel
    int n = 0;
    while (n < fuel) {
      int changed = 0;
      for (int v = t; v < vp; v += nt) {
        const int a = cur[v];
        const int b = cur[a];
        nxt[v] = b;
        changed |= b != a;
      }
      ++n;
      const int any = __syncthreads_or(changed);
      tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!any) break;  // both buffers hold pi
    }
    // 3. bill the segment
    if (t == 0) sweeps[row] = n;
  }
  // the last hook or sweep ended in a barrier
  for (int v = t; v < vp; v += nt) pi_out[base + v] = cur[v];
}

constexpr int kBlockMaxLog2Vp = 14;  // 2 x 4 B x 16,384 = 128 KB

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pi_a holds the input pi on entry and the result on exit; pi_b is [V]
// scratch, hilo [seg] int2 scratch, flags [S * fuel] zeroed ints,
// sweeps [S] output. Launches on ``stream``; returns the CUDA error code.
int cc_fused_scan(const void* segs, const void* counts, void* pi_a,
                  void* pi_b, void* hilo, void* flags, void* sweeps,
                  long long num_nodes, int num_segments, long long seg,
                  int lift_steps, int fuel, void* stream) {
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
      &per_sm, cc_fused_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // never more blocks than the work needs, never more than co-resident
  const long long items = seg > num_nodes ? seg : num_nodes;
  long long want = (items + kThreads - 1) / kThreads;
  long long blocks = (long long)per_sm * sms;
  if (want < blocks) blocks = want < 1 ? 1 : want;

  const int* a_segs = static_cast<const int*>(segs);
  const int* a_counts = static_cast<const int*>(counts);
  int* a_pi = static_cast<int*>(pi_a);
  int* a_pib = static_cast<int*>(pi_b);
  int2* a_hilo = static_cast<int2*>(hilo);
  int* a_flags = static_cast<int*>(flags);
  int* a_sweeps = static_cast<int*>(sweeps);
  void* args[] = {&a_segs, &a_counts, &a_pi, &a_pib, &a_hilo, &a_flags,
                  &a_sweeps, &num_nodes, &num_segments, &seg, &lift_steps,
                  &fuel};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_fused_kernel), dim3((unsigned)blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The forest body: edges [R, 2] and ids [R] (segment i is rows i * seg
// to i * seg + counts[i]), counts [S]; pi_a holds the input pi on entry
// and the result on exit; pi_b is [V] scratch, hilo [2 * seg] int2
// scratch, winner [V] ints all INT_MAX (left so), flags [S * fuel] and
// landed [S] zeroed ints; parents [V, 2] and parent_eidx [V] take the
// recorded rows in place; sweeps [S] output. Launch rules as
// cc_fused_scan's.
int cc_fused_forest_scan(const void* edges, const void* ids,
                         const void* counts, void* pi_a, void* pi_b,
                         void* hilo, void* winner, void* parents,
                         void* parent_eidx, void* flags, void* landed,
                         void* sweeps, long long num_nodes, int num_segments,
                         long long seg, int lift_steps, int fuel,
                         void* stream) {
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
      &per_sm, cc_fused_forest_kernel, kForestThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long items = seg > num_nodes ? seg : num_nodes;
  long long want = (items + kForestThreads - 1) / kForestThreads;
  long long blocks = (long long)per_sm * sms;
  if (want < blocks) blocks = want < 1 ? 1 : want;

  const int* a_edges = static_cast<const int*>(edges);
  const int* a_ids = static_cast<const int*>(ids);
  const int* a_counts = static_cast<const int*>(counts);
  int* a_pi = static_cast<int*>(pi_a);
  int* a_pib = static_cast<int*>(pi_b);
  int2* a_hilo = static_cast<int2*>(hilo);
  int* a_winner = static_cast<int*>(winner);
  int* a_parents = static_cast<int*>(parents);
  int* a_eidx = static_cast<int*>(parent_eidx);
  int* a_flags = static_cast<int*>(flags);
  int* a_landed = static_cast<int*>(landed);
  int* a_sweeps = static_cast<int*>(sweeps);
  void* args[] = {&a_edges, &a_ids,    &a_counts, &a_pi,       &a_pib,
                  &a_hilo,  &a_winner, &a_parents, &a_eidx,    &a_flags,
                  &a_landed, &a_sweeps, &num_nodes, &num_segments, &seg,
                  &lift_steps, &fuel};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_fused_forest_kernel),
      dim3((unsigned)blocks), dim3(kForestThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The batched entry of the block body (log2_vp <= 14): pi_in [B *
// 2^log2_vp] the bucket's pi (local ids, not modified), pi_out the
// result, segs [B, S, seg, 2], counts [B, S], sweeps [B, S] output (every
// entry written). One block a graph; launches on ``stream`` and returns
// the CUDA error code.
int cc_fused_scan_batched_block(const void* segs, const void* counts,
                                const void* pi_in, void* pi_out,
                                void* sweeps, int batch, int log2_vp,
                                int num_segments, int seg, int lift_steps,
                                int fuel, void* stream) {
  if (log2_vp < 0 || log2_vp > kBlockMaxLog2Vp) return cudaErrorInvalidValue;
  const int vp = 1 << log2_vp;
  const int threads = vp / 8 < 32 ? 32 : vp / 8 > 1024 ? 1024 : vp / 8;
  const size_t smem = 2 * sizeof(int) * (size_t)vp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cc_fused_batched_block_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cc_fused_batched_block_kernel<<<batch, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(segs), static_cast<const int*>(counts),
      static_cast<const int*>(pi_in), static_cast<int*>(pi_out),
      static_cast<int*>(sweeps), log2_vp, num_segments, seg, lift_steps,
      fuel);
  return cudaGetLastError();
}

// The batched entry of the grid body: pi_a [B * 2^log2_vp] holds the
// bucket's pi (local ids) on entry and the result on exit; pi_b is
// scratch of the same size, hilo [B * seg] int2 scratch, flags [S * fuel
// * B] and any_flags [S * fuel] zeroed ints, sweeps [B, S] output. Same launch rules as
// cc_fused_scan, the grid sized from max(B * seg, B * V_pad).
int cc_fused_scan_batched(const void* segs, const void* counts, void* pi_a,
                          void* pi_b, void* hilo, void* flags,
                          void* any_flags, void* sweeps, int batch,
                          int log2_vp, int num_segments, int seg,
                          int lift_steps, int fuel, void* stream) {
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
      &per_sm, cc_fused_batched_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long slots = (long long)batch * seg;
  const long long total = (long long)batch << log2_vp;
  const long long items = slots > total ? slots : total;
  long long want = (items + kThreads - 1) / kThreads;
  long long blocks = (long long)per_sm * sms;
  if (want < blocks) blocks = want < 1 ? 1 : want;

  const int* a_segs = static_cast<const int*>(segs);
  const int* a_counts = static_cast<const int*>(counts);
  int* a_pi = static_cast<int*>(pi_a);
  int* a_pib = static_cast<int*>(pi_b);
  int2* a_hilo = static_cast<int2*>(hilo);
  int* a_flags = static_cast<int*>(flags);
  int* a_any = static_cast<int*>(any_flags);
  int* a_sweeps = static_cast<int*>(sweeps);
  void* args[] = {&a_segs, &a_counts, &a_pi, &a_pib, &a_hilo, &a_flags,
                  &a_any, &a_sweeps, &batch, &log2_vp, &num_segments, &seg,
                  &lift_steps, &fuel};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_fused_batched_kernel),
      dim3((unsigned)blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
