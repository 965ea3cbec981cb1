// Fused Fig. 4 segment scan: every hook round and every compress sweep
// of one segment scan in ONE persistent cooperative launch.
//
// Replaces: src/repro/kernels/cc_fused/cc_fused.py, _cc_fused_kernel /
// cc_fused_pallas (entry ops.fused_segment_scan). On the TPU the grid
// runs in order over segments and pi stays resident in VMEM; here the
// blocks of one co-resident grid walk the segments together and meet at
// grid-wide barriers, with pi in device memory.
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
// the random gathers are left as they are.
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

}  // extern "C"
