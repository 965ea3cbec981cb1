// Segment reduce: sum / min / max of the [n, dim] rows of ``data`` into
// [num_segments, dim] by int32 segment ids; a segment no row reaches
// holds the identity (0, +inf, -inf).
//
// Replaces: src/repro/kernels/segment_reduce/segment_reduce.py,
// _segment_reduce_kernel / segment_reduce_pallas (entry
// ops.segment_reduce). On the TPU a sequential 1-D grid walks tiles of
// rows and carries the whole [S, D] accumulator in VMEM from step to
// step, initialised at step 0 with ``reduce_identity``. Blocks here run
// in no order and share nothing, so the accumulator is an fp32 scratch
// in device memory and every row element meets it through an atomic.
//
// One call of the entry point runs three kernels on the caller's stream:
//   1. fill the scratch with the identity;
//   2. one thread per data element: atomicAdd (sum), or the ordered-int
//      atomics (min / max): a float with its sign bit clear orders like
//      its bits as a signed int, one with it set (-0 included) inversely
//      to its bits as an unsigned int, so signed atomicMin/atomicMax for
//      the first and unsigned atomicMax/atomicMin for the second give
//      the float min / max without a compare-and-swap loop;
//   3. cast the scratch to the data dtype (skipped for float32 data,
//      whose output IS the scratch).
// Min and max are exact, so their result is bit-equal to any order of
// evaluation; sums land in an order that changes from run to run.
// A row whose id lies outside [0, num_segments) is dropped, as
// jax.ops.segment_* drops it.
//
// Bound on this card: bytes. The kernel must read the data and the ids
// once and write the output once; one add or compare per element is far
// below the card's rate. Neighbouring threads read neighbouring elements
// of a row, so the reads are coalesced; the atomics of one row go to one
// contiguous output row, and rows of one segment (sorted ids, as the
// embedding bag gives them) hit the same L2 lines, where the atomics
// resolve without a trip to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0)  // sign bit clear: +0 and above
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0)  // sign bit clear: +0 and above
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void fill_kernel(float* __restrict__ acc, long long n,
                            float value) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) acc[i] = value;
}

template <typename T, int OP>
__global__ void scatter_kernel(const T* __restrict__ data,
                               const int* __restrict__ ids,
                               float* __restrict__ acc, long long n, int dim,
                               long long num_segments) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * dim) return;
  const long long row = t / dim;
  const long long col = t - row * dim;
  const long long seg = __ldg(ids + row);
  if (seg < 0 || seg >= num_segments) return;
  const float v = to_f32(data[t]);
  float* dst = acc + seg * dim + col;
  if (OP == kSum)
    atomicAdd(dst, v);
  else if (OP == kMin)
    atomic_min_f32(dst, v);
  else
    atomic_max_f32(dst, v);
}

__global__ void cast_kernel(const float* __restrict__ acc,
                            __nv_bfloat16* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(acc[i]);
}

constexpr int kBlock = 256;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kBlock - 1) / kBlock);
}

template <typename T>
cudaError_t scatter(const void* data, const void* ids, float* acc,
                    long long n, int dim, long long num_segments, int op,
                    cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const int* i = static_cast<const int*>(ids);
  const unsigned grid = blocks_for(n * dim);
  if (op == kSum)
    scatter_kernel<T, kSum><<<grid, kBlock, 0, s>>>(d, i, acc, n, dim,
                                                    num_segments);
  else if (op == kMin)
    scatter_kernel<T, kMin><<<grid, kBlock, 0, s>>>(d, i, acc, n, dim,
                                                    num_segments);
  else
    scatter_kernel<T, kMax><<<grid, kBlock, 0, s>>>(d, i, acc, n, dim,
                                                    num_segments);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Reduces ``data`` ([n, dim], ``dtype`` 0 float32 / 1 bfloat16) by
// ``ids`` (int32 [n]) into ``out`` ([num_segments, dim], the data
// dtype) through ``acc`` (float32 [num_segments, dim]; pass out as acc
// for float32 data). ``op``: 0 sum, 1 min, 2 max. Returns the CUDA error
// of the first launch that failed.
int segment_reduce(const void* data, const void* ids, void* acc, void* out,
                   long long n, int dim, long long num_segments, int dtype,
                   int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long size = num_segments * dim;
  if (size == 0) return cudaSuccess;
  float* a = static_cast<float*>(acc);
  const float identity = op == kSum ? 0.f : (op == kMin ? INFINITY
                                                         : -INFINITY);
  fill_kernel<<<blocks_for(size), kBlock, 0, s>>>(a, size, identity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    err = dtype == 0
              ? scatter<float>(data, ids, a, n, dim, num_segments, op, s)
              : scatter<__nv_bfloat16>(data, ids, a, n, dim, num_segments,
                                       op, s);
    if (err != cudaSuccess) return err;
  }
  if (acc != out) {
    cast_kernel<<<blocks_for(size), kBlock, 0, s>>>(
        a, static_cast<__nv_bfloat16*>(out), size);
    err = cudaGetLastError();
  }
  return err;
}

}  // extern "C"
