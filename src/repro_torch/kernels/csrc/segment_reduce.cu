// Segment reduce: sum / min / max of the [n, dim] rows of ``data`` into
// [num_segments, dim] by int32 segment ids; a segment no row reaches
// holds the identity (0, +inf, -inf). A row whose id lies outside
// [0, num_segments) is dropped, as jax.ops.segment_* drops it.
//
// Replaces: src/repro/kernels/segment_reduce/segment_reduce.py,
// _segment_reduce_kernel / segment_reduce_pallas (entry
// ops.segment_reduce). On the TPU a sequential 1-D grid walks tiles of
// rows and carries the whole [S, D] accumulator in VMEM from step to
// step, initialised at step 0 with ``reduce_identity``. Blocks here run
// in no order and share nothing, so two bodies take its place, picked by
// the caller's ``indices_are_sorted`` (jax.ops.segment_sum's argument of
// that name, with its contract: the ids are ascending):
//
// 1. sorted ids, entry segment_reduce_sorted: ONE kernel. Each thread
//    owns one output row's columns [c, c + VEC) of one segment s: a
//    binary search finds the first row whose id is >= s, the thread
//    folds the rows while their id is s into VEC fp32 registers in row
//    order (16-byte loads where the row width allows), and writes its
//    output columns once, already cast. No fill, no scratch, no atomics,
//    no cast pass; an empty segment writes the identity; ids outside
//    [0, num_segments) fall in no segment's range. Sums are taken in row
//    order, so two calls give the same bits.
// 2. unsorted ids, entry segment_reduce: three kernels on the caller's
//    stream:
//      a. fill an fp32 scratch with the identity;
//      b. one thread per data element: atomicAdd (sum), or the
//         ordered-int atomics (min / max): a float with its sign bit clear
//         orders like its bits as a signed int, one with it set (-0
//         included) inversely to its bits as an unsigned int, so signed
//         atomicMin/atomicMax for the first and unsigned
//         atomicMax/atomicMin for the second give the float min / max
//         without a compare-and-swap loop;
//      c. cast the scratch to the data dtype (skipped for float32 data,
//         whose output IS the scratch).
//    Sums land in an order that changes from run to run.
// Min and max are exact, and both bodies order -0 below +0, so their
// results are bit-equal to each other and to any order of evaluation.
//
// Bound on this card: bytes. A call must read the data and the ids once
// and write the output once; one add or compare per element is far
// below the card's rate. At the embedding bag's shapes (about 2 MB) the
// sorted body is bound instead by latency: one launch, a binary search
// of log2(n) dependent loads from L2, then a bag's few rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// A signed int that orders floats as the ordered-int atomics do.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// VEC consecutive elements of T as floats: one 16-byte load when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    from_f32(v[0], p);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(v[i], e + i);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename T, int OP, int VEC>
__global__ void sorted_kernel(const T* __restrict__ data,
                              const int* __restrict__ ids,
                              T* __restrict__ out, long long n, int dim,
                              long long num_segments) {
  const int groups = dim / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_segments * groups) return;
  const long long seg = t / groups;
  const long long col = (t - seg * groups) * VEC;
  long long lo = 0, hi = n;  // the first row whose id is >= seg
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < seg)
      lo = mid + 1;
    else
      hi = mid;
  }
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    acc[i] = OP == kSum ? 0.f : (OP == kMin ? INFINITY : -INFINITY);
  for (long long r = lo; r < n && __ldg(ids + r) == seg; ++r) {
    float v[VEC];
    load_vec<T, VEC>(data + r * dim + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (OP == kSum)
        acc[i] += v[i];
      else if (OP == kMin ? order_key(v[i]) < order_key(acc[i])
                          : order_key(v[i]) > order_key(acc[i]))
        acc[i] = v[i];
    }
  }
  store_vec<T, VEC>(out + seg * dim + col, acc);
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

template <typename T, int VEC>
cudaError_t reduce_sorted(const void* data, const void* ids, void* out,
                          long long n, int dim, long long num_segments,
                          int op, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const int* i = static_cast<const int*>(ids);
  T* o = static_cast<T*>(out);
  const unsigned grid = blocks_for(num_segments * (dim / VEC));
  if (op == kSum)
    sorted_kernel<T, kSum, VEC><<<grid, kBlock, 0, s>>>(d, i, o, n, dim,
                                                         num_segments);
  else if (op == kMin)
    sorted_kernel<T, kMin, VEC><<<grid, kBlock, 0, s>>>(d, i, o, n, dim,
                                                         num_segments);
  else
    sorted_kernel<T, kMax, VEC><<<grid, kBlock, 0, s>>>(d, i, o, n, dim,
                                                         num_segments);
  return cudaGetLastError();
}

template <typename T>
cudaError_t reduce_sorted(const void* data, const void* ids, void* out,
                          long long n, int dim, long long num_segments,
                          int op, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = dim % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned ? reduce_sorted<T, kVec>(data, ids, out, n, dim,
                                          num_segments, op, s)
                 : reduce_sorted<T, 1>(data, ids, out, n, dim, num_segments,
                                       op, s);
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

// Reduces ``data`` ([n, dim], ``dtype`` 0 float32 / 1 bfloat16) by
// ascending ``ids`` (int32 [n]) into ``out`` ([num_segments, dim], the
// data dtype) in one kernel; ``op``: 0 sum, 1 min, 2 max. Ids that are
// not ascending give an unspecified result. Returns the CUDA error code.
int segment_reduce_sorted(const void* data, const void* ids, void* out,
                          long long n, int dim, long long num_segments,
                          int dtype, int op, void* stream) {
  if (num_segments * dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? reduce_sorted<float>(data, ids, out, n, dim,
                                           num_segments, op, s)
                    : reduce_sorted<__nv_bfloat16>(data, ids, out, n, dim,
                                                   num_segments, op, s);
}

}  // extern "C"
