// EmbeddingBag: gather rows of a [vocab, dim] table by [num_bags, bag]
// int32 indices and reduce each bag to one [dim] row, sum or mean.
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py,
// _embedding_bag_kernel / embedding_bag_pallas (entry ops.embedding_bag).
// On the TPU the whole table sits in VMEM and a 1-D grid walks tiles of
// bags, so the wrapper pads the bag count to a multiple of the tile.
// Here each thread owns one (bag, column chunk) and there is no tile to
// pad to: the last block masks its ragged end.
//
// Arithmetic, as the Pallas kernel does it: the bag's rows are summed in
// fp32 in index order and rounded ONCE to the table dtype; for "mean"
// that rounded sum is divided by ``bag`` and rounded again (the
// reference divides its already-rounded aggregate). Bag 1 is therefore a
// bit-exact gather.
//
// Bound on this card: bytes. Per bag the kernel must read ``bag``
// 4-byte indices and ``bag`` random table rows and write one output row;
// the adds are a few per 16 bytes, far below the card's rate. A random
// row is a separate DRAM transaction, so what counts is that each row is
// fetched in as few sectors as possible and that many fetches are in
// flight. The design: a thread loads its part of a row as one 16-byte
// vector (a 16-wide bf16 row is 32 bytes, one sector, read by two
// neighbouring threads; a 16-wide fp32 row by four), all threads of the
// grid issue their gathers independently (no shared memory, no
// barrier), and neighbouring threads write neighbouring 16-byte pieces
// of the output, so the writes are fully coalesced. Row offsets are
// computed in 64 bits: row * dim passes 2^31 on the full fused table.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements a thread: 16 / sizeof(T) when the row and the pointers
// allow 16-byte vectors, else 1.
template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int* __restrict__ indices,
                                     T* __restrict__ out, long long num_bags,
                                     int bag, int dim, int mean) {
  const int chunks = dim / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_bags * chunks) return;
  const long long b = t / chunks;
  const long long col = (t - b * chunks) * VEC;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  const int* idx = indices + b * bag;
  for (int j = 0; j < bag; ++j) {
    const long long row = __ldg(idx + j);
    const T* src = table + row * dim + col;
    if constexpr (VEC * sizeof(T) == 16) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(src[k]);
    }
  }

  alignas(16) T res[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    T s = from_f32<T>(acc[k]);
    if (mean) s = from_f32<T>(to_f32(s) / (float)bag);
    res[k] = s;
  }
  T* dst = out + b * dim + col;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(res);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = res[k];
  }
}

template <typename T>
cudaError_t launch(const void* table, const void* indices, void* out,
                   long long num_bags, int bag, int dim, int mean,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = dim % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = num_bags * (vec ? dim / kVec : dim);
  const int block = 256;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  if (vec)
    embedding_bag_kernel<T, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const int*>(indices),
        static_cast<T*>(out), num_bags, bag, dim, mean);
  else
    embedding_bag_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const int*>(indices),
        static_cast<T*>(out), num_bags, bag, dim, mean);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[b] = reduce_j table[indices[b, j]] for b < num_bags, j < bag.
// ``dtype``: 0 float32, 1 bfloat16 (table and out alike); ``mean``: 0
// sum, 1 mean. Every index must lie in [0, vocab). Returns the CUDA
// error of the launch.
int embedding_bag(const void* table, const void* indices, void* out,
                  long long num_bags, int bag, int dim, int dtype, int mean,
                  void* stream) {
  if (num_bags == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(table, indices, out, num_bags, bag, dim, mean, s);
  return launch<__nv_bfloat16>(table, indices, out, num_bags, bag, dim,
                               mean, s);
}

}  // extern "C"
