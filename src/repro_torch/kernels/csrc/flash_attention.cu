// Flash attention: online-softmax attention over [B, S, H, d] tensors
// with grouped-query heads, causal masking, a sliding window and a
// logit softcap, accumulated in fp32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel / flash_attention_pallas (GQA wrapper ops.py:18). On the
// TPU the grid is (batch*heads, q blocks, kv blocks) with the kv axis
// sequential, so (m, l, acc) persist in VMEM scratch across grid steps;
// the wrapper folds the GQA group into the batch-heads axis by repeating
// k and v, and pads the sequence to a tile multiple. Here one block owns
// one (b*Hq + h, 64-row q tile) and walks the kv tiles in a loop of its
// own: the running statistics live in registers. The kv head is
// h / (Hq / Hkv), read in place (no repeat), and the layout is read with
// its strides, so neither k, v nor the sequence is copied or padded:
// keys >= Sk and queries >= Sq are masked inside the block.
//
// Arithmetic, as the Pallas kernel does it: s = (q . k) * scale in fp32,
// softcap cap * tanh(s / cap), masked entries -1e30 (not -inf: a row
// whose first tile is fully masked then gets exp(0) weights that the
// next tile's rescale exp(-1e30 - m) = 0 wipes out, where -inf would
// give NaN), fp32 running max / sum / accumulator, kv tiles that are
// masked for the whole q tile skipped, l == 0 -> 1, one rounding of the
// output to q's dtype. p stays fp32 for the PV product, as in the Pallas
// kernel's body.
//
// Bound on this card: operations. A (q, k) pair costs 4 d flops (QK and
// PV) against 4 d bytes of q, k, v and o read or written once per ROW,
// so at the path's lengths (thousands of keys per query) the work is
// hundreds of flops per byte. This first version does the products as
// fp32 FMAs on the CUDA cores (67 TFLOP/s, not the 989 of the bf16
// tensor cores): exact fp32 accumulation and a simple, checkable kernel
// come first; wgmma with TMA is the later redesign. The design keeps
// the FMA units fed from shared memory: tiles of Q (64 x d), K (64 x d),
// V (64 x d) converted to fp32 once when loaded, 256 threads, each
// owning a 4 x 4 block of the 64 x 64 score tile (8 FMAs per 16-byte
// shared load) and the same 4 rows x d/16 columns of the output
// accumulator (64 registers at d = 256), so the rescale by
// exp(m_old - m_new) needs no exchange. Row max and sum are reduced over
// the 16 lanes that share a row with shuffles. q tiles are issued
// longest-first, so the causal tail does not wait on one late block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPad = 4;            // floats of row padding (keeps 16 B rows)
constexpr float kNegInf = -1e30f;  // the reference's mask constant

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

static_assert(kBlockQ == kBlockK, "load_tile fills Q and K/V tiles alike");

// Copy the 64 rows of length D of a tile (row r at src + r * stride)
// into a [64][ld] fp32 tile, zero-filling rows >= valid.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int valid) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] = r < valid ? to_f32(src[r * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int Hq, int Hkv, float scale, int causal, int window,
             float softcap) {
  constexpr int LDQ = D + kPad;     // Q and K rows, 16-byte aligned
  constexpr int LDP = kBlockK + kPad;
  constexpr int CPT = D / 16;       // output columns a thread owns
  constexpr int VEC = CPT < 4 ? CPT : 4;
  constexpr int NCH = CPT / VEC;    // chunks of VEC columns, 16*VEC apart
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [64][LDQ]
  float* sk = sq + kBlockQ * LDQ;        // [64][LDQ]
  float* sv = sk + kBlockK * LDQ;        // [64][D]
  float* sp = sv + kBlockK * D;          // [64][LDP]

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest q tiles first
  const int q0 = tile * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;        // rows 4ty.., lane group
  const long long qstride = (long long)Hq * D;
  const long long kstride = (long long)Hkv * D;
  const T* qb = q + ((long long)b * Sq + q0) * qstride + (long long)h * D;
  const T* kb = k + (long long)b * Sk * kstride + (long long)hk * D;
  const T* vb = v + (long long)b * Sk * kstride + (long long)hk * D;

  const int q_valid = min(kBlockQ, Sq - q0);
  const int q_last = q0 + q_valid - 1;
  load_tile<T, D>(sq, LDQ, qb, qstride, q_valid);

  // kv tiles that are not masked for the whole q tile
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / kBlockK) * kBlockK;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    const int k_valid = min(kBlockK, Sk - k0);
    __syncthreads();   // the previous tile's K, V, P are no longer read
    load_tile<T, D>(sk, LDQ, kb + (long long)k0 * kstride, kstride, k_valid);
    load_tile<T, D>(sv, D, vb + (long long)k0 * kstride, kstride, k_valid);
    __syncthreads();

    // S = Q K^T for rows 4ty + i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * LDQ + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * LDQ + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask; online softmax over the 16 lanes of a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = kp < Sk && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
        x = keep ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(4 * ty + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for rows 4ty + i, columns 16 VEC n + VEC tx + e
    for (int j = 0; j < kBlockK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(4 * ty + i) * LDP + j];
      const float* vr = sv + j * D;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              vr + 16 * VEC * n + VEC * tx);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            vv[e] = vr[16 * VEC * n + VEC * tx + e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][n * VEC + e] = fmaf(p[i], vv[e], acc[i][n * VEC + e]);
      }
    }
  }

  // out = acc / l in q's dtype; queries >= Sq are not written
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= q_valid) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* orow = out + ((long long)b * Sq + q0 + r) * qstride + (long long)h * D;
#pragma unroll
    for (int n = 0; n < NCH; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[16 * VEC * n + VEC * tx + e] =
            from_f32<T>(acc[i][n * VEC + e] * inv);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (D + kPad) +
                          (size_t)kBlockK * D +
                          (size_t)kBlockQ * (kBlockK + kPad));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                           window, softcap, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                           window, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                           window, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                            window, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                            window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[b, i, h] = softmax_j(mask(softcap(q[b, i, h] . k[b, j, h / G] *
// scale))) v[b, j, h / G] with G = Hq / Hkv; q, out: contiguous
// [B, Sq, Hq, D]; k, v: contiguous [B, Sk, Hkv, D]; positions are the
// indices 0.. of both sequences. ``dtype``: 0 float32, 1 bfloat16 (all
// four tensors alike); D one of 16, 32, 64, 128, 256; ``window`` 0 =
// none; ``softcap`` 0 = none. Returns the CUDA error of the launch.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int Hq, int Hkv, int D,
                    float scale, int causal, int window, float softcap,
                    int dtype, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, scale,
                           causal, window, softcap, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, scale,
                                 causal, window, softcap, s);
}

}  // extern "C"
