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
// one (b*Hq + h, q tile) and walks the kv tiles in a loop of its own:
// the running statistics live in registers. The kv head is
// h / (Hq / Hkv), read in place (no repeat), and neither k, v nor the
// sequence is copied or padded: keys >= Sk and queries >= Sq are masked
// inside the block.
//
// Arithmetic, as the Pallas kernel does it: s = (q . k) * scale in fp32,
// softcap cap * tanh(s / cap), masked entries -1e30 (not -inf: a row
// whose first tile is fully masked then gets exp(0) weights that the
// next tile's rescale exp(-1e30 - m) = 0 wipes out, where -inf would
// give NaN), fp32 running max / sum / accumulator, kv tiles that are
// masked for the whole q tile skipped, l == 0 -> 1, one rounding of the
// output to q's dtype.
//
// Two bodies, routed statically by the wrapper (ops.py):
//
// * flash_wgmma_kernel (bfloat16, d = 64, 128, 256: every prefill of the
//   LM path). Bound on this card: operations. A (q, k) pair costs 4 d
//   flops (QK and PV) against 4 d bytes of q, k, v and o moved once per
//   ROW, so at thousands of keys per query the work is hundreds of flops
//   per byte and only the bf16 tensor cores (989 TFLOP/s) can keep up.
//   One block owns one (b*Hq + h, 128-row q tile) and has three
//   warpgroups. Warpgroup 0 is the producer (registers lowered with
//   setmaxnreg): one thread loads Q once by TMA, then streams K and V
//   tiles of kBlockN keys through a 2-stage ring in shared memory, each
//   stage guarded by a full / empty mbarrier pair. Warpgroups 1 and 2
//   are the consumers (registers raised to 240), 64 query rows each:
//   S = Q K^T by wgmma from shared memory (both K-major), the online
//   softmax on the fp32 S fragment, then O += P V by wgmma with P from
//   registers (the S fragment converted pairwise to bf16x2 IS the A
//   fragment) and V read MN-major through the descriptor's transpose
//   bit, so V is never copied or transposed. The O accumulator stays in
//   registers for the whole row tile (64 x d fp32 over 128 threads: 128
//   registers a thread at d = 256). Tensor maps are 4-D over the
//   [B, S, H, d] tensors (innermost first: d, H, S, B) with 128-byte
//   swizzle and 64-column boxes; rows past Sq / Sk are zero-filled by
//   TMA and masked by position as well. Blocks are issued heads-fastest
//   and longest q tile first, so the causal tail does not wait on one
//   late block. The arithmetic is the reference model's on its matrix
//   unit (bf16 operands, fp32 accumulators, P rounded once to bf16 for
//   the PV product, l summed from the fp32 P): the wrapper's docstring
//   and ref.p_rounding_bound state what that costs against the fp32
//   plain version. exp2 with log2(e) folded into the scale (or the
//   softcap) replaces exp; the softcap's tanh is the accurate tanhf.
//
// * flash_kernel (float32 at every head dim, bfloat16 at d = 16, 32):
//   one block per (b*Hq + h, 64-row q tile), the products as fp32 FMAs
//   on the CUDA cores (67 TFLOP/s, not the 989 of the bf16 tensor
//   cores), p kept fp32 for the PV product as in the Pallas kernel's
//   interpret run. The design keeps the FMA units fed from shared
//   memory: tiles of Q (64 x d), K (64 x d), V (64 x d) converted to
//   fp32 once when loaded, 256 threads, each owning a 4 x 4 block of
//   the 64 x 64 score tile (8 FMAs per 16-byte shared load) and the same
//   4 rows x d/16 columns of the output accumulator (64 registers at
//   d = 256), so the rescale by exp(m_old - m_new) needs no exchange.
//   Row max and sum are reduced over the 16 lanes that share a row with
//   shuffles. q tiles are issued longest-first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  }
  // bfloat16 at d >= 64 runs the Hopper body (wg::launch) instead
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 64:
        return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale,
                             causal, window, softcap, s);
      case 128:
        return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale,
                              causal, window, softcap, s);
      case 256:
        return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale,
                              causal, window, softcap, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// The Hopper body: TMA ring, warp-specialised, wgmma products (bf16 only)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBlockM = 128;       // q rows per block: 64 per consumer
constexpr int kThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kConsumers = 256;    // threads that release a ring stage
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // the reference's mask constant

template <int D>
struct Cfg {
  static constexpr int kBlockN = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kRow = 128;                     // bytes: one box row
  static constexpr int kQBox = kBlockM * kRow;         // one 64-column box
  static constexpr int kKVBox = kBlockN * kRow;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;     // K or V, one stage
  // shared memory: Q | K stages | V stages | barriers (1024-aligned base)
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` has completed. (No trap on
// a long wait: a trap on this path costs the consumers 900 bytes of
// register spills at d = 256.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at ``dst``, completing ``bar``'s byte count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units). K-major operands (Q, K):
// 8-row groups 1024 bytes apart (SBO), LBO unused. MN-major V: 64-column
// boxes ``lbo`` bytes apart along N, 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of an accumulator across the
// asynchronous product that owns it.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major; ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory, both
// K-major; ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Scale (and cap) one S tile in log2 units, mask it where ``kMask``,
// fold it into the running max / partial sum of the thread's two rows,
// rescale O, and leave P = exp2(x - m) in ``s``. Fragment of thread
// (warp w, lane l) of the warpgroup: s[4j + e] is row 16 w + l / 4
// (+ 8 for e >= 2), column 8 j + 2 (l % 4) + (e & 1).
template <bool kMask, bool kCap, int NS, int NO>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NS], float (&o)[NO], float (&m)[2], float (&l)[2],
    float scale_log2, float cap_log2, float scale_over_cap, int k0, int row0,
    int lane, int Sk, int causal, int window) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = kCap ? cap_log2 * tanhf(s[i] * scale_over_cap)
                   : s[i] * scale_log2;
    if (kMask) {
      const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int qp = row0 + 8 * ((i / 2) & 1);
      const bool keep = kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
      x = keep ? x : kNegInf;
    }
    s[i] = x;
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = exp2f(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float p0 = exp2f(s[4 * j + 2 * r] - mx);
      const float p1 = exp2f(s[4 * j + 2 * r + 1] - mx);
      s[4 * j + 2 * r] = p0;
      s[4 * j + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l[r] = l[r] * alpha[r] + sum;   // this lane's share; reduced at the end
  }
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                   int Hkv, float scale_log2, float cap_log2,
                   float scale_over_cap, int causal, int window) {
  using C = Cfg<D>;
  constexpr int N = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;   // 128-byte swizzle atoms are 1024-byte aligned
  const uint32_t sq = base, sk = base + C::kOffK, sv = base + C::kOffV;
  const uint32_t bar_q = base + C::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;                          // heads fastest
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;   // longest first
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + kBlockM, Sq) - 1;
  // kv tiles that are not masked for the whole q tile
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / N;
  const int n_tiles = max(0, (k_end + N - 1) / N - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, through a shuffle so the compiler knows it
  // is uniform over each warp (a wgmma on a path it cannot prove uniform
  // is serialized)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(sq + c * C::kQBox, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kKVBytes);
        const int k0 = (t_begin + i) * N;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk + s * C::kKVBytes + c * C::kKVBox, &tm_k, full, 64 * c,
                   hk, k0, b);
          tma_load(sv + s * C::kKVBytes + c * C::kKVBox, &tm_v, full, 64 * c,
                   hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = role - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int qa = q0 + 64 * w;                  // this warpgroup's rows
    const int qb = min(qa + 63, Sq - 1);         // last valid one
    const int row0 = qa + 16 * (t / 32) + lane / 4;   // and row0 + 8
    int wk_begin = 0, wk_end = Sk;
    if (causal) wk_end = min(Sk, qb + 1);
    if (window > 0) wk_begin = max(0, qa - window + 1);
    const int wt_begin = wk_begin / N;
    const int wt_end = qb >= qa ? (wk_end + N - 1) / N : 0;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t qw = sq + 64 * w * C::kRow;   // rows 64 w.. of each box

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int tile = t_begin + i;
      mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      if (tile >= wt_begin && tile < wt_end) {
        // S = Q K^T: d / 16 steps of k16, 32 bytes apart in a 128-byte
        // swizzled row, the next 64-column box every 4 steps
        float sc[N / 2];
        const uint32_t ks = sk + s * C::kKVBytes;
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss(sc,
                 desc(qw + (kk / 4) * C::kQBox + (kk % 4) * 32, 16, 1024),
                 desc(ks + (kk / 4) * C::kKVBox + (kk % 4) * 32, 16, 1024),
                 kk > 0);
        mma_commit();
        mma_wait();
        pin(sc);

        const int k0 = tile * N;
        const bool whole = k0 + N <= Sk && (!causal || k0 + N - 1 <= qa) &&
                           (window <= 0 || qb - k0 < window);
#define SOFTMAX(MASK, CAP)                                              \
  softmax_tile<MASK, CAP>(sc, o, m, l, scale_log2, cap_log2,            \
                          scale_over_cap, k0, row0, lane, Sk, causal, window)
        if (cap_log2 > 0.f) {
          if (whole) SOFTMAX(false, true); else SOFTMAX(true, true);
        } else {
          if (whole) SOFTMAX(false, false); else SOFTMAX(true, false);
        }
#undef SOFTMAX

        // O += P V: P rounded once to bf16, 16 keys (2048 bytes of V)
        // per step; every fragment is packed before the fence, so no
        // product waits on the packing of the next one
        uint32_t pa[N / 16][4];
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            asm volatile("" : "+r"(pa[kk][r]) :: "memory");
          }
        const uint32_t vs = sv + s * C::kKVBytes;
        pin(o);
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          mma_rs(o, pa[kk], desc(vs + kk * 16 * C::kRow, C::kKVBox, 1024));
        mma_commit();
        mma_wait();
        pin(o);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // out = O / l, rounded once; rows >= Sq are not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / (sum == 0.f ? 1.f : sum);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + (((long long)b * Sq + row) * Hq + h) * D + 2 * (lane % 4));
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        dst[4 * j] = pack_bf16(o[4 * j + 2 * r] * inv,
                               o[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links no libcuda of its own.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a contiguous bf16 [B, S, H, D] tensor whose box is 64 columns
// of ``rows`` rows of one head of one batch, 128-byte swizzled; reads past
// S come back as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  // Sk = 0 loads no tile; the maps still need a non-empty extent
  if (!make_map(&tq, q, B, Sq, Hq, D, kBlockM) ||
      !make_map(&tk, k, B, max(Sk, 1), Hkv, D, C::kBlockN) ||
      !make_map(&tv, v, B, max(Sk, 1), Hkv, D, C::kBlockN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kBlockM - 1) / kBlockM);
  flash_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv,
      scale * kLog2e, softcap * kLog2e, softcap > 0.f ? scale / softcap : 0.f,
      causal, window);
  return cudaGetLastError();
}

}  // namespace wg

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[b, i, h] = softmax_j(mask(softcap(q[b, i, h] . k[b, j, h / G] *
// scale))) v[b, j, h / G] with G = Hq / Hkv; q, out: contiguous
// [B, Sq, Hq, D]; k, v: contiguous [B, Sk, Hkv, D]; positions are the
// indices 0.. of both sequences. ``dtype``: 0 float32, 1 bfloat16 (all
// four tensors alike); D one of 16, 32, 64, 128, 256 for float32, 16 or
// 32 for bfloat16 (flash_attention_wgmma takes the others); ``window``
// 0 = none; ``softcap`` 0 = none. Returns the CUDA error of the launch.
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

// The Hopper body (see the top of this file): q, k, v, out bfloat16 in
// the layouts above, each 16-byte aligned; D one of 64, 128, 256.
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                          int D, float scale, int causal, int window,
                          float softcap, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return wg::launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                            window, softcap, s);
    case 128:
      return wg::launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                             window, softcap, s);
    case 256:
      return wg::launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                             window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
