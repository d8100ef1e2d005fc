// Flash attention forward (prefill and training), f32 and bf16, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `flash_attention` (_forward / _body): softmax(Q K^T * d^-1/2 + mask) V
// over [BH, T, D] with an online softmax, causal masking, and the
// segment-id mask (a key is attendable iff its id equals the query's and
// is nonzero; a query row with no attendable key writes 0). The bf16
// instantiations are what the reference computes on bf16 refs under amp:
// K and V upcast to f32 before the products, the scores and the
// probabilities f32, the PV product f32 (`p.astype(v_blk.dtype)` casts to
// the upcast f32 block), and only the output rounded to bf16. The tile
// instantiations of the bf16 kernel are the port of the block-size sweep
// tools/transformer_mfu_probe.py `bench_kernel` (T2).
//
// Design. One block per (batch-head, BQ-row q tile); a loop inside the
// block walks the BK-key tiles, which is what the TPU's sequential
// innermost grid axis did. The running max, running sum and the BQ x D
// accumulator live in registers (a 16 x 16 grid of threads; each thread
// owns BQ/16 rows, BK/16 keys of a score tile and D/16 accumulator
// columns), the Q, K, V tiles (in the element type: bf16 tiles take half
// the shared memory) and the f32 probability tile in shared memory.
// Causal tiles above the diagonal are never loaded. Any T works: rows and
// keys past T are zero-filled and masked, so there is no aligned-length
// fallback.
//
// What bounds it on the H100. The products run as f32 FMAs on the CUDA
// cores (67 TFLOP/s on the data sheet), and the kernel re-reads each K/V
// tile once per q tile, so at the path's sizes it is bound by f32
// operations and by shared-memory bandwidth, not by device memory. bf16
// halves the bytes but not the arithmetic. Tensor cores may take Q K^T
// (a bf16 x bf16 product is exact in f32) but not P V as the reference
// computes it (P stays f32): that redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNeg = -1e30f; // the masking constant of the TPU kernel

// Element access: shared tiles keep the input's type; arithmetic is f32.
// The row padding makes a tile row an odd number of 4-byte words, so the
// 16 lanes reading 16 rows at one column hit 16 banks.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPad = 1;
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 2;
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  // round to nearest even, as the reference's astype and torch's .to()
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

template <typename T, int D, int BQ, int BK>
constexpr int smem_bytes() {
  constexpr int ld = D + Elem<T>::kPad;
  return static_cast<int>(sizeof(T)) * (BQ * ld + BK * ld + BK * D) +
         4 * BQ * (BK + 1) + 4 * (BQ + BK);
}

// Rows [r0, r0 + R) of a row-major [t, D] matrix into a shared tile of row
// stride LD, in 16-byte loads; rows at or past t are zero.
template <typename T, int R, int D, int LD>
__device__ void load_tile(T* dst, const T* src, int r0, int t, int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  for (int i = tid; i < R * D / V; i += kThreads) {
    const int r = i * V / D, c = i * V % D;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + r) * D + c);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * LD + c + j] = e[j];
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, int t, int heads, float scale,
                 int causal) {
  using E = Elem<T>;
  constexpr int LD = D + E::kPad;
  constexpr int RQ = BQ / 16;  // rows per thread
  constexpr int RK = BK / 16;  // keys per thread in a score tile
  constexpr int DC = D / 16;   // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);       // [BQ][LD]
  T* ks = qs + BQ * LD;                           // [BK][LD]
  T* vs = ks + BK * LD;                           // [BK][D]
  float* ps = reinterpret_cast<float*>(vs + BK * D);  // [BQ][BK + 1]
  int* sq = reinterpret_cast<int*>(ps + BQ * (BK + 1));  // [BQ]
  int* sk = sq + BQ;                                      // [BK]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane: keys tx + 16 j, dims tx + 16 c
  const int ty = tid >> 4;   // row group: rows RQ ty .. RQ ty + RQ - 1
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int* seg_row = seg ? seg + static_cast<size_t>(bh / heads) * t
                           : nullptr;

  load_tile<T, BQ, D, LD>(qs, q + base, q0, t, tid);
  if (seg_row) {
    for (int i = tid; i < BQ; i += kThreads)
      sq[i] = q0 + i < t ? seg_row[q0 + i] : 0;
  }

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(t, q0 + BQ) : t;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BK, D, LD>(ks, k + base, k0, t, tid);
    load_tile<T, BK, D, D>(vs, v + base, k0, t, tid);
    if (seg_row) {
      for (int i = tid; i < BK; i += kThreads)
        sk[i] = k0 + i < t ? seg_row[k0 + i] : 0;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RQ], b[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = E::to_f(qs[(ty * RQ + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < RK; ++j) b[j] = E::to_f(ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int row = q0 + r;
      bool ok[RK];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int cl = tx + 16 * j;
        const int col = k0 + cl;
        bool live = col < t && (!causal || row >= col);
        if (seg_row) live = live && sq[r] == sk[cl] && sk[cl] != 0;
        ok[j] = live;
        s[i][j] = live ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(ty * RQ + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = E::to_f(vs[kk * D + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= t) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[base + static_cast<size_t>(row) * D + tx + 16 * c] =
          E::from_f(acc[i][c] / denom);
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* o, int bh, int t, int heads,
                   int causal, void* stream) {
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 16 == 0, "tile");
  constexpr int bytes = smem_bytes<T, D, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // d ** -0.5 rounded once to f32, as the reference multiplies it in
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D, BQ, BK>
      <<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(seg),
          static_cast<T*>(o), t, heads, scale, causal);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int BQ>
cudaError_t launch_bf16_d128(int block_k, const void* q, const void* k,
                             const void* v, const void* seg, void* o, int bh,
                             int t, int heads, int causal, void* stream) {
  switch (block_k) {
    case 32:
      return launch<bf16, 128, BQ, 32>(q, k, v, seg, o, bh, t, heads, causal,
                                       stream);
    case 64:
      return launch<bf16, 128, BQ, 64>(q, k, v, seg, o, bh, t, heads, causal,
                                       stream);
    case 128:
      return launch<bf16, 128, BQ, 128>(q, k, v, seg, o, bh, t, heads,
                                        causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous f32 [bh, t, d], 16-byte aligned; seg: contiguous
// int32 [bh / heads, t] segment ids, or null for no segment mask. Tiles
// 64 x 64. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* seg, void* o,
                                   int bh, int t, int d, int heads,
                                   int causal, void* stream) {
  if (bh <= 0 || t <= 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch<float, 64, 64, 64>(q, k, v, seg, o, bh, t, heads, causal,
                                       stream);
    case 128:
      return launch<float, 128, 64, 64>(q, k, v, seg, o, bh, t, heads,
                                        causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// As flash_attention_f32 on bf16 q, k, v, o, with the tile block_q x
// block_k: 64 x 64 at d = 64; any of {32, 64, 128} x {32, 64, 128} at
// d = 128 (the T2 sweep's instantiations). Other tiles return
// cudaErrorInvalidValue.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* seg, void* o,
                                    int bh, int t, int d, int heads,
                                    int causal, int block_q, int block_k,
                                    void* stream) {
  if (bh <= 0 || t <= 0) return cudaSuccess;
  if (d == 64) {
    if (block_q != 64 || block_k != 64) return cudaErrorInvalidValue;
    return launch<bf16, 64, 64, 64>(q, k, v, seg, o, bh, t, heads, causal,
                                    stream);
  }
  if (d != 128) return cudaErrorInvalidValue;
  switch (block_q) {
    case 32:
      return launch_bf16_d128<32>(block_k, q, k, v, seg, o, bh, t, heads,
                                  causal, stream);
    case 64:
      return launch_bf16_d128<64>(block_k, q, k, v, seg, o, bh, t, heads,
                                  causal, stream);
    case 128:
      return launch_bf16_d128<128>(block_k, q, k, v, seg, o, bh, t, heads,
                                   causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
