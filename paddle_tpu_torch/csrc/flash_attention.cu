// Flash attention forward (prefill), f32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `flash_attention` (_forward / _body): softmax(Q K^T * d^-1/2 + mask) V
// over [BH, T, D] with an online softmax, causal masking, and the
// segment-id mask (a key is attendable iff its id equals the query's and
// is nonzero; a query row with no attendable key writes 0).
//
// Design. One block per (batch-head, 64-row q tile); a loop inside the
// block walks the 64-row k tiles, which is what the TPU's sequential
// innermost grid axis did. The running max, running sum and the 64 x D
// accumulator live in registers (each thread owns 4 rows x D/16 columns),
// the Q, K, V and probability tiles in shared memory. Causal tiles above
// the diagonal are never loaded. Any T works: rows and keys past T are
// zero-filled and masked, so there is no aligned-length fallback.
//
// What bounds it on the H100. In f32 the products run on the CUDA cores
// (67 TFLOP/s on the data sheet), and the kernel re-reads each K/V tile
// once per q tile, so at prefill sizes (T <= 512, D = 128) it is bound by
// f32 operations and by shared-memory bandwidth, not by device memory.
// This first version keeps the arithmetic plain FMA; tensor cores (TF32
// or bf16 wgmma) are for a later change.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per k tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNeg = -1e30f; // the masking constant of the TPU kernel

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) * 4 +
         (kBQ + kBK) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ o, int T, int heads, float scale,
                 int causal) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);     // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);     // [kBK][D]
  float* ps = vs + kBK * D;           // [kBQ][kBK + 1]
  int* sq = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));  // [kBQ]
  int* sk = sq + kBQ;                                       // [kBK]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane: keys tx + 16 j, dims tx + 16 c
  const int ty = tid >> 4;   // row group: rows 4 ty .. 4 ty + 3
  const size_t base = static_cast<size_t>(bh) * T * D;
  const int* seg_row = seg ? seg + static_cast<size_t>(bh / heads) * T
                           : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    qs[r * (D + 1) + c] = row < T ? q[base + static_cast<size_t>(row) * D + c]
                                  : 0.f;
  }
  if (seg_row) {
    for (int i = tid; i < kBQ; i += kThreads)
      sq[i] = q0 + i < T ? seg_row[q0 + i] : 0;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(T, q0 + kBQ) : T;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      const size_t off = base + static_cast<size_t>(key) * D + c;
      ks[r * (D + 1) + c] = key < T ? k[off] : 0.f;
      vs[r * D + c] = key < T ? v[off] : 0.f;
    }
    if (seg_row) {
      for (int i = tid; i < kBK; i += kThreads)
        sk[i] = k0 + i < T ? seg_row[k0 + i] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int col = k0 + cl;
        bool live = col < T && (!causal || row >= col);
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
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * (kBK + 1) + tx + 16 * j] = p;
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
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[base + static_cast<size_t>(row) * D + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* seg, float* o, int bh, int t, int heads,
                   int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // d ** -0.5 rounded once to f32, as the reference multiplies it in
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((t + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, seg, o, t, heads, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous f32 [bh, t, d]; seg: contiguous int32
// [bh / heads, t] segment ids, or null for no segment mask.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* seg, void* o,
                                   int bh, int t, int d, int heads,
                                   int causal, void* stream) {
  if (bh <= 0 || t <= 0) return cudaSuccess;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* sg = static_cast<const int*>(seg);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(qf, kf, vf, sg, of, bh, t, heads, causal, st);
    case 128:
      return launch<128>(qf, kf, vf, sg, of, bh, t, heads, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}
