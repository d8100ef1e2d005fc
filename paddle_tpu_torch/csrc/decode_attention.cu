// Single-query decode attention against a dense KV cache, f32, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `decode_attention` (_decode_forward / _decode_body): one query row per
// (slot, head) attends cache rows c < length[slot] with an online
// softmax; rows at or past the length are neither read nor computed.
//
// Design. The cache is read in its native [S, C, H * D] layout with the
// head as a column offset (the indexing the paged TPU kernel's index map
// uses), so no [S, C, H, D] -> [S, H, C, D] copy of the cache is ever
// made. One block of 8 warps per (head, slot). Warp w takes the rows
// c = w, w + 8, ...; each lane holds D / 32 consecutive elements of q, K
// and V, so one row is one coalesced 512-byte read per warp at D = 128.
// Four rows are loaded before their dot products are reduced, to keep
// more loads in flight. Each warp keeps its own running max, sum and
// accumulator; the 8 partial states are combined in shared memory at the
// end. The loop bound is the slot's length, so a step reads O(length)
// bytes of cache, not O(C).
//
// What bounds it on the H100: device-memory bytes (each live K and V row
// is read once, two flops per byte loaded). At the slice's shapes
// (S * H = 128 pairs) one block per pair leaves 4 of 132 SMs idle and
// gives each SM one block of 8 warps; splitting the keys across blocks
// (flash-decoding) is the known next step.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;      // rows in flight per warp
constexpr float kNeg = -1e30f;  // the masking constant of the TPU kernel

template <int V>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* r) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* r) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  }
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
              const float* __restrict__ vc, const int* __restrict__ lengths,
              float* __restrict__ o, int heads, int C, float scale) {
  constexpr int V = D / 32;
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = heads * D;
  const int len = min(lengths[s], C);
  const size_t col = static_cast<size_t>(h) * D + lane * V;

  float qv[V];
  Vec<V>::load(q + static_cast<size_t>(s) * hd + col, qv);
  const float* kbase = kc + static_cast<size_t>(s) * C * hd + col;
  const float* vbase = vc + static_cast<size_t>(s) * C * hd + col;

  float m = kNeg, l = 0.f, acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int c0 = warp; c0 < len; c0 += kWarps * kUnroll) {
    float kr[kUnroll][V], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      if (c < len) {
        Vec<V>::load(kbase + static_cast<size_t>(c) * hd, kr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) d = fmaf(qv[i], kr[u][i], d);
      sc[u] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    float mx = kNeg;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sc[u] = c0 + u * kWarps < len ? sc[u] * scale : kNeg;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      if (c < len) {
        const float p = expf(sc[u] - m_new);
        float vr[V];
        Vec<V>::load(vbase + static_cast<size_t>(c) * hd, vr);
        l += p;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sacc[warp][lane * V + i] = acc[i];
  __syncthreads();

  for (int t = threadIdx.x; t < D; t += kWarps * 32) {
    float mall = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mall = fmaxf(mall, sm[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w] - mall);
      lsum = fmaf(sl[w], f, lsum);
      a = fmaf(sacc[w][t], f, a);
    }
    o[static_cast<size_t>(s) * hd + static_cast<size_t>(h) * D + t] =
        a / fmaxf(lsum, 1e-30f);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* o, int slots, int heads, int c,
                   cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  decode_kernel<D><<<dim3(heads, slots), kWarps * 32, 0, stream>>>(
      q, k, v, lengths, o, heads, c, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: contiguous f32 [slots, heads * d]; k, v: contiguous f32
// [slots, c, heads * d]; lengths: int32 [slots], live cache rows per slot.
// Every pointer must be 16-byte aligned. Returns a cudaError_t.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int slots, int heads, int d,
                                    int c, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* ln = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(qf, kf, vf, ln, of, slots, heads, c, st);
    case 128:
      return launch<128>(qf, kf, vf, ln, of, slots, heads, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}
