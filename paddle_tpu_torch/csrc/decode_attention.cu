// Single-query decode attention against a dense KV cache, f32 or bf16
// cache storage with f32 queries, outputs and arithmetic, for Hopper
// (sm_90a).
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
// bytes of cache, not O(C). A bf16 cache is upcast to f32 as it is
// loaded (the reference upcasts at the contraction), so bf16 halves the
// bytes read and changes nothing else.
//
// What bounds it on the H100: device-memory bytes (each live K and V row
// is read once, two flops per byte loaded). At the slice's shapes
// (S * H = 128 pairs) one block per pair leaves 4 of 132 SMs idle and
// gives each SM one block of 8 warps; splitting the keys across blocks
// (flash-decoding) is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;      // rows in flight per warp
constexpr float kNeg = -1e30f;  // the masking constant of the TPU kernel

// V consecutive cache elements (float or bf16) -> V floats in registers
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* r) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  }
};
template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* r) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* r) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* r) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    r[0] = x.x; r[1] = x.y;
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
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
  Vec<float, V>::load(q + static_cast<size_t>(s) * hd + col, qv);
  const T* kbase = kc + static_cast<size_t>(s) * C * hd + col;
  const T* vbase = vc + static_cast<size_t>(s) * C * hd + col;

  float m = kNeg, l = 0.f, acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int c0 = warp; c0 < len; c0 += kWarps * kUnroll) {
    float kr[kUnroll][V], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      if (c < len) {
        Vec<T, V>::load(kbase + static_cast<size_t>(c) * hd, kr[u]);
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
        Vec<T, V>::load(vbase + static_cast<size_t>(c) * hd, vr);
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

template <int D, typename T>
cudaError_t launch(const float* q, const T* k, const T* v,
                   const int* lengths, float* o, int slots, int heads, int c,
                   cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  decode_kernel<D, T><<<dim3(heads, slots), kWarps * 32, 0, stream>>>(
      q, k, v, lengths, o, heads, c, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, int slots, int heads, int d, int c, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  const auto* qf = static_cast<const float*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* ln = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64, T>(qf, kt, vt, ln, of, slots, heads, c, st);
    case 128:
      return launch<128, T>(qf, kt, vt, ln, of, slots, heads, c, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous f32 [slots, heads * d]; k, v: contiguous [slots, c,
// heads * d] caches, f32 (decode_attention_f32) or bf16
// (decode_attention_bf16); lengths: int32 [slots], live cache rows per
// slot. Every pointer must be 16-byte aligned. Returns a cudaError_t.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int slots, int heads, int d,
                                    int c, void* stream) {
  return dispatch<float>(q, k, v, lengths, o, slots, heads, d, c, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, int slots, int heads, int d,
                                     int c, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, o, slots, heads, d, c,
                                 stream);
}
