// Single-query decode attention through a block table over a paged KV
// pool, f32 or bf16 pool storage with f32 queries, outputs and
// arithmetic, for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `decode_attention_paged` (_decode_paged_body, index map kv_index): one
// query row per (slot, head) attends the slot's logical cache rows
// c < length[slot], where row c lives at pool row
// table[slot, c / BS] * BS + c % BS. Block ids are clamped into [0, NB)
// before any address is formed, so the dead entries (>= NB) that the
// host writes for inactive and pool-starved slots never read outside the
// pool; rows at or past the length are neither read nor computed.
//
// Design. The decode kernel of csrc/decode_attention.cu with one change,
// the address of a row. One block of 8 warps per (head, slot). The block
// first copies the clamped block ids of its slot's live blocks into
// shared memory (at most MB ints), then warp w takes the rows
// c = w, w + 8, ...; each lane holds D / 32 consecutive elements of q, K
// and V, so one row is one coalesced 512-byte read per warp at D = 128,
// the head being a column offset into the pool's [NB, BS, H * D] rows.
// Four rows are loaded before their dot products are reduced. Each warp
// keeps its own running max, sum and accumulator; the 8 partial states
// are combined in shared memory at the end. Any BS >= 1 works: a row's
// block is c / BS, so no block needs to be a multiple of the tile. A
// bf16 pool is upcast to f32 as it is loaded, as the reference upcasts at
// the contraction.
//
// What bounds it on the H100: device-memory bytes (each live K and V row
// is read once, two flops per byte). As for the dense kernel, one block
// per (slot, head) under-fills the card at 8 slots x 16 heads; splitting
// the keys across blocks, and reading each pool block once for all
// heads, are the known next steps.

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
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, float* __restrict__ o,
                    int heads, int nb, int bs, int mb, float scale) {
  constexpr int V = D / 32;
  extern __shared__ int stab[];  // this slot's clamped block ids
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = heads * D;
  const int len = max(0, min(lengths[s], mb * bs));
  const int nblk = (len + bs - 1) / bs;
  for (int j = threadIdx.x; j < nblk; j += kWarps * 32) {
    const int b = tables[static_cast<size_t>(s) * mb + j];
    stab[j] = min(max(b, 0), nb - 1);
  }
  __syncthreads();

  const size_t col = static_cast<size_t>(h) * D + lane * V;
  float qv[V];
  Vec<float, V>::load(q + static_cast<size_t>(s) * hd + col, qv);
  // pool row of logical row c, times the row stride, plus the column
  auto offset = [&](int c) {
    const int j = c / bs;
    const size_t row = static_cast<size_t>(stab[j]) * bs + (c - j * bs);
    return row * hd + col;
  };

  float m = kNeg, l = 0.f, acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int c0 = warp; c0 < len; c0 += kWarps * kUnroll) {
    float kr[kUnroll][V], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      if (c < len) {
        Vec<T, V>::load(kp + offset(c), kr[u]);
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
        Vec<T, V>::load(vp + offset(c), vr);
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
                   const int* lengths, const int* tables, float* o, int slots,
                   int heads, int nb, int bs, int mb, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  paged_decode_kernel<D, T><<<dim3(heads, slots), kWarps * 32,
                              static_cast<size_t>(mb) * sizeof(int), stream>>>(
      q, k, v, lengths, tables, o, heads, nb, bs, mb, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             const void* tables, void* o, int slots, int heads, int d, int nb,
             int bs, int mb, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  if (nb <= 0 || bs <= 0 || mb <= 0) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* ln = static_cast<const int*>(lengths);
  const auto* tb = static_cast<const int*>(tables);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64, T>(qf, kt, vt, ln, tb, of, slots, heads, nb, bs, mb,
                           st);
    case 128:
      return launch<128, T>(qf, kt, vt, ln, tb, of, slots, heads, nb, bs, mb,
                            st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous f32 [slots, heads * d]; k, v: contiguous [nb, bs,
// heads * d] pools, f32 (decode_attention_paged_f32) or bf16
// (decode_attention_paged_bf16); lengths: int32 [slots], live logical
// rows per slot; tables: int32 [slots, mb] block ids (entries outside
// [0, nb) are clamped into it; the length keeps them unattended). q, o, k
// and v must be 16-byte aligned; mb * 4 bytes must fit in 48 KB of shared
// memory. Returns a cudaError_t.
extern "C" int decode_attention_paged_f32(const void* q, const void* k,
                                          const void* v, const void* lengths,
                                          const void* tables, void* o,
                                          int slots, int heads, int d, int nb,
                                          int bs, int mb, void* stream) {
  return dispatch<float>(q, k, v, lengths, tables, o, slots, heads, d, nb, bs,
                         mb, stream);
}

extern "C" int decode_attention_paged_bf16(const void* q, const void* k,
                                           const void* v, const void* lengths,
                                           const void* tables, void* o,
                                           int slots, int heads, int d, int nb,
                                           int bs, int mb, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, tables, o, slots, heads, d,
                                 nb, bs, mb, stream);
}
