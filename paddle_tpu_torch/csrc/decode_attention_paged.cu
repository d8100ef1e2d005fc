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
// What bounds it on the H100: device-memory bytes, each live K and V row
// read once (two flops a byte). At the serving path's lengths that is
// 25 MB (f32) or 12 MB (bf16) a call, 7.4 or 3.7 us at 3.35 TB/s, spread
// over 8 slots of very different lengths: one CTA per (slot, head)
// walking all of its rows leaves the card idle while the longest slot's
// 16 CTAs finish, one dependent DRAM round trip after another. So the
// design splits the keys (flash-decoding) and issues each chunk's loads
// at once.
//
// Split (paged_split_kernel). Each slot's logical rows are cut into
// chunks of `chunk` rows (from ops/flash_attention.py `_paged_plan`); a
// work item is one (chunk, slot, head), and the `ctas` CTAs of the grid
// take items blockIdx.x, + gridDim.x, ..., of every chunk the table width
// allows, skipping those past the slot's length as soon as it arrives (so
// the grid is fixed by the table width, never by host-side lengths, and
// an item's table entries are read alongside its length). In an item,
// the kWarps warps take batches of rows; a lane loads
// 16 bytes of a row of K and of V (4 f32 or 8 bf16 elements, so one row
// is a warp at f32 D = 128, half a warp at bf16), kLoads rows of each in
// flight before any is used: K and V of a batch go out together, 8 KB a
// warp. The dot products are reduced across a row's lanes, the batch's
// max across the warp, and each warp keeps an online softmax (m, l,
// acc[D]); the warps are combined in shared memory in warp order into
// the chunk's partial (m, l, acc), written to a scratch [slot, head,
// chunk]. Given a counter (the probes' and chip_smoke.py's reading of the
// split), each CTA that took an item adds 1 to work[0] and its items to
// work[1].
//
// Combine (paged_combine_kernel, launched from the same C entry as a
// programmatic dependent, so it is resident before the split ends): one
// warp per (slot, head) reads its live chunks' partials in chunk order,
// m = max m_j, l = sum l_j exp(m_j - m), acc likewise, and writes
// acc / max(l, 1e-30), the reference's _finish. No float is added
// atomically and every boundary (chunk, batch, row within a batch)
// depends only on the logical row index, so a slot's output depends on
// its q, its live rows and its length alone: not on its block ids, its
// slot number or the other slots. Any BS >= 1 works: a row's block is
// c / BS. A bf16 pool is upcast to f32 as it is loaded, as the reference
// upcasts at the contraction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;       // warps a CTA
constexpr int kLoads = 8;       // 16-byte K and V loads a lane keeps in flight
constexpr int kCombineBatch = 8;  // chunks' partials a combine warp loads at once
constexpr float kNeg = -1e30f;  // the masking constant of the TPU kernel

// 16 bytes of a pool row (4 f32 or 8 bf16) -> E floats
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* r) {
    r[0] = __uint_as_float(u.x); r[1] = __uint_as_float(u.y);
    r[2] = __uint_as_float(u.z); r[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* r) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      r[2 * i] = f.x;
      r[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ int live_rows(const int* lengths, int s, int cap) {
  return min(max(lengths[s], 0), cap);
}

// partials of chunk j of (slot s, head h) at index (s * heads + h) * nc + j:
// pm, pl [slots * heads * nc], pacc [slots * heads * nc, D]
template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ lengths,
                   const int* __restrict__ tables, float* __restrict__ pm,
                   float* __restrict__ pl, float* __restrict__ pacc,
                   int* __restrict__ work, int slots, int heads, int nb,
                   int bs, int mb, int chunk, int nc, float scale) {
  constexpr int E = Pack<T>::E;          // elements a lane loads of a row
  constexpr int LPR = D / E;             // lanes a row
  constexpr int RPL = 32 / LPR;          // rows a warp-wide load
  constexpr int RB = RPL * kLoads;       // rows a warp's batch
  static_assert(D <= kWarps * 32, "the warps' combine takes a thread a column");
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  griddep_launch_dependents();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = mb * bs, hd = heads * D;
  const int row_in = lane / LPR, col = (lane % LPR) * E;
  // item (chunk j, slot s, head h), chunk-major; an item past its slot's
  // length is skipped, so its slot, chunk and table entries are known
  // before the length arrives
  const int items = nc * slots * heads;
  int done = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int j = item / (slots * heads);
    const int s = item / heads % slots;
    const int h = item % heads;
    const int c0 = j * chunk;
    const int c1 = min(c0 + chunk, live_rows(lengths, s, cap));
    if (c0 >= c1) continue;
    ++done;
    const int* trow = tables + static_cast<size_t>(s) * mb;

    float qv[E];
    {
      const float4* q4 = reinterpret_cast<const float4*>(
          q + static_cast<size_t>(s) * hd + static_cast<size_t>(h) * D + col);
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const float4 f = q4[i];
        qv[4 * i] = f.x; qv[4 * i + 1] = f.y;
        qv[4 * i + 2] = f.z; qv[4 * i + 3] = f.w;
      }
    }
    float m = kNeg, l = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;

    for (int base = c0 + warp * RB; base < c1; base += kWarps * RB) {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = base + u * RPL + row_in;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < c1) {
          const int b = min(max(__ldg(trow + c / bs), 0), nb - 1);
          const size_t off =
              (static_cast<size_t>(b) * bs + c % bs) * hd +
              static_cast<size_t>(h) * D + col;
          kr[u] = __ldcs(reinterpret_cast<const uint4*>(kp + off));
          vr[u] = __ldcs(reinterpret_cast<const uint4*>(vp + off));
        }
      }
      float sc[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        float kf[E];
        Pack<T>::unpack(kr[u], kf);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qv[e], kf[e], d);
        sc[u] = d;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
      float mx = kNeg;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        sc[u] = base + u * RPL + row_in < c1 ? sc[u] * scale : kNeg;
        mx = fmaxf(mx, sc[u]);
      }
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (base + u * RPL + row_in < c1) {
          const float p = expf(sc[u] - m_new);
          float vf[E];
          Pack<T>::unpack(vr[u], vf);
          l += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
        }
      }
      m = m_new;
    }
    // the warp's rows: add the row groups' sums (m is the warp's own)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < E; ++e) sacc[warp][col + e] = acc[e];
    }
    if (lane == 0) {
      sm[warp] = m;
      sl[warp] = l;
    }
    __syncthreads();
    // the warps, in warp order (D <= the CTA's threads)
    if (tid < D) {
      float mall = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mall = fmaxf(mall, sm[w]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm[w] - mall);
        lsum = fmaf(sl[w], f, lsum);
        a = fmaf(sacc[w][tid], f, a);
      }
      const size_t pi = (static_cast<size_t>(s) * heads + h) * nc + j;
      pacc[pi * D + tid] = a;
      if (tid == 0) {
        pm[pi] = mall;
        pl[pi] = lsum;
      }
    }
    __syncthreads();
  }
  if (work != nullptr && tid == 0 && done > 0) {
    atomicAdd(work, 1);
    atomicAdd(work + 1, done);
  }
}

// o[s, h] from the live chunks' partials of (s, h), in chunk order; a
// warp per (slot, head). The chunks' maxima are read a lane a chunk and
// the sums kCombineBatch chunks at a time, so a slot of many chunks
// costs a few L2 round trips, not one a chunk.
template <int D>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ pm,
                     const float* __restrict__ pl,
                     const float* __restrict__ pacc,
                     const int* __restrict__ lengths, float* __restrict__ o,
                     int slots, int heads, int cap, int chunk, int nc) {
  constexpr int V = D / 32;
  griddep_wait();
  const int pair = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (pair >= slots * heads) return;
  const int s = pair / heads;
  const int n = (live_rows(lengths, s, cap) + chunk - 1) / chunk;
  const size_t base = static_cast<size_t>(pair) * nc;
  float mall = kNeg;
  for (int j = lane; j < n; j += 32) mall = fmaxf(mall, __ldcg(pm + base + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, off));
  float lsum = 0.f, a[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kCombineBatch) {
    float mj[kCombineBatch], lj[kCombineBatch], aj[kCombineBatch][V];
#pragma unroll
    for (int u = 0; u < kCombineBatch; ++u) {
      const size_t j = base + j0 + u;
      const bool live = j0 + u < n;
      mj[u] = live ? __ldcg(pm + j) : kNeg;
      lj[u] = live ? __ldcg(pl + j) : 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i)
        aj[u][i] = live ? __ldcg(pacc + j * D + lane * V + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCombineBatch; ++u) {
      if (j0 + u < n) {
        const float f = expf(mj[u] - mall);
        lsum = fmaf(lj[u], f, lsum);
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = fmaf(aj[u][i], f, a[i]);
      }
    }
  }
  float* out = o + static_cast<size_t>(pair) * D + lane * V;
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = a[i] / fmaxf(lsum, 1e-30f);
}

template <int D, typename T>
cudaError_t launch(const float* q, const T* k, const T* v,
                   const int* lengths, const int* tables, float* o,
                   float* scratch, int* work, int slots, int heads, int nb,
                   int bs, int mb, int chunk, int ctas, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int cap = mb * bs, nc = (cap + chunk - 1) / chunk;
  const size_t parts = static_cast<size_t>(slots) * heads * nc;
  float* pm = scratch;
  float* pl = pm + parts;
  float* pacc = pl + parts;
  paged_split_kernel<D, T><<<ctas, kWarps * 32, 0, stream>>>(
      q, k, v, lengths, tables, pm, pl, pacc, work, slots, heads, nb, bs, mb,
      chunk, nc, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((slots * heads + 3) / 4);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<D>,
                            static_cast<const float*>(pm),
                            static_cast<const float*>(pl),
                            static_cast<const float*>(pacc), lengths, o,
                            slots, heads, cap, chunk, nc);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             const void* tables, void* o, void* scratch, void* work,
             int slots, int heads, int d, int nb, int bs, int mb, int chunk,
             int ctas, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  if (nb <= 0 || bs <= 0 || mb <= 0 || chunk <= 0 || ctas <= 0)
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* ln = static_cast<const int*>(lengths);
  const auto* tb = static_cast<const int*>(tables);
  auto* of = static_cast<float*>(o);
  auto* sc = static_cast<float*>(scratch);
  auto* wk = static_cast<int*>(work);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64, T>(qf, kt, vt, ln, tb, of, sc, wk, slots, heads, nb,
                           bs, mb, chunk, ctas, st);
    case 128:
      return launch<128, T>(qf, kt, vt, ln, tb, of, sc, wk, slots, heads, nb,
                            bs, mb, chunk, ctas, st);
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
// and v must be 16-byte aligned. `chunk` rows a split, `ctas` the split
// launch's grid; scratch: f32 [2 + d] * slots * heads * ceil(mb * bs /
// chunk), as ops/flash_attention.py `_paged_plan` sizes it; work: null, or
// int32 [2] to which the split adds its CTAs that took an item and the
// items they took. Returns a cudaError_t.
extern "C" int decode_attention_paged_f32(const void* q, const void* k,
                                          const void* v, const void* lengths,
                                          const void* tables, void* o,
                                          void* scratch, void* work,
                                          int slots, int heads, int d, int nb,
                                          int bs, int mb, int chunk, int ctas,
                                          void* stream) {
  return dispatch<float>(q, k, v, lengths, tables, o, scratch, work, slots,
                         heads, d, nb, bs, mb, chunk, ctas, stream);
}

extern "C" int decode_attention_paged_bf16(const void* q, const void* k,
                                           const void* v, const void* lengths,
                                           const void* tables, void* o,
                                           void* scratch, void* work,
                                           int slots, int heads, int d, int nb,
                                           int bs, int mb, int chunk, int ctas,
                                           void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, tables, o, scratch, work,
                                 slots, heads, d, nb, bs, mb, chunk, ctas,
                                 stream);
}
