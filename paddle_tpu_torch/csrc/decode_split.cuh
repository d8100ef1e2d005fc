// The split-key body that kernels B4 (csrc/decode_attention.cu, a dense
// cache) and B5 (csrc/decode_attention_paged.cu, a paged pool) share, for
// Hopper (sm_90a).
//
// One query row per (slot, head) attends the slot's logical cache rows
// c < length[slot]. Each slot's logical rows are cut into chunks of
// `chunk` rows (ops/flash_attention.py `_split_plan`); a work item is one
// (chunk, slot, head), and the CTAs of a fixed grid take items
// blockIdx.x, + gridDim.x, ..., chunk-major, skipping those past the
// slot's length (the grid depends on the cache's width, never on
// host-side lengths). In an item, the kWarps warps take batches of rows;
// a lane loads 16 bytes of a row of K and of V (4 f32 or 8 bf16
// elements: one row is a warp at f32 D = 128, half a warp at bf16),
// Pack<T>::kLoads rows of each in flight before any is used. The dot
// products are reduced across a row's lanes, the batch's max across the
// warp, and each warp keeps an online softmax (m, l, acc[D]); the warps
// are combined in shared memory in warp order into the chunk's partial
// (m, l, acc). The chunks' partials are combined in chunk order by one
// warp (combine_warp): m = max m_j, l = sum l_j exp(m_j - m), acc alike,
// then acc / max(l, 1e-30), the reference's _finish.
//
// Only the address of a logical row differs between the two kernels
// (DenseRows, PagedRows); every boundary (chunk, batch, row within a
// batch) is a logical row index, and every multiply that meets an add is
// written with a rounding intrinsic or fmaf, so the compiler contracts
// nothing differently in the two instantiations. Hence B4 on a dense
// cache is bitwise equal to B5 on a pool that holds the same logical
// rows, and a slot's output depends on its q, its live rows and its
// length alone. No float is added atomically.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace decode_split {

constexpr int kWarps = 8;          // warps a CTA
constexpr int kCtasAnSm = 1;       // the split kernels' __launch_bounds__ floor
// 16-byte K and V loads a lane keeps in flight, by cache dtype
constexpr int kLoadsF32 = 8;
constexpr int kLoadsBF16 = 4;
constexpr int kCombineBatch = 8;   // chunks' partials a combine warp loads at once
constexpr float kNeg = -1e30f;     // the masking constant of the TPU kernel

// 16 bytes of a cache row (4 f32 or 8 bf16) -> E floats
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int E = 4;
  static constexpr int kLoads = kLoadsF32;
  static __device__ __forceinline__ void unpack(const uint4& u, float* r) {
    r[0] = __uint_as_float(u.x); r[1] = __uint_as_float(u.y);
    r[2] = __uint_as_float(u.z); r[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int E = 8;
  static constexpr int kLoads = kLoadsBF16;
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

__device__ __forceinline__ int live_rows(const int* lengths, int s, int cap) {
  return min(max(lengths[s], 0), cap);
}

// Row address maps: the cache row (of H * D elements) that holds logical
// row c of slot s.
struct DenseRows {   // [S, C, H * D]: slot s, row c
  int c;
  __device__ __forceinline__ size_t operator()(int s, int row) const {
    return static_cast<size_t>(s) * c + row;
  }
};
struct PagedRows {   // [NB, BS, H * D] through tables [S, MB], clamped into [0, NB)
  const int* tables;
  int nb, bs, mb;
  __device__ __forceinline__ size_t operator()(int s, int row) const {
    const int b = min(max(__ldg(tables + static_cast<size_t>(s) * mb +
                                row / bs), 0), nb - 1);
    return static_cast<size_t>(b) * bs + row % bs;
  }
};

template <int D>
struct Shared {
  float m[kWarps], l[kWarps];
  float acc[kWarps][D];
};

// The partial (m, l, acc) of logical rows [c0, c1) of (slot s, head h),
// c0 < c1: on return thread tid < D holds m, l and acc[tid]. Ends with
// the shared state read; the caller syncs before the next item.
template <int D, typename T, typename Rows>
__device__ __forceinline__ void item_partial(
    const float* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, Rows rows, int s, int h, int c0, int c1,
    int hd, float scale, Shared<D>& sh, float& m_out, float& l_out,
    float& a_out) {
  constexpr int E = Pack<T>::E;          // elements a lane loads of a row
  constexpr int L = Pack<T>::kLoads;     // rows a lane loads a batch
  constexpr int LPR = D / E;             // lanes a row
  constexpr int RPL = 32 / LPR;          // rows a warp-wide load
  constexpr int RB = RPL * L;            // rows a warp's batch
  static_assert(D <= kWarps * 32, "the warps' combine takes a thread a column");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_in = lane / LPR, col = (lane % LPR) * E;
  const size_t hcol = static_cast<size_t>(h) * D + col;

  float qv[E];
  {
    const float4* q4 = reinterpret_cast<const float4*>(
        q + static_cast<size_t>(s) * hd + hcol);
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
    uint4 kr[L], vr[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int c = base + u * RPL + row_in;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < c1) {
        const size_t off = rows(s, c) * hd + hcol;
        kr[u] = __ldcs(reinterpret_cast<const uint4*>(kc + off));
        vr[u] = __ldcs(reinterpret_cast<const uint4*>(vc + off));
      }
    }
    float sc[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
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
      for (int u = 0; u < L; ++u)
        sc[u] = __fadd_rn(sc[u], __shfl_xor_sync(0xffffffffu, sc[u], off));
    float mx = kNeg;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      sc[u] = base + u * RPL + row_in < c1 ? __fmul_rn(sc[u], scale) : kNeg;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(__fsub_rn(m, m_new));
    l = __fmul_rn(l, alpha);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], alpha);
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (base + u * RPL + row_in < c1) {
        const float p = expf(__fsub_rn(sc[u], m_new));
        float vf[E];
        Pack<T>::unpack(vr[u], vf);
        l = __fadd_rn(l, p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
      }
    }
    m = m_new;
  }
  // the warp's rows: add the row groups' sums (m is the warp's own)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = __fadd_rn(acc[e], __shfl_xor_sync(0xffffffffu, acc[e], off));
  }
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < E; ++e) sh.acc[warp][col + e] = acc[e];
  }
  if (lane == 0) {
    sh.m[warp] = m;
    sh.l[warp] = l;
  }
  __syncthreads();
  // the warps, in warp order
  if (tid < D) {
    float mall = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mall = fmaxf(mall, sh.m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(__fsub_rn(sh.m[w], mall));
      lsum = fmaf(sh.l[w], f, lsum);
      a = fmaf(sh.acc[w][tid], f, a);
    }
    m_out = mall;
    l_out = lsum;
    a_out = a;
  }
}

// acc / max(l, 1e-30): the reference's _finish
__device__ __forceinline__ float finish(float a, float lsum) {
  return a / fmaxf(lsum, 1e-30f);
}

// One chunk's term of the combine: its weight exp(m_j - m)
__device__ __forceinline__ float chunk_weight(float mj, float mall) {
  return expf(__fsub_rn(mj, mall));
}

// The output of a slot with a single live chunk from that chunk's
// partial, with the very operations combine_warp does for n = 1.
__device__ __forceinline__ float finish_one(float m0, float l0, float a0) {
  const float f = chunk_weight(m0, fmaxf(kNeg, m0));
  return finish(fmaf(a0, f, 0.f), fmaf(l0, f, 0.f));
}

// out[0 .. D) of one (slot, head) from its n live chunks' partials at
// pm, pl [base + j] and pacc [(base + j) * D + ...], in chunk order; one
// warp, lane `lane` writing columns lane * D / 32 ... The maxima are read
// a lane a chunk and the sums kCombineBatch chunks at a time, so a slot
// of many chunks costs a few L2 round trips, not one a chunk. Reads
// through L2 (other CTAs wrote the partials).
template <int D>
__device__ __forceinline__ void combine_warp(const float* pm, const float* pl,
                                             const float* pacc, size_t base,
                                             int n, float* out, int lane) {
  constexpr int V = D / 32;
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
        const float f = chunk_weight(mj[u], mall);
        lsum = fmaf(lj[u], f, lsum);
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = fmaf(aj[u][i], f, a[i]);
      }
    }
  }
  float* o = out + lane * V;
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = finish(a[i], lsum);
}

// Given a counter (the probes' and chip_smoke.py's reading of the
// split), each CTA that took an item adds 1 to work[0] and its items to
// work[1].
__device__ __forceinline__ void count_work(int* work, int done) {
  if (work != nullptr && threadIdx.x == 0 && done > 0) {
    atomicAdd(work, 1);
    atomicAdd(work + 1, done);
  }
}

}  // namespace decode_split
