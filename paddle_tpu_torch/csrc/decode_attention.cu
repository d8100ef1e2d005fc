// Single-query decode attention against a dense KV cache, f32 or bf16
// cache storage with f32 queries, outputs and arithmetic, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `decode_attention` (_decode_forward / _decode_body): one query row per
// (slot, head) attends cache rows c < length[slot] with an online
// softmax; rows at or past the length are neither read nor computed.
//
// What bounds it on the H100: device-memory bytes, each live K and V row
// read once (two flops a byte): 25 MB (f32) or 12 MB (bf16) a call at the
// dense cell's lengths, 7.5 or 3.7 us at 3.35 TB/s, over 8 slots of very
// different lengths. One CTA per (slot, head) walking all of its rows
// left the card idle while the longest slot's CTAs finished.
//
// Design: B5's split-key body (csrc/decode_split.cuh) through DenseRows,
// in one launch. The cache is read in its native [S, C, H * D] layout
// (row c of slot s at s * C + c, the head a column offset), so no
// transpose copy is made. The work items (chunk, slot, head) of a grid
// fixed by C each make a chunk's partial (m, l, acc); a slot of one live
// chunk writes its output at once (finish_one), a slot of length 0 gets
// zeros from the CTA that takes its chunk 0, and otherwise each item
// stores its partial in the scratch and adds 1 to its (slot, head)'s
// counter after a fence: the CTA that sees the last count combines the
// slot's chunks in chunk order (combine_warp) and sets the counter back
// to 0, so every counter is 0 between calls. The counters live in a
// zeroed buffer of their own (ops/_build.py `counters`), never in the
// scratch that other kernels share. Chunks, batches and rows are cut by
// logical row and the combine is B5's, so on the same logical rows B4's
// output is bitwise equal to B5's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "decode_split.cuh"

namespace {

using namespace decode_split;

// partials of chunk j of (slot s, head h) at index (s * heads + h) * nc + j:
// pm, pl [slots * heads * nc], pacc [slots * heads * nc, D]; counters
// [slots * heads], 0 on entry and on exit
template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32, kCtasAnSm)
dense_decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    float* __restrict__ o, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc,
                    int* __restrict__ counters, int* __restrict__ work,
                    int slots, int heads, int c, int chunk, int nc,
                    float scale) {
  __shared__ Shared<D> sh;
  __shared__ int last;
  const int tid = threadIdx.x;
  const int hd = heads * D;
  const DenseRows rows{c};
  const int items = nc * slots * heads;
  int done = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int j = item / (slots * heads);
    const int s = item / heads % slots;
    const int h = item % heads;
    const int pair = s * heads + h;
    const int len = live_rows(lengths, s, c);
    const int c0 = j * chunk;
    const int c1 = min(c0 + chunk, len);
    float* out = o + static_cast<size_t>(pair) * D;
    if (c0 >= c1) {
      if (len == 0 && j == 0 && tid < D) out[tid] = 0.f;
      continue;
    }
    ++done;
    float m, l, a;
    item_partial<D, T>(q, kc, vc, rows, s, h, c0, c1, hd, scale, sh, m, l, a);
    const int n = (len + chunk - 1) / chunk;
    if (n == 1) {
      if (tid < D) out[tid] = finish_one(m, l, a);
      __syncthreads();
      continue;
    }
    const size_t pi = static_cast<size_t>(pair) * nc + j;
    if (tid < D) {
      pacc[pi * D + tid] = a;
      if (tid == 0) {
        pm[pi] = m;
        pl[pi] = l;
      }
      __threadfence();   // the partial is visible before the count
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(counters + pair, 1) == n - 1;
    __syncthreads();
    if (last) {
      __threadfence();   // the other chunks' partials, seen after the count
      if (tid < 32)
        combine_warp<D>(pm, pl, pacc, static_cast<size_t>(pair) * nc, n, out,
                        tid);
      if (tid == 0) counters[pair] = 0;
    }
    __syncthreads();
  }
  count_work(work, done);
}

template <int D, typename T>
cudaError_t launch(const float* q, const T* k, const T* v,
                   const int* lengths, float* o, float* scratch,
                   int* counters, int* work, int slots, int heads, int c,
                   int chunk, int ctas, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int nc = (c + chunk - 1) / chunk;
  const size_t parts = static_cast<size_t>(slots) * heads * nc;
  float* pm = scratch;
  float* pl = pm + parts;
  float* pacc = pl + parts;
  dense_decode_kernel<D, T><<<ctas, kWarps * 32, 0, stream>>>(
      q, k, v, lengths, o, pm, pl, pacc, counters, work, slots, heads, c,
      chunk, nc, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* o, void* scratch, void* counters, void* work, int slots,
             int heads, int d, int c, int chunk, int ctas, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  if (c <= 0 || chunk <= 0 || ctas <= 0) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* ln = static_cast<const int*>(lengths);
  auto* of = static_cast<float*>(o);
  auto* sc = static_cast<float*>(scratch);
  auto* cn = static_cast<int*>(counters);
  auto* wk = static_cast<int*>(work);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64, T>(qf, kt, vt, ln, of, sc, cn, wk, slots, heads, c,
                           chunk, ctas, st);
    case 128:
      return launch<128, T>(qf, kt, vt, ln, of, sc, cn, wk, slots, heads, c,
                            chunk, ctas, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous f32 [slots, heads * d]; k, v: contiguous [slots, c,
// heads * d] caches, f32 (decode_attention_f32) or bf16
// (decode_attention_bf16); lengths: int32 [slots], live cache rows per
// slot (clamped into [0, c]; a slot of length 0 gets zeros). q, o, k and
// v must be 16-byte aligned. `chunk` rows a work item, `ctas` the grid;
// scratch: f32 [2 + d] * slots * heads * ceil(c / chunk), as
// ops/flash_attention.py `_split_plan` sizes it; counters: int32
// [slots * heads], all 0 (the kernel leaves them 0); work: null, or int32
// [2] to which the kernel adds its CTAs that took an item and the items
// they took. One launch. Returns a cudaError_t.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* scratch, void* counters,
                                    void* work, int slots, int heads, int d,
                                    int c, int chunk, int ctas, void* stream) {
  return dispatch<float>(q, k, v, lengths, o, scratch, counters, work, slots,
                         heads, d, c, chunk, ctas, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, void* scratch, void* counters,
                                     void* work, int slots, int heads, int d,
                                     int c, int chunk, int ctas,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, o, scratch, counters, work,
                                 slots, heads, d, c, chunk, ctas, stream);
}
