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
// Split (paged_split_kernel) and combine (paged_combine_kernel, launched
// from the same C entry as a programmatic dependent, so it is resident
// before the split ends): the body csrc/decode_split.cuh shares with B4,
// through PagedRows. The split writes each live chunk's partial to a
// scratch [slot, head, chunk]; the combine gives a warp to each
// (slot, head). Any BS >= 1 works: a row's block is c / BS. A bf16 pool
// is upcast to f32 as it is loaded, as the reference upcasts at the
// contraction. B4 makes the same partials and combines them in the same
// order inside its one launch; for B5 that design measured no faster
// than these two launches with PDL (PERF.md), so B5 keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "decode_split.cuh"

namespace {

using namespace decode_split;

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// partials of chunk j of (slot s, head h) at index (s * heads + h) * nc + j:
// pm, pl [slots * heads * nc], pacc [slots * heads * nc, D]
template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32, kCtasAnSm)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ lengths,
                   const int* __restrict__ tables, float* __restrict__ pm,
                   float* __restrict__ pl, float* __restrict__ pacc,
                   int* __restrict__ work, int slots, int heads, int nb,
                   int bs, int mb, int chunk, int nc, float scale) {
  __shared__ Shared<D> sh;
  griddep_launch_dependents();
  const int tid = threadIdx.x;
  const int cap = mb * bs, hd = heads * D;
  const PagedRows rows{tables, nb, bs, mb};
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
    float m, l, a;
    item_partial<D, T>(q, kp, vp, rows, s, h, c0, c1, hd, scale, sh, m, l,
                       a);
    if (tid < D) {
      const size_t pi = (static_cast<size_t>(s) * heads + h) * nc + j;
      pacc[pi * D + tid] = a;
      if (tid == 0) {
        pm[pi] = m;
        pl[pi] = l;
      }
    }
    __syncthreads();
  }
  count_work(work, done);
}

// o[s, h] from the live chunks' partials of (s, h), in chunk order; a
// warp per (slot, head)
template <int D>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ pm,
                     const float* __restrict__ pl,
                     const float* __restrict__ pacc,
                     const int* __restrict__ lengths, float* __restrict__ o,
                     int slots, int heads, int cap, int chunk, int nc) {
  griddep_wait();
  const int pair = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (pair >= slots * heads) return;
  const int s = pair / heads;
  const int n = (live_rows(lengths, s, cap) + chunk - 1) / chunk;
  combine_warp<D>(pm, pl, pacc, static_cast<size_t>(pair) * nc, n,
                  o + static_cast<size_t>(pair) * D, lane);
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
