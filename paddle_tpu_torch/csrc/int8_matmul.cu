// int8 weight compute (kernel B3) for Hopper (sm_90a): f32 activations
// times an int8 weight with per-output-channel scales.
//
// Replaces the Pallas kernel paddle_tpu/ops/quant_ops.py
// `_pallas_int8_matmul` (_dequant_matmul_kernel): x f32 [m, k] is
// quantized per row (scale = amax * f32(1 / 127), the reciprocal XLA
// compiles the reference's amax / 127 into; 1 for an all-zero row;
// q = clamp(rint(x / scale), -127, 127)), multiplied by w int8 [k, n]
// into int32, and written as f32 acc * x_scale[row] * w_scale[col].
// The int8 product is exact and every other step is one correctly
// rounded f32 operation (IEEE multiply and division, rintf, a float
// conversion, the epilogue's two multiplies in the reference's order; no
// fast math), so the output is bitwise equal to the plain version for
// any m, k, n >= 1.
//
// What bounds it on the H100: device-memory bytes. At decode (m <= 16)
// the int8 weight is read once, 2m int8 operations a byte, and the whole
// of a product is 4-64 MB: at 3.35 TB/s and ~0.7 us of DRAM latency the
// card needs ~2.3 MB of loads in flight, so the weight's loads must go
// out all at once across every SM; below 16 MB a product's time is then
// mostly the fixed cost of its launches and its chain of dependent steps
// (PERF.md). At prefill (m = 128, 512) the bytes too (x f32, w int8, out
// f32), the int8 tensor cores' 1,979 TOP/s being a fifth of that time or
// less. Both paths start with one launch of quantize_rows_kernel, which
// quantizes each row once (one CTA per row: the amax, then quant4 over
// the row) into an int8 scratch [m_pad, k_pad] with zero rows past m and
// zero columns past k, and its scales into an f32 scratch [m_pad].
// ops/quant_ops.py `_plan` sizes both and picks the path, tile and split
// count per shape.
//
// Decode (tile -1; int8_gemv_kernel<MR>): split-K. The weight is cut
// into kDecodeBN-column tiles and each tile's k into `splits` chunks of
// kc rows (a multiple of kDecodeStageK, at most kDecodeMaxKC), one CTA
// per (column tile, chunk): 512-1024 CTAs at the path's shapes, where
// one CTA per column tile gave 64 at n = 2048. A CTA's 4 warps each take
// 64-row sub-stages of the chunk; a lane loads 4 k rows x 16 columns
// with 16-byte streaming loads (2 lanes cover a row's 32 bytes),
// kDecodeDepth sub-stages ahead in registers, so a CTA has up to 32 KB
// in flight. The loads are issued before the kernel waits for the
// quantize launch (griddepcontrol.wait: the C entry launches it as a
// programmatic dependent, so it starts while the quantize pass runs).
// Each lane transposes its 4 x 4 byte blocks in registers into its
// warp's shared tile [32 columns][64 k], the MMA's column-major B operand
// (4 k of one column a word; 20-word rows, the second 16 columns 16
// words further, free of bank conflicts for the stores and the fragment
// reads), and the warp runs m16n8k32 int8 tensor-core MMAs (mma.sync
// ... .s32.s8.s8.s32) with x's quantized slice, copied once into shared
// memory by cp.async, as A (rows past m are zero; at m <= 8 the upper 8
// rows are skipped). The warps' int32 sums are added in shared memory.
// A column tile's CTAs are one thread block cluster (kDecodeMaxSplits at
// most, the portable size): each CTA but chunk 0's adds its sums into
// chunk 0's through distributed shared memory, after the cluster's
// first barrier (chunk 0's sums zeroed), then arrives at the second and
// leaves; chunk 0's CTA waits at it and applies acc * x_scale * w_scale.
// Integer sums are exact in any order, and no float is ever added
// atomically: the output is bitwise the plain version's. No global
// partials, fences or counters.
//
// Prefill (tile >= 0; int8_gemm_kernel<WM, WN, MT, NTL>) computes a
// BM x BN tile (tiles from kPrefillTiles, by the id Python passes) with
// WM x WN warps, each MT m16 x NTL n8 MMA tiles. k goes in kPBK = 128-byte
// tiles through two shared-memory stages: the int8 x tile by 16-byte
// cp.async, the w tile through registers (4 k rows x 16 columns a thread,
// 16-byte loads) and the same exact 4 x 4 byte transpose into
// [BN][kPBK]; both operands reach the MMA fragments by ldmatrix
// (non-transposed: 8 rows of 16 bytes are an m16n8k32 fragment's
// k-contiguous bytes). Rows are 128 bytes of 8 16-byte chunks, the chunk
// index XORed with (row ^ row >> 4) & 7, so ldmatrix's 8 rows and the
// transposed stores of a warp hit distinct banks. The next tile's copies
// and loads are in flight while the current tile's MMAs run; one barrier
// per k tile. The weight stays [k, n] in memory: no transposed copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time

__device__ __forceinline__ uint32_t quant4(const float v[4], float scale) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r = rintf(__fdiv_rn(v[i], scale));
    r = fminf(fmaxf(r, -127.f), 127.f);
    const int q = __float2int_rn(r);
    word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
  }
  return word;
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// a thread block cluster's barrier in two halves: arrive (release) and
// wait (acquire), so that work can go on between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// programmatic dependent launch: a dependent grid may start once every
// CTA of this one has called launch_dependents; its wait returns when
// this grid has finished and its writes are visible (both no-ops for a
// grid launched without the attribute)
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// xq[r] = the row's int8 quantization as 4-byte words, k_pad / 4 of
// them, zero past k and for r >= m; xs[r] its scale (1 for r >= m).
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ x, uint32_t* __restrict__ xq,
                     float* __restrict__ xs, int m, int k, int k_pad,
                     bool x_vec) {
  griddep_launch_dependents();
  __shared__ float s_amax[8];
  const int r = blockIdx.x, tid = threadIdx.x, kw = k_pad / 4;
  uint32_t* qr = xq + static_cast<size_t>(r) * kw;
  if (r >= m) {
    for (int c = tid; c < kw; c += 256) qr[c] = 0u;
    if (tid == 0) xs[r] = 1.f;
    return;
  }
  const float* xr = x + static_cast<size_t>(r) * k;
  float amax = 0.f;
  if (x_vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 8
    for (int c = tid; c < k / 4; c += 256) {
      const float4 v = x4[c];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int c = tid; c < k; c += 256) amax = fmaxf(amax, fabsf(xr[c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) s_amax[tid >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, s_amax[i]);
  const float scale = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
#pragma unroll 4
  for (int c = tid; c < kw; c += 256) {
    const int kk = 4 * c;
    float v[4];
    if (x_vec && kk < k) {
      // k % 4 == 0: a 4-float group is whole or wholly past k
      const float4 f = reinterpret_cast<const float4*>(xr)[c];
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = kk + j < k ? xr[kk + j] : 0.f;
    }
    qr[c] = quant4(v, scale);
  }
  if (tid == 0) xs[r] = scale;
}

// ------------------------------------------------------------ decode

constexpr int kDecodeBN = 32;        // output columns per CTA
constexpr int kDecodeWarps = 4;      // a CTA's warps
constexpr int kDecodeStageK = 256;   // k rows of one sub-stage: 64 a warp
constexpr int kDecodeMaxKC = 2048;   // k rows per chunk at most
constexpr int kDecodeMaxSplits = 8;  // chunks a column tile: its cluster
constexpr int kDecodeDepth = 4;      // sub-stages of loads a warp keeps ahead
constexpr int kColW = 20;            // words per column of a warp's tile
constexpr int kTileW = kDecodeBN * kColW + 16;

// word offset of column c's row in a warp's transposed tile: 16 words of
// k and 4 of padding a column, columns 16-31 16 words further, so a
// warp's stores (2 groups x 16 k words) and its fragment reads (8
// columns x 4 k words) each fall in 32 distinct banks
__device__ __forceinline__ int col_off(int c) {
  return c * kColW + ((c >> 4) << 4);
}

// out[:, col0:col0 + 32] for k chunk blockIdx.y of `kc` rows, from xq
// [MR, k_pad] (MR = 8 for m <= 8, else 16) and its scales xs [MR], which
// the quantize launch this one is a programmatic dependent of writes:
// the CTAs of a column tile (chunks 0 .. splits - 1) are one thread
// block cluster, which adds their int32 sums through distributed shared
// memory.
template <int MR>
__global__ void __launch_bounds__(kDecodeWarps * 32)
int8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ ws,
                 float* __restrict__ out, int m, int k, int n, int k_pad,
                 int kc, bool w_vec) {
  constexpr int NT = kDecodeWarps * 32;
  extern __shared__ __align__(16) uint8_t sx[];   // [MR][kc + 16]
  __shared__ uint32_t sw[kDecodeWarps][kTileW];
  __shared__ int s_acc[MR][kDecodeBN];
  __shared__ float s_scale[MR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kDecodeBN, split = blockIdx.y;
  const int splits = gridDim.y;
  const int k0 = split * kc, kend = min(k0 + kc, k);
  const int nsub = (kend - k0 + kDecodeStageK - 1) / kDecodeStageK;
  // this lane's unit of a sub-stage: k rows 4 rq .. 4 rq + 3 of the
  // warp's 64, columns bc .. bc + 15 (a warp-wide load: 16 rows x 32 B)
  const int rq = lane >> 1, bc = col0 + 16 * (lane & 1);
  const cg::cluster_group cluster = cg::this_cluster();

  uint32_t wr[kDecodeDepth][4][4];   // [slot][k row][word of 4 columns]
  auto load = [&](uint32_t (&r)[4][4], int s) {
    const int kb = k0 + s * kDecodeStageK + warp * 64 + 4 * rq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = kb + i;
      const int8_t* row = w + static_cast<size_t>(kr) * n;
      if (w_vec) {
        // n % 16 == 0: a 16-column group is whole or wholly past n
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kr < kend && bc < n)
          v = __ldcs(reinterpret_cast<const uint4*>(row + bc));
        r[i][0] = v.x; r[i][1] = v.y; r[i][2] = v.z; r[i][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = bc + 4 * q + j;
            if (kr < kend && c < n)
              word |= (static_cast<uint32_t>(row[c]) & 0xffu) << (8 * j);
          }
          r[i][q] = word;
        }
      }
    }
  };

  // the weight's loads go out before the wait for the quantize launch
#pragma unroll
  for (int p = 0; p < kDecodeDepth; ++p)
    if (p < nsub) load(wr[p], p);
  const int xrow = kc + 16;          // bytes: 4 words of padding a row
  for (int i = tid; i < MR * kDecodeBN; i += NT)
    s_acc[i / kDecodeBN][i % kDecodeBN] = 0;
  __syncthreads();
  // the cluster's first barrier: chunk 0's sums are zero before another
  // chunk adds into them; its wait comes after the MMAs
  cluster_arrive();
  griddep_wait();
  for (int i = tid; i < MR * (kc / 16); i += NT) {
    const int r = i / (kc / 16), ch = i % (kc / 16);
    cp_async16(sx + r * xrow + 16 * ch,
               xq + static_cast<size_t>(r) * k_pad + k0 + 16 * ch);
  }
  if (tid < MR) s_scale[tid] = xs[tid];
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t* sx32 = reinterpret_cast<const uint32_t*>(sx);
  const int xw = xrow / 4;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* tile = sw[warp];
  int acc[kDecodeBN / 8][4];
#pragma unroll
  for (int f = 0; f < kDecodeBN / 8; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0;

  for (int s0 = 0; s0 < nsub; s0 += kDecodeDepth) {
#pragma unroll
    for (int p = 0; p < kDecodeDepth; ++p) {
      const int s = s0 + p;
      if (s >= nsub) break;
      // w transposed 4 x 4 bytes: the word of k rows 4 rq .. 4 rq + 3 of
      // each of the unit's 16 columns
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t t0 = __byte_perm(wr[p][0][q], wr[p][1][q], 0x5140);
        const uint32_t t1 = __byte_perm(wr[p][0][q], wr[p][1][q], 0x7362);
        const uint32_t t2 = __byte_perm(wr[p][2][q], wr[p][3][q], 0x5140);
        const uint32_t t3 = __byte_perm(wr[p][2][q], wr[p][3][q], 0x7362);
        const int c = 16 * (lane & 1) + 4 * q;
        tile[col_off(c + 0) + rq] = __byte_perm(t0, t2, 0x5410);
        tile[col_off(c + 1) + rq] = __byte_perm(t0, t2, 0x7632);
        tile[col_off(c + 2) + rq] = __byte_perm(t1, t3, 0x5410);
        tile[col_off(c + 3) + rq] = __byte_perm(t1, t3, 0x7632);
      }
      __syncwarp();
      if (s + kDecodeDepth < nsub) load(wr[p], s + kDecodeDepth);
      const int w0 = (s * kDecodeStageK + warp * 64) / 4;   // x word
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kw = w0 + ks * 8;
        uint32_t a[4];
        a[0] = sx32[g * xw + kw + t];
        a[2] = sx32[g * xw + kw + 4 + t];
        a[1] = MR == 16 ? sx32[(g + 8) * xw + kw + t] : 0u;
        a[3] = MR == 16 ? sx32[(g + 8) * xw + kw + 4 + t] : 0u;
#pragma unroll
        for (int f = 0; f < kDecodeBN / 8; ++f) {
          const int o = col_off(f * 8 + g) + ks * 8 + t;
          mma_s8(acc[f], a, tile[o], tile[o + 4]);
        }
      }
      __syncwarp();
    }
  }

  // the warps' int32 sums (exact in any order)
#pragma unroll
  for (int f = 0; f < kDecodeBN / 8; ++f) {
    const int c = f * 8 + 2 * t;
    atomicAdd(&s_acc[g][c], acc[f][0]);
    atomicAdd(&s_acc[g][c + 1], acc[f][1]);
    if (MR == 16) {
      atomicAdd(&s_acc[g + 8][c], acc[f][2]);
      atomicAdd(&s_acc[g + 8][c + 1], acc[f][3]);
    }
  }
  // the cluster's chunks: each other CTA adds its sums into chunk 0's
  // through distributed shared memory (integer adds, exact in any
  // order), then arrives; chunk 0's CTA waits for all and applies acc *
  // x_scale * w_scale, in the reference's order, reading the weight
  // scales before it waits. No CTA reads another's shared memory after
  // its last arrival, so the others leave at once
  constexpr int kOut = MR * kDecodeBN / NT;
  __syncthreads();
  cluster_wait();
  if (split > 0) {
    int* acc0 = cluster.map_shared_rank(&s_acc[0][0], 0);
    for (int e = tid; e < m * kDecodeBN; e += NT)
      atomicAdd(acc0 + e, (&s_acc[0][0])[e]);
  }
  cluster_arrive();
  if (split > 0) return;
  float wsc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int gc = col0 + (tid + i * NT) % kDecodeBN;
    wsc[i] = gc < n ? ws[gc] : 0.f;
  }
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int e = tid + i * NT;
    const int r = e / kDecodeBN, gc = col0 + e % kDecodeBN;
    if (r < m && gc < n)
      out[static_cast<size_t>(r) * n + gc] = __fmul_rn(
          __fmul_rn(__int2float_rn((&s_acc[0][0])[e]), s_scale[r]), wsc[i]);
  }
}

// the split-K launch: a cluster of `splits` CTAs a column tile, and a
// programmatic dependent of the quantize launch before it on the stream
template <int MR>
cudaError_t launch_decode(const int8_t* xq, const float* xs, const int8_t* w,
                          const float* ws, float* out, int m, int k, int n,
                          int k_pad, int kc, int splits, cudaStream_t stream) {
  auto kernel = int8_gemv_kernel<MR>;
  // x's slice, up to MR x (kDecodeMaxKC + 16) bytes, with the static
  // tiles past the 48 KB default at MR = 16
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MR * (kDecodeMaxKC + 16));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kDecodeBN - 1) / kDecodeBN, splits);
  cfg.blockDim = dim3(kDecodeWarps * 32);
  cfg.dynamicSmemBytes = static_cast<size_t>(MR) * (kc + 16);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = splits;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, xq, xs, w, ws, out, m, k, n, k_pad,
                            kc, n % 16 == 0);
}

// ----------------------------------------------------------- prefill

constexpr int kPBK = 128;          // prefill k per tile, bytes; k_pad multiple
// tile id -> (BM, BN); ops/quant_ops.py PREFILL_TILES
constexpr int kPrefillTiles[][2] = {{64, 128}, {32, 64}};

// byte offset of 16-byte chunk `chunk` of 128-byte row `row`, swizzled
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kPBK + ((chunk ^ ((row ^ (row >> 4)) & 7)) << 4);
}

// out[row0:, col0:] tile of xq [m_pad, k_pad] . w [k, n], scaled. xq's
// rows and k_pad columns are whole tiles; w is masked past k and n.
template <int WM, int WN, int MT, int NTL>
__global__ void __launch_bounds__(WM * WN * 32)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ ws,
                 float* __restrict__ out, int m, int k, int n, int k_pad,
                 bool w_vec) {
  constexpr int BM = WM * MT * 16, BN = WN * NTL * 8, NT = WM * WN * 32;
  constexpr int A_CHUNKS = BM * (kPBK / 16) / NT;   // per thread per tile
  static_assert(A_CHUNKS * NT == BM * (kPBK / 16), "A tile split");
  static_assert((kPBK / 4) * (BN / 16) == NT, "one w unit per thread");
  static_assert(NTL % 2 == 0, "B fragments come in n16 pairs");

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sA = smem;                    // [2][BM][kPBK], swizzled
  uint8_t* sB = smem + 2 * BM * kPBK;    // [2][BN][kPBK], swizzled

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // this thread's w unit: k rows 4 kq .. 4 kq + 3, columns 16 nq .. +15
  const int nq = tid % (BN / 16), kq = tid / (BN / 16);
  const int bc = col0 + 16 * nq;

  auto load_a = [&](int stage, int k0) {
    uint8_t* base = sA + stage * BM * kPBK;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int q = tid + i * NT, r = q >> 3, ch = q & 7;
      cp_async16(base + swz(r, ch),
                 xq + static_cast<size_t>(row0 + r) * k_pad + k0 + 16 * ch);
    }
  };
  uint32_t wr[4][4];   // [k row][word]: byte j of word v is column 4 v + j
  auto load_b = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kr = k0 + 4 * kq + r;
      const int8_t* row = w + static_cast<size_t>(kr) * n;
      if (w_vec) {
        // n % 16 == 0: a 16-column group is whole or wholly past n
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kr < k && bc < n) v = *reinterpret_cast<const uint4*>(row + bc);
        wr[r][0] = v.x; wr[r][1] = v.y; wr[r][2] = v.z; wr[r][3] = v.w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = bc + 4 * v + j;
            if (kr < k && c < n)
              word |= (static_cast<uint32_t>(row[c]) & 0xffu) << (8 * j);
          }
          wr[r][v] = word;
        }
      }
    }
  };
  // w transposed 4 x 4 bytes: the word of k rows 4 kq .. 4 kq + 3 of
  // each of the unit's 16 columns, into its row of sB
  auto store_b = [&](int stage) {
    uint8_t* base = sB + stage * BN * kPBK;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t t0 = __byte_perm(wr[0][v], wr[1][v], 0x5140);
      const uint32_t t1 = __byte_perm(wr[0][v], wr[1][v], 0x7362);
      const uint32_t t2 = __byte_perm(wr[2][v], wr[3][v], 0x5140);
      const uint32_t t3 = __byte_perm(wr[2][v], wr[3][v], 0x7362);
      const uint32_t col[4] = {
          __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = 16 * nq + 4 * v + j;
        *reinterpret_cast<uint32_t*>(base + swz(nn, kq >> 2) +
                                     4 * (kq & 3)) = col[j];
      }
    }
  };

  int acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = k_pad / kPBK;
  load_a(0, 0);
  cp_async_commit();
  load_b(0);
  store_b(0);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    __syncthreads();   // stage st is whole; stage st ^ 1 is free
    const bool more = kt + 1 < KT;
    if (more) {
      load_a(st ^ 1, (kt + 1) * kPBK);
      cp_async_commit();
      load_b((kt + 1) * kPBK);
    }
    const uint8_t* a_s = sA + st * BM * kPBK;
    const uint8_t* b_s = sB + st * BN * kPBK;
#pragma unroll
    for (int ks = 0; ks < kPBK / 32; ++ks) {
      uint32_t af[MT][4], bf[NTL][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // matrices: rows 0-7 / 8-15 of the m16 tile, k bytes 0-15 / 16-31
        const int r = (wm * MT + i) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(af[i], a_s + swz(r, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NTL; j += 2) {
        // matrices: n 0-7 k 0-15, n 0-7 k 16-31, n 8-15 k 0-15, n 8-15
        // k 16-31 of an n16 pair
        const int r = (wn * NTL + j) * 8 + (lane & 7) + (lane >> 4) * 8;
        uint32_t b4[4];
        ldsm_x4(b4, b_s + swz(r, 2 * ks + ((lane >> 3) & 1)));
        bf[j][0] = b4[0];
        bf[j][1] = b4[1];
        bf[j + 1][0] = b4[2];
        bf[j + 1][1] = b4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if (more) store_b(st ^ 1);
  }

  // epilogue: acc * x_scale * w_scale, in the reference's order
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + (wm * MT + i) * 16 + g + 8 * h;
      if (gr >= m) continue;
      const float sx = xs[gr];
      float* orow = out + static_cast<size_t>(gr) * n;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int gc = col0 + (wn * NTL + j) * 8 + 2 * t;
        const float v0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h]), sx), ws[gc < n ? gc : 0]);
        if (gc + 1 < n) {
          const float v1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sx), ws[gc + 1]);
          if (n % 2 == 0) {
            *reinterpret_cast<float2*>(orow + gc) = make_float2(v0, v1);
          } else {
            orow[gc] = v0;
            orow[gc + 1] = v1;
          }
        } else if (gc < n) {
          orow[gc] = v0;
        }
      }
    }
  }
}

// tile id TILE of kPrefillTiles, as WM x WN warps of MT x NTL MMA tiles
template <int TILE, int WM, int WN, int MT, int NTL>
cudaError_t launch_prefill(const int8_t* xq, const float* xs,
                           const int8_t* w, const float* ws, float* out,
                           int m, int k, int n, int k_pad,
                           cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NTL * 8;
  static_assert(kPrefillTiles[TILE][0] == BM && kPrefillTiles[TILE][1] == BN,
                "the warp layout must give the tile");
  constexpr int smem = 2 * (BM + BN) * kPBK;
  auto kernel = int8_gemm_kernel<WM, WN, MT, NTL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(xq, xs, w, ws, out, m, k, n,
                                               k_pad, n % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous f32 [m, k]; w: contiguous int8 [k, n]; w_scale: f32 [n];
// out: contiguous f32 [m, n]. Every pointer must be 16-byte aligned;
// m, k, n >= 1 and |acc| <= k * 127 * 127 < 2**31. `tile` -1 takes the
// decode path (m <= 16) in `splits` <= kDecodeMaxSplits chunks of k of at
// most kDecodeMaxKC rows; a tile >= 0 indexes kPrefillTiles (BM, BN), and
// `splits` is 1. The scratch holds xq, m_pad * k_pad bytes (decode: m_pad
// 8 or 16, k_pad splits * kc; prefill: m rounded up to BM, k to kPBK),
// then m_pad f32 scales, as ops/quant_ops.py `_plan` sizes it. Returns a
// cudaError_t.
extern "C" int int8_matmul(const void* x, const void* w, const void* w_scale,
                           void* out, void* scratch, int m, int k, int n,
                           int tile, int splits, void* stream) {
  constexpr int kNumTiles = sizeof(kPrefillTiles) / sizeof(kPrefillTiles[0]);
  if (m <= 0 || k <= 0 || n <= 0 || k > 133144 || tile >= kNumTiles ||
      splits < 1)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sf = static_cast<const float*>(w_scale);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(scratch);
  if (tile < 0) {
    // kc: the chunk's k rows, whole sub-stages; no chunk may be empty
    const int kc = (k + splits * kDecodeStageK - 1) /
                   (splits * kDecodeStageK) * kDecodeStageK;
    if (m > 16 || tile != -1 || splits > kDecodeMaxSplits ||
        kc > kDecodeMaxKC || (k + kc - 1) / kc != splits)
      return cudaErrorInvalidValue;
    const int m_pad = m <= 8 ? 8 : 16, k_pad = splits * kc;
    auto* xs = reinterpret_cast<float*>(xq + static_cast<size_t>(m_pad) * k_pad);
    quantize_rows_kernel<<<m_pad, 256, 0, st>>>(
        xf, reinterpret_cast<uint32_t*>(xq), xs, m, k, k_pad, k % 4 == 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (m_pad == 8)
      return launch_decode<8>(xq, xs, wq, sf, of, m, k, n, k_pad, kc, splits,
                              st);
    return launch_decode<16>(xq, xs, wq, sf, of, m, k, n, k_pad, kc, splits,
                             st);
  }
  if (splits != 1) return cudaErrorInvalidValue;
  const int bm = kPrefillTiles[tile][0];
  const int m_pad = (m + bm - 1) / bm * bm;
  const int k_pad = (k + kPBK - 1) / kPBK * kPBK;
  auto* xs = reinterpret_cast<float*>(xq + static_cast<size_t>(m_pad) * k_pad);
  quantize_rows_kernel<<<m_pad, 256, 0, st>>>(
      xf, reinterpret_cast<uint32_t*>(xq), xs, m, k, k_pad, k % 4 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(kNumTiles == 2, "one instantiation per tile");
  if (tile == 0)
    return launch_prefill<0, 2, 4, 2, 4>(xq, xs, wq, sf, of, m, k, n, k_pad,
                                         st);
  return launch_prefill<1, 2, 2, 1, 4>(xq, xs, wq, sf, of, m, k, n, k_pad, st);
}
