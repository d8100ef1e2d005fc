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
// What bounds it on the H100: at decode (m = 8) device-memory bytes, the
// int8 weight read once (two int8 operations per weight byte); at
// prefill (m = 128, 512) the bytes too (x f32, w int8, out f32), the
// int8 tensor cores' 1,979 TOP/s being a fifth of that time or less.
// Two paths, chosen per shape in Python (ops/quant_ops.py `_plan`):
//
// Decode (m <= 16; int8_matmul_kernel<1, 1, 8>). One CTA per 16 x 32
// output tile whose 8 warps split k, which keeps 8 independent streams
// of weight loads in flight per CTA; each warp runs m16n8k32 int8
// tensor-core MMAs (mma.sync ... .s32.s8.s8.s32) into int32 registers,
// and the warps' partial sums are added in shared memory, exact in any
// order. A prologue computes the per-row amax of the CTA's rows from the
// f32 rows; the x tile is quantized on its way into shared memory (rows
// past m are stored as 0 without a division), and the w tile [BK, BN] is
// stored transposed, [BN][BK], with a 4 x 4 byte transpose in registers,
// because the MMA's column-major B operand wants 4 consecutive k of one
// column in a 32-bit register. The next tile's global loads are issued
// into registers before the current tile's MMAs run.
//
// Prefill (m > 16). Two launches from the one C entry:
// * quantize_rows_kernel quantizes each row once (one CTA per row: the
//   amax, then quant4 over the row) into an int8 scratch [m_pad, k_pad]
//   with zero rows past m and zero columns past k, and its scales into
//   an f32 scratch [m_pad]. Before, every column CTA re-read and
//   re-divided its rows over all of k.
// * int8_gemm_kernel<WM, WN, MT, NTL> computes a BM x BN tile (tiles
//   from kPrefillTiles, by the id Python passes) with WM x WN warps, each
//   MT m16 x NTL n8 MMA tiles. k goes in kPBK = 128-byte tiles through
//   two shared-memory stages: the int8 x tile by 16-byte cp.async, the w
//   tile through registers (4 k rows x 16 columns a thread, 16-byte
//   loads) and the same exact 4 x 4 byte transpose into [BN][kPBK]; both
//   operands reach the MMA fragments by ldmatrix (non-transposed: 8 rows
//   of 16 bytes are an m16n8k32 fragment's k-contiguous bytes). Rows are
//   128 bytes of 8 16-byte chunks, the chunk index XORed with
//   (row ^ row >> 4) & 7, so ldmatrix's 8 rows and the transposed
//   stores of a warp hit distinct banks. The next tile's copies and
//   loads are in flight while the current tile's MMAs run; one barrier
//   per k tile. The weight stays [k, n] in memory: no transposed copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;            // k per tile
constexpr int kKW = kBK / 4;       // 32-bit words of 4 int8 per tile row
constexpr int kPad = 4;            // words of padding: conflict-free MMA loads
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

template <int WM, int WN, int WK>
__global__ void __launch_bounds__(WM * WN * WK * 32)
int8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int m, int k, int n, bool w_words, bool x_vec) {
  constexpr int BM = 16 * WM, BN = 32 * WN;
  constexpr int GT = WM * WN * 32;                // threads per k group
  constexpr int NT = GT * WK;
  constexpr int A_ITERS = BM * kKW / GT;          // 4-float groups / thread
  constexpr int B_ITERS = kKW * (BN / 4) / GT;    // 4x4 byte blocks / thread
  static_assert(A_ITERS * GT == BM * kKW, "A tile split");
  static_assert(B_ITERS * GT == kKW * (BN / 4), "B tile split");

  __shared__ float s_scale[BM];
  __shared__ uint32_t sA[WK][BM][kKW + kPad];   // quantized x, k contiguous
  __shared__ uint32_t sB[WK][BN][kKW + kPad];   // w transposed, k contiguous
  __shared__ int s_acc[BM][BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = tid / GT, gt = tid % GT;       // k group, thread in it
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // prologue: per-row scale over all of k, one warp per row
  for (int r = warp; r < BM; r += NT / 32) {
    const int gr = row0 + r;
    float amax = 0.f;
    if (gr < m) {
      const float* xr = x + static_cast<size_t>(gr) * k;
      if (x_vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 8
        for (int c = lane; c < k / 4; c += 32) {
          const float4 v = x4[c];
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                   fmaxf(fabsf(v.z), fabsf(v.w))));
        }
      } else {
#pragma unroll 4
        for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(xr[c]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) s_scale[r] = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
  }
  for (int i = tid; i < BM * BN; i += NT) s_acc[i / BN][i % BN] = 0;

  float xa[A_ITERS][4];
  uint32_t wb[B_ITERS][4];

  // global -> registers for this group's k tile starting at k0 (past k,
  // everything loads as 0)
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int g = gt + i * GT;
      const int r = g / kKW, kk = k0 + (g % kKW) * 4;
      const int gr = row0 + r;
      const float* xp = x + static_cast<size_t>(gr) * k + kk;
      if (x_vec) {
        // k % 4 == 0: a 4-float group is whole or wholly past k
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < m && kk < k) v = *reinterpret_cast<const float4*>(xp);
        xa[i][0] = v.x; xa[i][1] = v.y; xa[i][2] = v.z; xa[i][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xa[i][j] = (gr < m && kk + j < k) ? xp[j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int g = gt + i * GT;
      const int kq = g / (BN / 4), nq = g % (BN / 4);
      const int c = col0 + nq * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = k0 + kq * 4 + r;
        uint32_t v = 0;
        if (kr < k) {
          const int8_t* wr = w + static_cast<size_t>(kr) * n;
          if (w_words) {
            // n % 4 == 0: a column quad is whole or wholly past n
            if (c < n) v = *reinterpret_cast<const uint32_t*>(wr + c);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < n)
                v |= (static_cast<uint32_t>(wr[c + j]) & 0xffu) << (8 * j);
          }
        }
        wb[i][r] = v;   // byte j: w[kr][c + j]
      }
    }
  };

  // registers -> this group's shared tiles: quantize x, transpose w
  // 4 x 4 bytes
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int g = gt + i * GT;
      const int r = g / kKW;
      // rows past m (a tile holds m <= 16 of its 16 rows) are stored as
      // 0 without a division
      sA[kg][r][g % kKW] = row0 + r < m ? quant4(xa[i], s_scale[r]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int g = gt + i * GT;
      const int kq = g / (BN / 4), nq = g % (BN / 4);
      const uint32_t t0 = __byte_perm(wb[i][0], wb[i][1], 0x5140);
      const uint32_t t1 = __byte_perm(wb[i][0], wb[i][1], 0x7362);
      const uint32_t t2 = __byte_perm(wb[i][2], wb[i][3], 0x5140);
      const uint32_t t3 = __byte_perm(wb[i][2], wb[i][3], 0x7362);
      // word j: k rows kq*4 .. kq*4+3 of column nq*4 + j
      sB[kg][nq * 4 + 0][kq] = __byte_perm(t0, t2, 0x5410);
      sB[kg][nq * 4 + 1][kq] = __byte_perm(t0, t2, 0x7632);
      sB[kg][nq * 4 + 2][kq] = __byte_perm(t1, t3, 0x5410);
      sB[kg][nq * 4 + 3][kq] = __byte_perm(t1, t3, 0x7632);
    }
  };

  const int gw = gt >> 5;                        // warp within the group
  const int wm = gw / WN, wn = gw % WN;
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0;

  // group kg takes the k tiles kg, kg + WK, kg + 2 WK, ... into its own
  // shared tiles: a one-warp group syncs only itself, so the warps of a
  // decode CTA stream their k slices independently; a wider group runs
  // block-wide barriers, every group the same trip count
  auto group_sync = [] {
    if constexpr (GT == 32) __syncwarp(); else __syncthreads();
  };
  const int iters = ((k + kBK - 1) / kBK + WK - 1) / WK;
  load_tile(kg * kBK);
  __syncthreads();   // s_scale, s_acc
  for (int it = 0; it < iters; ++it) {
    store_tile();
    group_sync();
    if (it + 1 < iters) load_tile(((it + 1) * WK + kg) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int w0 = ks * 8;
      uint32_t a[4];
      a[0] = sA[kg][wm * 16 + g][w0 + t];
      a[1] = sA[kg][wm * 16 + g + 8][w0 + t];
      a[2] = sA[kg][wm * 16 + g][w0 + 4 + t];
      a[3] = sA[kg][wm * 16 + g + 8][w0 + 4 + t];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int nn = wn * 32 + f * 8 + g;
        mma_s8(acc[f], a, sB[kg][nn][w0 + t], sB[kg][nn][w0 + 4 + t]);
      }
    }
    group_sync();
  }

  // epilogue: the groups' int32 partial sums (integer adds, exact in any
  // order), then acc * x_scale * w_scale, in the reference's order
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      atomicAdd(&s_acc[wm * 16 + g + (i >= 2 ? 8 : 0)]
                      [wn * 32 + f * 8 + 2 * t + (i & 1)], acc[f][i]);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NT) {
    const int r = i / BN, gr = row0 + r, gc = col0 + i % BN;
    if (gr < m && gc < n)
      out[static_cast<size_t>(gr) * n + gc] = __fmul_rn(
          __fmul_rn(__int2float_rn(s_acc[r][i % BN]), s_scale[r]), ws[gc]);
  }
}

template <int WM, int WN, int WK>
cudaError_t launch(const float* x, const int8_t* w, const float* ws,
                   float* out, int m, int k, int n, cudaStream_t stream) {
  constexpr int BM = 16 * WM, BN = 32 * WN;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_matmul_kernel<WM, WN, WK><<<grid, WM * WN * WK * 32, 0, stream>>>(
      x, w, ws, out, m, k, n, n % 4 == 0, k % 4 == 0);
  return cudaGetLastError();
}

// ----------------------------------------------------------- prefill

constexpr int kPBK = 128;          // prefill k per tile, bytes; k_pad multiple
// tile id -> (BM, BN); ops/quant_ops.py PREFILL_TILES
constexpr int kPrefillTiles[][2] = {{64, 128}, {32, 64}};

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

// byte offset of 16-byte chunk `chunk` of 128-byte row `row`, swizzled
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kPBK + ((chunk ^ ((row ^ (row >> 4)) & 7)) << 4);
}

// xq[r] = the row's int8 quantization as 4-byte words, k_pad / 4 of
// them, zero past k and for r >= m; xs[r] its scale (1 for r >= m).
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ x, uint32_t* __restrict__ xq,
                     float* __restrict__ xs, int m, int k, int k_pad,
                     bool x_vec) {
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
// m, k, n >= 1 and |acc| <= k * 127 * 127 < 2**31. `tile` < 0 takes the
// decode path; else it indexes kPrefillTiles (BM, BN), and the scratch
// xq holds m_pad * k_pad bytes (m rounded up to BM, k to kPBK), then
// m_pad f32 scales, as ops/quant_ops.py `_plan` sizes it. Returns a
// cudaError_t.
extern "C" int int8_matmul(const void* x, const void* w, const void* w_scale,
                           void* out, void* scratch, int m, int k, int n,
                           int tile, void* stream) {
  constexpr int kNumTiles = sizeof(kPrefillTiles) / sizeof(kPrefillTiles[0]);
  if (m <= 0 || k <= 0 || n <= 0 || k > 133144 || tile >= kNumTiles)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sf = static_cast<const float*>(w_scale);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // decode-sized m: a 16 x 32 tile per CTA, its k split over 8 warps
  if (tile < 0) return launch<1, 1, 8>(xf, wq, sf, of, m, k, n, st);
  const int bm = kPrefillTiles[tile][0];
  const int m_pad = (m + bm - 1) / bm * bm;
  const int k_pad = (k + kPBK - 1) / kPBK * kPBK;
  auto* xq = static_cast<int8_t*>(scratch);
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
