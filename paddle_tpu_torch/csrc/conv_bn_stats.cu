// Fused 1x1 convolution + BN statistics (kernel B1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_conv_bn.py
// `_pallas_1x1` (`_conv1x1_bn_kernel`): y = conv2d(x, w) for a 1x1,
// stride-1, unpadded, ungrouped filter, plus the per-output-channel
// sums of y and of y * y in the same pass. The TPU kernel transposes x
// to rows [N*H*W, C] and carries the sums across its sequential grid.
// Here x stays NCHW: Y[O, R] = W[O, C] . X[C, R] over the R = N * P
// pixels of all images (P = H * W), the pixel axis flattened across
// images as the reference's rows are; column j of X is
// x[(j / P) C P + c P + j % P], and y is written back NCHW. The sums are
// per-CTA partials added by a last launch.
//
// What bounds it on the H100: f32 operations (2 R C O; 0.39 ms at
// 67 TFLOP/s for most ResNet-50 shapes), except C = O = 64, which is
// bound by its bytes. TF32 stays off (the port's precision rule), so
// this is an SIMT SGEMM with a reduction epilogue. Its design:
//
// * One C entry, three launches: W [O, C] is transposed once into a
//   zero-padded scratch Wt [C_pad, O_pad] (O contiguous, so a float4
//   read gives four output channels); the GEMM; the finish.
// * The GEMM's CTA computes a BM (channels) x BN (pixels) tile with
//   BM * BN / 64 threads, each an 8 x 8 register tile (rows 4 ty..+3 and
//   BM / 2 + 4 ty..+3, columns alike), so every k step reads four float4
//   from shared memory for 64 FMAs. The tile is chosen per shape in
//   Python (ops/conv_bn.py `_plan`), from kTiles.
// * A ring of kStages shared-memory stages, each kBK deep, filled by
//   cp.async: Wt rows in 16-byte copies; X rows in 16-byte copies when
//   P % 4 == 0 (a 4-aligned run of pixels never crosses an image), else
//   in 4-byte copies. Pixels past R and channels past C are zero-filled.
//   One barrier per k step.
// * Epilogue: y as float4 stores (4-byte when P % 4 != 0); each row's
//   sums of y and y * y over the tile's pixels (registers, then a
//   shuffle tree across the row's threads) into a [pixel tiles, O]
//   partial buffer, no atomics. Zero-filled pixels add exact zeros. The
//   finish (csrc/stats_finish.cuh, shared with T1) adds each channel's
//   partials in a fixed order in double, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "stats_finish.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; with
// `ok` false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- B1

constexpr int kBK = 16;        // input channels per stage; C_pad multiple
constexpr int kStages = 3;     // shared-memory ring depth
constexpr int kOAlign = 128;   // O_pad multiple: every tile's BM divides it
// tile id -> (BM output channels, BN pixels); ops/conv_bn.py B1_TILES
constexpr int kTiles[][2] = {{64, 128}, {128, 64}};

// Wt[c][o] = w[o][c] for c < C, o < O; 0 elsewhere in [C_pad, O_pad].
// 32 x 32 tiles through shared memory, reads and writes coalesced.
__global__ void __launch_bounds__(256)
w_transpose_kernel(const float* __restrict__ w, float* __restrict__ wt,
                   int C, int O, int C_pad, int O_pad) {
  __shared__ float t[32][33];
  const int o_b = blockIdx.x * 32, c_b = blockIdx.y * 32;
  const int lx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  for (int i = ly; i < 32; i += 8) {
    const int o = o_b + i, c = c_b + lx;
    t[i][lx] = (o < O && c < C) ? w[static_cast<size_t>(o) * C + c] : 0.f;
  }
  __syncthreads();
  for (int i = ly; i < 32; i += 8) {
    const int c = c_b + i, o = o_b + lx;
    if (c < C_pad) wt[static_cast<size_t>(c) * O_pad + o] = t[lx][i];
  }
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(BM * BN / 64)
conv1x1_f32_stats_kernel(const float* __restrict__ x,
                         const float* __restrict__ wt, float* __restrict__ y,
                         float* __restrict__ part_s,
                         float* __restrict__ part_ss, int C, int P, int O,
                         int C_pad, int O_pad, long long R, int o_tiles) {
  constexpr int TX = BN / 8, TY = BM / 8, NT = TX * TY;
  constexpr int A_ROW4 = BM / 4, B_ROW4 = BN / 4;   // float4s per k row
  constexpr int A_KSTEP = NT / A_ROW4, B_KSTEP = NT / B_ROW4;
  static_assert(NT % A_ROW4 == 0 && NT % B_ROW4 == 0, "tile split");
  static_assert(kBK % A_KSTEP == 0 && kBK % B_KSTEP == 0, "stage split");
  static_assert(32 % TX == 0, "a row's threads share a warp");

  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [kStages][kBK][BM]
  float* Bs = smem + kStages * kBK * BM;     // [kStages][kBK][BN]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int ot = blockIdx.x % o_tiles;
  const long long pt = blockIdx.x / o_tiles;
  const int o0 = ot * BM;
  const long long j0 = pt * BN;
  const long long CP = static_cast<long long>(C) * P;

  // the loads: this thread's float4 slot of each k row it stages
  const int a_m = 4 * (tid % A_ROW4), a_k = tid / A_ROW4;
  const int b_n = 4 * (tid % B_ROW4), b_k = tid / B_ROW4;
  // offset of x[img][0][p] for this thread's pixel column(s), -1 past R;
  // the 4-aligned run of VEC lies in one image
  long long xcol[VEC ? 1 : 4];
#pragma unroll
  for (int q = 0; q < (VEC ? 1 : 4); ++q) {
    const long long j = j0 + b_n + q;
    xcol[q] = j < R ? (j / P) * CP + j % P : -1;
  }

  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * kBK * BM;
    float* bs = Bs + stage * kBK * BN;
#pragma unroll
    for (int i = 0; i < kBK / A_KSTEP; ++i) {
      const int k = a_k + i * A_KSTEP;
      cp_async16(as + k * BM + a_m,
                 wt + static_cast<size_t>(k0 + k) * O_pad + o0 + a_m, true);
    }
#pragma unroll
    for (int i = 0; i < kBK / B_KSTEP; ++i) {
      const int k = b_k + i * B_KSTEP, c = k0 + k;
      const long long coff = static_cast<long long>(c) * P;
#pragma unroll
      for (int q = 0; q < (VEC ? 1 : 4); ++q) {
        const bool ok = c < C && xcol[q] >= 0;
        const float* src = ok ? x + xcol[q] + coff : x;
        if constexpr (VEC)
          cp_async16(bs + k * BN + b_n, src, ok);
        else
          cp_async4(bs + k * BN + b_n + q, src, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = C_pad / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed
    __syncthreads();                // and stage kt - 1 is free again
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBK);
    cp_async_commit();
    const float* as = As + (kt % kStages) * kBK * BM;
    const float* bs = Bs + (kt % kStages) * kBK * BN;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * BM + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * BM + BM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * BN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * BN + BN / 2 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: y, then each row's sums over this tile's pixels
  const long long OP = static_cast<long long>(O) * P;
  long long ycol[VEC ? 2 : 8];    // offset of y[img][0][p], -1 past R
#pragma unroll
  for (int q = 0; q < (VEC ? 2 : 8); ++q) {
    const int jl = VEC ? (q ? BN / 2 : 0) + 4 * tx
                       : (q < 4 ? 0 : BN / 2 - 4) + 4 * tx + q;
    const long long j = j0 + jl;
    ycol[q] = j < R ? (j / P) * OP + j % P : -1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
    if (o < O) {
      const size_t orow = static_cast<size_t>(o) * P;
      if constexpr (VEC) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (ycol[q] >= 0)
            *reinterpret_cast<float4*>(y + ycol[q] + orow) =
                make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                            acc[i][4 * q + 2], acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (ycol[q] >= 0) y[ycol[q] + orow] = acc[i][q];
      }
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += acc[i][j];
      ss = fmaf(acc[i][j], acc[i][j], ss);
    }
    // the row's TX threads are TX consecutive lanes of one warp
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (tx == 0 && o < O) {
      part_s[pt * O + o] = s;
      part_ss[pt * O + o] = ss;
    }
  }
}

template <int BM, int BN, bool VEC>
cudaError_t launch_b1(const float* x, const float* wt, float* y,
                      float* part_s, float* part_ss, int c, int p, int o,
                      int c_pad, int o_pad, long long r, int p_tiles,
                      cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kStages * kBK * (BM + BN);
  auto kernel = conv1x1_f32_stats_kernel<BM, BN, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int o_tiles = (o + BM - 1) / BM;
  kernel<<<o_tiles * p_tiles, BM * BN / 64, smem, stream>>>(
      x, wt, y, part_s, part_ss, c, p, o, c_pad, o_pad, r, o_tiles);
  return cudaGetLastError();
}

// tile id TILE of kTiles
template <int TILE>
cudaError_t launch_tile(bool vec, const float* x, const float* wt, float* y,
                      float* part_s, float* part_ss, int c, int p, int o,
                      int c_pad, int o_pad, long long r, int p_tiles,
                      cudaStream_t stream) {
  constexpr int BM = kTiles[TILE][0], BN = kTiles[TILE][1];
  static_assert(kOAlign % BM == 0, "O_pad must hold whole tiles");
  return vec ? launch_b1<BM, BN, true>(x, wt, y, part_s, part_ss, c, p, o,
                                       c_pad, o_pad, r, p_tiles, stream)
             : launch_b1<BM, BN, false>(x, wt, y, part_s, part_ss, c, p, o,
                                        c_pad, o_pad, r, p_tiles, stream);
}

}  // namespace

// Kernel B1. x f32 [n, c, p] (NCHW with p = H * W), w f32 [o, c] ->
// y f32 [n, o, p], s and ss f32 [o]. `tile` indexes kTiles (BM, BN).
// Scratch, sized by ops/conv_bn.py `_plan`: wt holds C_pad * O_pad
// floats (c rounded up to kBK, o to kOAlign); part_s and part_ss hold
// ceil(n p / BN) * o floats each. Returns a cudaError_t.
extern "C" int conv_bn_stats_f32(const float* x, const float* w, float* y,
                                 float* wt, float* part_s, float* part_ss,
                                 float* s, float* ss, int n, int c, int p,
                                 int o, int tile, void* stream) {
  constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);
  if (n <= 0 || c <= 0 || p <= 0 || o <= 0 || tile < 0 || tile >= kNumTiles)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int c_pad = (c + kBK - 1) / kBK * kBK;
  const int o_pad = (o + kOAlign - 1) / kOAlign * kOAlign;
  w_transpose_kernel<<<dim3(o_pad / 32, (c_pad + 31) / 32), 256, 0, st>>>(
      w, wt, c, o, c_pad, o_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long r = static_cast<long long>(n) * p;
  const int bn = kTiles[tile][1];
  const int p_tiles = static_cast<int>((r + bn - 1) / bn);
  // 16-byte pixel runs stay in one image and aligned when P % 4 == 0
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  static_assert(kNumTiles == 2, "one instantiation per tile");
  err = tile == 0 ? launch_tile<0>(vec, x, wt, y, part_s, part_ss, c, p, o,
                                   c_pad, o_pad, r, p_tiles, st)
                  : launch_tile<1>(vec, x, wt, y, part_s, part_ss, c, p, o,
                                   c_pad, o_pad, r, p_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish_kernel<<<(o + 31) / 32, 1024, 0, st>>>(part_s, part_ss, s,
                                                      ss, p_tiles, o);
  return static_cast<int>(cudaGetLastError());
}
