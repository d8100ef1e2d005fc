// Fused 1x1 convolution + BN statistics (kernel B1) for Hopper (sm_90a),
// and its bf16 instantiation with a BN-apply + ReLU prologue (the probe
// T1).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_conv_bn.py
// `_pallas_1x1` (`_conv1x1_bn_kernel`): y = conv2d(x, w) for a 1x1,
// stride-1, unpadded, ungrouped filter, plus the per-output-channel
// sums of y and of y * y in the same pass. The TPU kernel transposes x
// to rows [N*H*W, C] and carries the sums across its sequential grid;
// here x is read in its native NCHW layout, Y[n] = W[O, C] . X[n][C, P]
// with P = H * W, so no transpose is needed, and the sums are per-CTA
// partials added by a second launch.
//
// The T1 instantiation (tools/fused_conv_bn_probe.py `fused_conv1x1_bn`)
// takes rows x [R, C] and w [C, O] in bf16 and computes
// y = relu(x * a + b) @ w with the prologue applied as the x tile is
// loaded; the same GEMM with other strides, chosen at compile time.
//
// Design. One CTA of 256 threads per 64 (output channels) x 64 (pixels)
// tile of one image; grid (pixel tiles, channel tiles, images). The
// CTA walks C in steps of 16: the next step's W and X elements are
// loaded into registers (masked to 0 past every edge) while the current
// step's tiles, in shared memory as f32, feed a 4 x 4 register tile of
// f32 FMAs per thread (SIMT: TF32 stays off, the port's f32 precision
// rule). The epilogue stores y and reduces the tile's y and y * y over
// its 64 pixels per channel (in registers, then across 16 lanes with
// shuffles) into a [tiles, O] partial buffer; masked pixels hold exact
// zeros and add nothing. A second launch adds each channel's partials
// in a fixed order, in double: no atomics, so two runs give the same
// bits.
//
// What bounds it on the H100: at ResNet-50's shapes f32 operations
// (2 R C O for R = N * P rows, 0.39 ms at 67 TFLOP/s for most shapes)
// except C = O = 64, which is bound by its bytes. This first version
// uses neither the tensor cores (TF32 would break the precision rule)
// nor cp.async/TMA; a 4 x 4 tile per thread reaches a fraction of the
// f32 peak, which the chip run measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;        // output channels per CTA
constexpr int kBN = 64;        // pixels (or rows) per CTA
constexpr int kBK = 16;        // input channels per step
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// NCHW: A(o, c) = w[o * C + c], B(c, p) = x[img][c * P + p],
//       Y(o, p) = y[img][o * P + p]                      (kernel B1)
// rows: A(o, c) = w[c * O + o], B(c, p) = x[p * C + c],
//       Y(o, p) = y[p * O + o], one image                 (probe T1)
template <typename T, bool NCHW, bool PROLOGUE>
__global__ void __launch_bounds__(kThreads)
conv1x1_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ pa, const T* __restrict__ pb,
                     T* __restrict__ y, float* __restrict__ part_s,
                     float* __restrict__ part_ss, int C, int P, int O) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int p0 = blockIdx.x * kBN, o0 = blockIdx.y * kBM;
  const size_t img = blockIdx.z;
  const T* xi = x + img * static_cast<size_t>(C) * P;
  T* yi = y + img * static_cast<size_t>(O) * P;

  // Which element of the 64 x 16 tiles each thread loads: consecutive
  // threads walk the contiguous axis of each operand.
  //   NCHW: A contiguous in c (o = t / 4, c = 4 (t % 4) + i),
  //         B contiguous in p (c = t / 16, p = 4 (t % 16) + i);
  //   rows: A contiguous in o (c = t / 16, o = 4 (t % 16) + i),
  //         B contiguous in c (p = t / 4, c = 4 (t % 4) + i).
  const int a_o = NCHW ? (t >> 2) : 4 * (t & 15);
  const int a_c = NCHW ? 4 * (t & 3) : (t >> 4);
  const int b_c = NCHW ? (t >> 4) : 4 * (t & 3);
  const int b_p = NCHW ? 4 * (t & 15) : (t >> 2);

  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + a_o + (NCHW ? 0 : i);
      const int c = k0 + a_c + (NCHW ? i : 0);
      float v = 0.f;
      if (o < O && c < C)
        v = to_f32(NCHW ? w[static_cast<size_t>(o) * C + c]
                        : w[static_cast<size_t>(c) * O + o]);
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + b_c + (NCHW ? 0 : i);
      const int p = p0 + b_p + (NCHW ? i : 0);
      float v = 0.f;
      if (c < C && p < P) {
        v = to_f32(NCHW ? xi[static_cast<size_t>(c) * P + p]
                        : xi[static_cast<size_t>(p) * C + c]);
        if constexpr (PROLOGUE) {
          // relu(x * a + b) in f32, one rounding per operation, then
          // rounded to T as the probe's activations are
          v = fmaxf(__fadd_rn(__fmul_rn(v, to_f32(pa[c])), to_f32(pb[c])),
                    0.f);
          v = to_f32(from_f32<T>(v));
        }
      }
      rb[i] = v;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[a_c + (NCHW ? i : 0)][a_o + (NCHW ? 0 : i)] = ra[i];
      Bs[b_c + (NCHW ? 0 : i)][b_p + (NCHW ? i : 0)] = rb[i];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < C; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < C) load(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: store y, then this tile's per-channel sums of y and y * y
  const size_t tile = img * gridDim.x + blockIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + 4 * ty + i;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * tx + j;
      if (o < O && p < P)
        yi[NCHW ? static_cast<size_t>(o) * P + p
                : static_cast<size_t>(p) * O + o] = from_f32<T>(acc[i][j]);
      s += acc[i][j];
      ss = fmaf(acc[i][j], acc[i][j], ss);
    }
    // lanes 0-15 of a warp share ty, as do lanes 16-31: xor 8, 4, 2, 1
    // stays inside each half
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (tx == 0 && o < O) {
      part_s[tile * O + o] = s;
      part_ss[tile * O + o] = ss;
    }
  }
}

// s[o] = sum over tiles of part_s[tile, o] (and ss alike), in a fixed
// order: 32 channels per CTA, 32 warps each summing every 32nd tile in
// double, then warp 0 adds the 32 partials in order.
__global__ void __launch_bounds__(1024)
stats_finish_kernel(const float* __restrict__ part_s,
                    const float* __restrict__ part_ss, float* __restrict__ s,
                    float* __restrict__ ss, int tiles, int O) {
  __shared__ double sh_s[32][33], sh_ss[32][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  double a = 0.0, q = 0.0;
  if (o < O) {
    for (int t = g; t < tiles; t += 32) {
      a += part_s[static_cast<size_t>(t) * O + o];
      q += part_ss[static_cast<size_t>(t) * O + o];
    }
  }
  sh_s[g][lane] = a;
  sh_ss[g][lane] = q;
  __syncthreads();
  if (g == 0 && o < O) {
    double ta = 0.0, tq = 0.0;
    for (int k = 0; k < 32; ++k) {
      ta += sh_s[k][lane];
      tq += sh_ss[k][lane];
    }
    s[o] = static_cast<float>(ta);
    ss[o] = static_cast<float>(tq);
  }
}

template <typename T, bool NCHW, bool PROLOGUE>
int launch(const T* x, const T* w, const T* pa, const T* pb, T* y,
           float* part_s, float* part_ss, float* s, float* ss, int n, int c,
           int p, int o, cudaStream_t stream) {
  const dim3 grid((p + kBN - 1) / kBN, (o + kBM - 1) / kBM, n);
  conv1x1_stats_kernel<T, NCHW, PROLOGUE><<<grid, kThreads, 0, stream>>>(
      x, w, pa, pb, y, part_s, part_ss, c, p, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n * static_cast<int>(grid.x);
  stats_finish_kernel<<<(o + 31) / 32, 1024, 0, stream>>>(part_s, part_ss,
                                                          s, ss, tiles, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel B1. x f32 [n, c, p] (NCHW with p = H * W), w f32 [o, c] ->
// y f32 [n, o, p], s and ss f32 [o]. part_s and part_ss are scratch of
// n * ceil(p / 64) * o floats each. Returns a cudaError_t.
extern "C" int conv_bn_stats_f32(const float* x, const float* w, float* y,
                                 float* part_s, float* part_ss, float* s,
                                 float* ss, int n, int c, int p, int o,
                                 void* stream) {
  return launch<float, true, false>(x, w, nullptr, nullptr, y, part_s,
                                    part_ss, s, ss, n, c, p, o,
                                    static_cast<cudaStream_t>(stream));
}

// Probe T1. x bf16 [r, c] rows, a and b bf16 [c], w bf16 [c, o] ->
// y = relu(x * a + b) @ w as bf16 [r, o], s and ss f32 [o] of the f32
// products. part_s and part_ss hold ceil(r / 64) * o floats each.
extern "C" int conv1x1_bn_relu_bf16(const __nv_bfloat16* x,
                                    const __nv_bfloat16* a,
                                    const __nv_bfloat16* b,
                                    const __nv_bfloat16* w, __nv_bfloat16* y,
                                    float* part_s, float* part_ss, float* s,
                                    float* ss, int r, int c, int o,
                                    void* stream) {
  return launch<__nv_bfloat16, false, true>(
      x, w, a, b, y, part_s, part_ss, s, ss, 1, c, r, o,
      static_cast<cudaStream_t>(stream));
}
