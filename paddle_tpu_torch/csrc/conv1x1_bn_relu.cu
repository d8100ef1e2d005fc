// A 1x1 convolution over bf16 rows with the BN-apply + ReLU of its input
// in the prologue and the BN statistics of its output in the epilogue,
// on the tensor cores of Hopper (sm_90a): the probe T1.
//
// Replaces the Pallas kernel tools/fused_conv_bn_probe.py
// `fused_conv1x1_bn` (`_kernel`): x [R, C] raw pre-BN activations, a and
// b [C] the folded BN scale and shift of this layer, w [C, O]:
// z = relu(x * a + b), y = z @ w with f32 sums, stored in bf16, and the
// per-output-channel sums of y and y * y of the f32 product, for the
// next layer's BN.
//
// What bounds it on the H100: device-memory bytes. At the probe's three
// ResNet-50 cases (R = 256 H W, O = 4 C) y is four times x; x and y are
// 128-514 MB a call, 0.04-0.15 ms at 3.35 TB/s, against 26 GFLOP of bf16
// products, 0.027 ms at 989 TFLOP/s. So x is read from device memory
// once, z is computed once, y is written once in 16-byte stores, and the
// products run on the tensor cores.
//
// Design:
// * A CTA of 8 warps owns a tile of kT1BM rows and walks O in tiles of
//   kT1BN columns (ops/conv_bn.py T1_TILE). It loads its x tile with 16-byte
//   cp.async into XOR-swizzled shared memory (16-byte chunk i of row r
//   at i ^ (r & 7)), applies the prologue in place (f32 __fmul_rn then
//   __fadd_rn, ReLU, rounded to bf16: no FMA contraction; rows past R
//   and channels past C as 0, since relu(b) @ w would not be 0), and
//   keeps that z tile while it walks every O tile of BN columns.
// * W [C, O] is read from L2 (32 KB - 512 KB): each O tile's [C, BN]
//   panel by cp.async into a second swizzled buffer, the next panel's
//   copy in flight while the current one is multiplied.
// * Products: mma.sync m16n8k16 bf16 x bf16 -> f32, A (z) by ldmatrix,
//   B (w, [k, n] rows) by ldmatrix.trans; a warp owns 32 rows x BN / WN
//   columns. Channels go in chunks of kT1KC when C is wider, the z tile
//   then rebuilt for each chunk of each O tile.
// * Epilogue: the accumulators' column sums of y and y * y over the
//   warp's rows by shuffles, then over the CTA's row warps in order into
//   one partial per (row tile, column); padded rows add exact zeros, and
//   padded columns are not written. y goes to shared memory as bf16
//   (into the panel buffer just used), then out in 16-byte stores, a
//   row's columns by consecutive threads. A last launch adds each
//   column's partials in a fixed order in double, so two runs give the
//   same bits; no float is added atomically.
// * VEC (C and O multiples of 8, pointers 16-byte aligned) takes the
//   16-byte copies and stores; any other R, C, O >= 1 takes element-wise
//   loads and stores into the same layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "stats_finish.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT1Threads = 256;   // 8 warps
constexpr int kT1KC = 256;        // input channels a z tile holds
// rows and output columns a CTA's tile; ops/conv_bn.py T1_TILE
constexpr int kT1BM = 128;
constexpr int kT1BN = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with `ok` false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of 16-byte chunk `ch` of row `r` in a swizzled tile of
// `row_elems` bf16 a row (a multiple of 64)
__device__ __forceinline__ int swz(int r, int ch, int row_elems) {
  return r * row_elems + ((ch ^ (r & 7)) << 3);
}

__device__ __forceinline__ float prologue(float x, float a, float b) {
  // relu(x * a + b) in f32, one rounding per operation
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

// Sums over the 8 lanes of one t4 (lane bits 2-4, the mma accumulator's
// row groups) of each of v[0 .. V), scattered: three rounds of halving
// exchanges (xor 16, 8, 4), each lane keeping the half its lane bit
// names, so 7 V / 8 shuffles in all instead of 3 V. On return v[0 ..
// V / 8) holds the sums of v[base ...], base = (V / 2) b4 + (V / 4) b3 +
// (V / 8) b2 for the lane's bits b4, b3, b2.
template <int V>
__device__ __forceinline__ void reduce_scatter8(float (&v)[V], int lane) {
  static_assert(V % 8 == 0, "three halvings");
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int n = V >> round, half = n / 2;
    const bool upper = (lane >> (4 - round)) & 1;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = __fadd_rn(keep,
                       __shfl_xor_sync(0xffffffffu, send, 16 >> round));
    }
  }
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kT1Threads)
conv1x1_bn_relu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pa,
                       const bf16* __restrict__ pb, const bf16* __restrict__ w,
                       bf16* __restrict__ y, float* __restrict__ part_s,
                       float* __restrict__ part_ss, int R, int C, int O,
                       int zrow, int wbuf) {
  constexpr int WM = BM / 32, WN = 8 / WM;    // warps along rows, columns
  constexpr int WCOLS = BN / WN, NT = WCOLS / 8;
  static_assert(WM * WN == 8 && NT % 2 == 0, "warp tiling");
  constexpr int BNCH = BN / 8;                // 16-byte chunks a y/w row

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);   // [BM][zrow]
  bf16* wb0 = zs + BM * zrow;                 // 2 x [C16][BN] panels, or y [BM][BN]
  float* s_sum = reinterpret_cast<float*>(wb0 + 2 * wbuf);  // [WM][BN]
  float* s_sq = s_sum + WM * BN;
  float* s_a = s_sq + WM * BN;                // [kT1KC], then s_b
  float* s_b = s_a + kT1KC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int nkc = (C + kT1KC - 1) / kT1KC;
  const int n_ot = (O + BN - 1) / BN;

  // the z tile of channel chunk kc: x copied in, then the prologue
  auto load_x = [&](int kc) {
    const int k0 = kc * kT1KC, kl = min(kT1KC, C - k0);
    const int chs = (kl + 15) / 16 * 2;      // chunks the k steps read
    for (int i = tid; i < chs * 8; i += kT1Threads) {
      s_a[i] = i < kl ? __bfloat162float(pa[k0 + i]) : 0.f;
      s_b[i] = i < kl ? __bfloat162float(pb[k0 + i]) : 0.f;
    }
    for (int i = tid; i < BM * chs; i += kT1Threads) {
      const int r = i / chs, ch = i % chs;
      const long long gr = row0 + r;
      const int c = k0 + ch * 8;
      bf16* dst = zs + swz(r, ch, zrow);
      if constexpr (VEC) {
        const bool ok = gr < R && c < C;
        cp_async16(dst, ok ? x + gr * C + c : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < R && c + e < C) ? x[gr * C + c + e]
                                         : __float2bfloat16(0.f);
      }
    }
  };
  // z = relu(x * a + b) in place; a row past R as 0 (relu(b) is not),
  // a channel past C as 0 (x, a and b are 0 there)
  auto apply_prologue = [&](int kc) {
    const int kl = min(kT1KC, C - kc * kT1KC);
    const int chs = (kl + 15) / 16 * 2;
    for (int i = tid; i < BM * chs; i += kT1Threads) {
      const int r = i / chs, ch = i % chs;
      uint4* p = reinterpret_cast<uint4*>(zs + swz(r, ch, zrow));
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < R) {
        u = *p;
        const float4* a4 = reinterpret_cast<const float4*>(s_a + ch * 8);
        const float4* b4 = reinterpret_cast<const float4*>(s_b + ch * 8);
        const float4 av[2] = {a4[0], a4[1]}, bv[2] = {b4[0], b4[1]};
        const float* af = reinterpret_cast<const float*>(av);
        const float* bf = reinterpret_cast<const float*>(bv);
        uint32_t* wds = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
          const __nv_bfloat162 z = __floats2bfloat162_rn(
              prologue(v.x, af[2 * e], bf[2 * e]),
              prologue(v.y, af[2 * e + 1], bf[2 * e + 1]));
          wds[e] = *reinterpret_cast<const uint32_t*>(&z);
        }
      }
      *p = u;
    }
  };
  // the [k, BN] panel of w for channel chunk kc and O tile ot
  auto load_w = [&](int t, bf16* dst_base) {
    const int ot = t / nkc, kc = t % nkc;
    const int k0 = kc * kT1KC, kl = min(kT1KC, C - k0);
    const int rows = (kl + 15) / 16 * 16;
    const int o0 = ot * BN;
    for (int i = tid; i < rows * BNCH; i += kT1Threads) {
      const int k = i / BNCH, ch = i % BNCH;
      const int c = k0 + k, o = o0 + ch * 8;
      bf16* dst = dst_base + swz(k, ch, BN);
      if constexpr (VEC) {
        const bool ok = k < kl && o < O;
        cp_async16(dst, ok ? w + static_cast<size_t>(c) * O + o : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (k < kl && o + e < O) ? w[static_cast<size_t>(c) * O + o + e]
                                         : __float2bfloat16(0.f);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  if (nkc == 1) load_x(0);
  load_w(0, wb0);
  cp_async_commit();
  if (nkc == 1) {
    cp_async_wait_all();
    __syncthreads();
    apply_prologue(0);
  }

  const int stages = n_ot * nkc;
  const int g = lane >> 2, t4 = lane & 3;
  for (int t = 0; t < stages; ++t) {
    const int ot = t / nkc, kc = t % nkc;
    cp_async_wait_all();   // this stage's panel has landed
    __syncthreads();       // and the last stage is done with both buffers
    if (nkc > 1) {
      load_x(kc);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      apply_prologue(kc);
      __syncthreads();
    }
    if (t + 1 < stages) {
      load_w(t + 1, wb0 + ((t + 1) & 1) * wbuf);
      cp_async_commit();
    }
    const bf16* wcur = wb0 + (t & 1) * wbuf;
    const int kl = min(kT1KC, C - kc * kT1KC);
    const int ksteps = (kl + 15) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], zs + swz(r, ks * 2 + (lane >> 4), zrow));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * WCOLS + np * 16 + (lane >> 4) * 8;
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, wcur + swz(k, n >> 3, BN));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    if (kc != nkc - 1) continue;

    // epilogue of O tile ot
    __syncthreads();       // every warp is done reading this panel
    bf16* ys = wb0 + (t & 1) * wbuf;  // [BM][BN], swizzled
    float cs[2 * NT], css[2 * NT];    // this thread's rows' column sums
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int col = wn * WCOLS + nj * 8 + 2 * t4;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(acc[mi][nj][0], acc[mi][nj][1]);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(acc[mi][nj][2], acc[mi][nj][3]);
        *reinterpret_cast<__nv_bfloat162*>(ys + swz(r, col >> 3, BN) +
                                           (col & 7)) = lo;
        *reinterpret_cast<__nv_bfloat162*>(ys + swz(r + 8, col >> 3, BN) +
                                           (col & 7)) = hi;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f, ss = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float v0 = acc[mi][nj][e], v1 = acc[mi][nj][2 + e];
          s = __fadd_rn(__fadd_rn(s, v0), v1);
          ss = fmaf(v1, v1, fmaf(v0, v0, ss));
        }
        cs[2 * nj + e] = s;
        css[2 * nj + e] = ss;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
    // the columns over the warp's 32 rows, a lane left with 2 NT / 8 of
    // them: column pair index base + j = 2 nj + e
    reduce_scatter8(cs, lane);
    reduce_scatter8(css, lane);
    {
      const int base = (NT * ((lane >> 4) & 1)) + (NT / 2) * ((lane >> 3) & 1) +
                       (NT / 4) * ((lane >> 2) & 1);
#pragma unroll
      for (int j = 0; j < NT / 4; ++j) {
        const int nj = (base + j) >> 1, e = (base + j) & 1;
        const int col = wn * WCOLS + nj * 8 + 2 * t4 + e;
        s_sum[wm * BN + col] = cs[j];
        s_sq[wm * BN + col] = css[j];
      }
    }
    __syncthreads();
    const int o0 = ot * BN;
    for (int i = tid; i < BM * BNCH; i += kT1Threads) {
      const int r = i / BNCH, ch = i % BNCH;
      const long long gr = row0 + r;
      const int o = o0 + ch * 8;
      if (gr >= R) continue;
      const bf16* src = ys + swz(r, ch, BN);
      if constexpr (VEC) {
        if (o < O)
          __stcs(reinterpret_cast<uint4*>(y + gr * O + o),
                 *reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (o + e < O) y[gr * O + o + e] = src[e];
      }
    }
    if (tid < BN && o0 + tid < O) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int m = 0; m < WM; ++m) {
        s = __fadd_rn(s, s_sum[m * BN + tid]);
        ss = __fadd_rn(ss, s_sq[m * BN + tid]);
      }
      const size_t pi = static_cast<size_t>(blockIdx.x) * O + o0 + tid;
      part_s[pi] = s;
      part_ss[pi] = ss;
    }
  }
}

// shared memory of a BM x BN launch at C channels: the z tile (rows of
// C rounded up to 64, at most kT1KC), two panel buffers (a [C16, BN] w
// panel or the [BM, BN] y tile), the row warps' column sums, a and b in
// f32
struct Smem {
  int zrow, wbuf;
  size_t bytes;
};

template <int BM, int BN>
Smem smem_of(int c) {
  const int kc = c < kT1KC ? c : kT1KC;
  Smem m;
  m.zrow = (kc + 63) / 64 * 64;
  const int krows = (kc + 15) / 16 * 16;
  m.wbuf = krows * BN > BM * BN ? krows * BN : BM * BN;
  m.bytes = sizeof(bf16) * (static_cast<size_t>(BM) * m.zrow + 2 * m.wbuf) +
            sizeof(float) * (2 * (BM / 32) * BN + 2 * kT1KC);
  return m;
}

template <int BM, int BN, bool VEC>
cudaError_t launch_t1(const bf16* x, const bf16* a, const bf16* b,
                      const bf16* w, bf16* y, float* part_s, float* part_ss,
                      int r, int c, int o, int row_tiles,
                      cudaStream_t stream) {
  auto kernel = conv1x1_bn_relu_kernel<BM, BN, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_of<BM, BN>(kT1KC).bytes));
  if (attr != cudaSuccess) return attr;
  const Smem m = smem_of<BM, BN>(c);
  kernel<<<row_tiles, kT1Threads, m.bytes, stream>>>(
      x, a, b, w, y, part_s, part_ss, r, c, o, m.zrow, m.wbuf);
  return cudaGetLastError();
}

}  // namespace

// Probe T1. x bf16 [r, c] rows, a and b bf16 [c], w bf16 [c, o] ->
// y = relu(x * a + b) @ w as bf16 [r, o], s and ss f32 [o] of the f32
// products. part_s and part_ss hold ceil(r / kT1BM) * o floats each, as
// ops/conv_bn.py `_t1_plan` sizes them. Any r, c, o >= 1. Returns a
// cudaError_t.
extern "C" int conv1x1_bn_relu_bf16(const bf16* x, const bf16* a,
                                    const bf16* b, const bf16* w, bf16* y,
                                    float* part_s, float* part_ss, float* s,
                                    float* ss, int r, int c, int o,
                                    void* stream) {
  if (r <= 0 || c <= 0 || o <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (r + kT1BM - 1) / kT1BM;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = c % 8 == 0 && o % 8 == 0 && aligned(x) && aligned(w) &&
                   aligned(y);
  const cudaError_t err =
      vec ? launch_t1<kT1BM, kT1BN, true>(x, a, b, w, y, part_s, part_ss, r,
                                          c, o, row_tiles, st)
          : launch_t1<kT1BM, kT1BN, false>(x, a, b, w, y, part_s, part_ss, r,
                                           c, o, row_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish_kernel<<<(o + 31) / 32, 1024, 0, st>>>(part_s, part_ss, s,
                                                      ss, row_tiles, o);
  return static_cast<int>(cudaGetLastError());
}
