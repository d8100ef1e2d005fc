// Flash attention forward (prefill and training), f32 and bf16, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py
// `flash_attention` (_forward / _body): softmax(Q K^T * d^-1/2 + mask) V
// over [BH, T, D] with an online softmax, causal masking, and the
// segment-id mask (a key is attendable iff its id equals the query's and
// is nonzero; a query row with no attendable key writes 0). Any T works:
// rows and keys past T are zero-filled and masked. Causal key tiles above
// the diagonal are never loaded, and the grid walks the q tiles from the
// last (the heaviest under causal) to the first, so the last wave is the
// lightest. No atomics: the output is bitwise repeatable.
//
// bf16 (flash_fwd_bf16_kernel). The reference's kernel body runs both
// dots at Precision.DEFAULT, which on its own chip's matrix unit is one
// bf16 pass with f32 sums, QK^T and PV alike. This kernel does the same
// on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32, fed by
// ldmatrix (.trans for V's [key, d] rows). Each warp owns 16 query rows;
// the f32 score accumulator stays in registers, is scaled by d^-1/2 in
// f32 after the product, masked with -1e30, and its probabilities become
// the A fragment of the PV product in registers (f32 pairs rounded to
// bf16x2, nearest even), with no shared-memory round trip. The running
// max and sum stay f32; the output is acc / max(l, 1e-30) rounded to bf16.
// K/V tiles are staged with cp.async into two buffers, so the next tile
// loads during the current one's MMAs; rows are padded by 16 bytes so
// ldmatrix reads are free of bank conflicts. Every tile of the T2 sweep,
// {32, 64, 128}^2 at D 128, and 64 x 64 at D 64, is an instantiation.
// What bounds it: not device memory (each K/V tile is read once per q
// tile, mostly from L2) and not the tensor cores' rate, but the work
// around the MMAs: every warp reads the whole K and V tile through
// ldmatrix, and the online softmax (scale, mask, max, exponentials,
// rescale) runs on the CUDA cores for each score. BK 32 keeps the most
// blocks resident (128 registers a thread) and is the path's tile.
//
// f32 (flash_fwd_f32_kernel). TF32 stays off (the port's precision
// rule), so both products are f32 FMAs on the CUDA cores, and the kernel
// is bound by those operations (67 TFLOP/s). It is laid out as an SGEMM:
// 128 threads own a 32-row q tile, each thread a 4 x 4 register tile of
// scores (rows 4 ty.., keys 4 tx..) and a 4 x D/16 tile of the output.
// Q and K are stored d-major in shared memory (K's 4-key groups
// XOR-swizzled by d % 8, so both the transposing 4-byte cp.async writes
// and the float4 reads are free of bank conflicts), so the inner loop
// reads 4 rows and 4 keys with two float4 loads per 16 FMAs; the
// probabilities go through shared memory to the PV loop, which reads 4
// keys of p and of V per float4. K and V are staged with cp.async: the
// next K tile loads during the current softmax and PV, the next V tile
// during the next QK^T, which keeps a block at 88 KB of shared memory and
// two blocks on an SM. 32-row tiles give [1, 16, 512, 128] 256 blocks,
// all resident at once on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;  // the masking constant of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

// wait until at most N committed groups are still in flight
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

// two f32 -> bf16x2 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d ** -0.5 rounded once to f32, as the reference multiplies it in
template <int D>
float softmax_scale() {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

// ---------------------------------------------------------------- bf16

template <int D, int BQ, int BK>
struct Bf16Cfg {
  static constexpr int kThreads = BQ / 16 * 32;  // a warp per 16 rows
  static constexpr int LD = D + 8;  // row stride (elements): +16 bytes
  static constexpr int kQ = BQ * LD;
  static constexpr int kKV = BK * LD;
  // Q, K[2], V[2] (bf16) and the key ids of both stages
  static constexpr int kSmem = 2 * (kQ + 4 * kKV) + 4 * 2 * BK;
};

// Rows [r0, r0 + R) of a row-major [t, D] bf16 matrix into a shared tile
// of row stride D + 8, in 16-byte cp.async copies; rows at or past t are
// zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int t, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  constexpr int LD = D + 8;
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (R * CH % NT == 0 || i < R * CH) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < t;
      cp_async16(dst + r * LD + c,
                 src + static_cast<size_t>(ok ? r0 + r : 0) * D + c, ok);
    }
  }
}

// the key ids of keys [k0, k0 + BK), 0 past t
template <int BK, int NT>
__device__ __forceinline__ void stage_ids(int* dst, const int* seg_row,
                                          int k0, int t, int tid) {
  for (int i = tid; i < BK; i += NT) {
    const bool ok = k0 + i < t;
    cp_async4(dst + i, seg_row + (ok ? k0 + i : 0), ok);
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ seg, bf16* __restrict__ o,
                      int t, int heads, float scale, int causal) {
  using Cfg = Bf16Cfg<D, BQ, BK>;
  constexpr int LD = Cfg::LD, NT = Cfg::kThreads;
  constexpr int NJ = BK / 8;  // 8-key column tiles of a warp's scores
  constexpr int ND = D / 8;   // 8-wide column tiles of its output
  static_assert(NJ % 2 == 0 && ND % 2 == 0 && BQ % 16 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + Cfg::kQ;                       // [2][BK][LD]
  bf16* vs = ks + 2 * Cfg::kKV;                  // [2][BK][LD]
  int* ids = reinterpret_cast<int*>(vs + 2 * Cfg::kKV);  // [2][BK]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row, column pair
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int* seg_row =
      seg ? seg + static_cast<size_t>(bh / heads) * t : nullptr;
  const bf16 *qg = q + base, *kg = k + base, *vg = v + base;

  const int kend = causal ? min(t, q0 + BQ) : t;
  const int ntiles = (kend + BK - 1) / BK;
  stage_rows<BQ, D, NT>(qs, qg, q0, t, tid);
  stage_rows<BK, D, NT>(ks, kg, 0, t, tid);
  stage_rows<BK, D, NT>(vs, vg, 0, t, tid);
  if (seg_row) stage_ids<BK, NT>(ids, seg_row, 0, t, tid);
  cp_async_commit();

  // this thread's two rows: fragment rows g and g + 8 of its warp
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  int sq0 = 0, sq1 = 0;
  if (seg_row) {
    sq0 = row0 < t ? seg_row[row0] : 0;
    sq1 = row1 < t ? seg_row[row1] : 0;
  }
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix lane addresses (elements) inside a tile
  const bf16* qa = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LD + (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nk0 = (it + 1) * BK;
      stage_rows<BK, D, NT>(ks + (buf ^ 1) * Cfg::kKV, kg, nk0, t, tid);
      stage_rows<BK, D, NT>(vs + (buf ^ 1) * Cfg::kKV, vg, nk0, t, tid);
      if (seg_row)
        stage_ids<BK, NT>(ids + (buf ^ 1) * BK, seg_row, nk0, t, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) has landed for every thread
    const bf16* kb = ks + buf * Cfg::kKV;
    const bf16* vb = vs + buf * Cfg::kKV;
    const int* kid = ids + buf * BK;
    const int k0 = it * BK;

    // S = Q K^T: 16 rows x BK keys per warp, f32 in registers
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, kb + j * 8 * LD + k_off + kk * 16);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // scale in f32, mask, online softmax (each row's 4 column lanes are
    // one quad of the warp)
    const bool masked =
        seg_row || k0 + BK > t || (causal && k0 + BK - 1 > q0);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[j][e] * scale, x1 = s[j][2 + e] * scale;
        if (masked) {
          const int cl = j * 8 + tig * 2 + e, col = k0 + cl;
          bool ok0 = col < t && (!causal || row0 >= col);
          bool ok1 = col < t && (!causal || row1 >= col);
          if (seg_row) {
            const int id = kid[cl];
            ok0 = ok0 && id == sq0 && id != 0;
            ok1 = ok1 && id == sq1 && id != 0;
          }
          x0 = ok0 ? x0 : kNeg;
          x1 = ok1 ? x1 : kNeg;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f((m0 - mn0) * kLog2e);
    const float al1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked score is exactly kNeg: its probability is 0, also in
        // a row with no live key yet (the reference's where(mask, p, 0))
        const float x0 = s[j][e], x1 = s[j][2 + e];
        const float p0 = x0 == kNeg ? 0.f : exp2f((x0 - mn0) * kLog2e);
        const float p1 = x1 == kNeg ? 0.f : exp2f((x1 - mn1) * kLog2e);
        s[j][e] = p0;
        s[j][2 + e] = p1;
        rs0 += p0;
        rs1 += p1;
      }
    l0 = l0 * al0 + rs0;  // this thread's share; the quad adds at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: the score accumulator is P's A fragment, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + kk * 16 * LD + v_off + n * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* og = o + base;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + tig * 2;
    if (row0 < t)
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row0) * D + c) =
          pack_bf16(acc[n][0] / den0, acc[n][1] / den0);
    if (row1 < t)
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row1) * D + c) =
          pack_bf16(acc[n][2] / den1, acc[n][3] / den1);
  }
}

template <int D, int BQ, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* seg, void* o, int bh, int t, int heads,
                        int causal, void* stream) {
  using Cfg = Bf16Cfg<D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D, BQ, BK>
      <<<grid, Cfg::kThreads, Cfg::kSmem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const int*>(seg),
          static_cast<bf16*>(o), t, heads, softmax_scale<D>(), causal);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32

constexpr int kF32Threads = 128;  // 8 row groups x 16 column lanes
constexpr int kF32BQ = 32, kF32BK = 64;

template <int D>
struct F32Cfg {
  static constexpr int BQ = kF32BQ, BK = kF32BK;
  static constexpr int kQ = D * BQ;   // qT [D][BQ]
  static constexpr int kK = D * BK;   // kT [D][BK], swizzled
  static constexpr int kV = BK * D;   // v [BK][D]
  static constexpr int kP = BQ * BK;  // p [BQ][BK]
  static constexpr int kSmem = 4 * (kQ + kK + kV + kP + BK);
};

// K^T's element (d, key) in its shared tile: the 4-key group XOR d % 8
__device__ __forceinline__ int kt_index(int d, int key) {
  return d * kF32BK + (((key >> 2) ^ (d & 7)) << 2) + (key & 3);
}

// Keys [k0, k0 + BK) of a row-major [t, D] f32 matrix into kT, d-major,
// 4 bytes a copy: each warp copies 8 consecutive d of 4 keys (4 full
// 32-byte sectors), whose swizzled slots fall in 32 distinct banks.
template <int D>
__device__ __forceinline__ void stage_kt(float* kt, const float* src, int k0,
                                         int t, int tid) {
  constexpr int N = kF32BK * D;
#pragma unroll 4
  for (int i = tid; i < N; i += kF32Threads) {
    const int dlo = i & 7, klo = (i >> 3) & 3, rest = i >> 5;
    const int d = (rest % (D / 8)) * 8 + dlo, key = (rest / (D / 8)) * 4 + klo;
    const bool ok = k0 + key < t;
    cp_async4(kt + kt_index(d, key),
              src + static_cast<size_t>(ok ? k0 + key : 0) * D + d, ok);
  }
}

// Rows [q0, q0 + BQ) of q into qT [D][BQ], d-major (lanes along rows:
// distinct banks); done once a block.
template <int D>
__device__ __forceinline__ void stage_qt(float* qt, const float* src, int q0,
                                         int t, int tid) {
  for (int i = tid; i < kF32BQ * D; i += kF32Threads) {
    const int r = i % kF32BQ, d = i / kF32BQ;
    const bool ok = q0 + r < t;
    cp_async4(qt + d * kF32BQ + r,
              src + static_cast<size_t>(ok ? q0 + r : 0) * D + d, ok);
  }
}

// Rows [k0, k0 + BK) of v into a row-major [BK][D] tile, 16 bytes a copy.
template <int D>
__device__ __forceinline__ void stage_v(float* vt, const float* src, int k0,
                                        int t, int tid) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int i = tid; i < kF32BK * CH; i += kF32Threads) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < t;
    cp_async16(vt + r * D + c,
               src + static_cast<size_t>(ok ? k0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ seg, float* __restrict__ o,
                     int t, int heads, float scale, int causal) {
  using Cfg = F32Cfg<D>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK;
  constexpr int NC = D / 64;  // float4 column groups of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][BQ]
  float* kt = qt + Cfg::kQ;                        // [D][BK] swizzled
  float* vt = kt + Cfg::kK;                        // [BK][D]
  float* ps = vt + Cfg::kV;                        // [BQ][BK]
  int* kid = reinterpret_cast<int*>(ps + Cfg::kP);  // [BK]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys 4 tx .. 4 tx + 3; columns 4 tx + 64 c
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int* seg_row =
      seg ? seg + static_cast<size_t>(bh / heads) * t : nullptr;
  const float *qg = q + base, *kg = k + base, *vg = v + base;

  const int kend = causal ? min(t, q0 + BQ) : t;
  const int ntiles = (kend + BK - 1) / BK;
  stage_qt<D>(qt, qg, q0, t, tid);
  stage_kt<D>(kt, kg, 0, t, tid);
  if (seg_row)
    for (int i = tid; i < BK; i += kF32Threads)
      cp_async4(kid + i, seg_row + (i < t ? i : 0), i < t);
  cp_async_commit();
  stage_v<D>(vt, vg, 0, t, tid);
  cp_async_commit();

  int sq[4] = {0, 0, 0, 0};
  if (seg_row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      sq[i] = row < t ? seg_row[row] : 0;
    }
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait<1>();  // Q and this K tile (the V tile may still fly)
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * BQ + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(
          kt + d * BK + ((tx ^ (d & 7)) << 2));
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    const bool masked =
        seg_row || k0 + BK > t || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (masked) {
          const int col = k0 + 4 * tx + j;
          bool ok = col < t && (!causal || row >= col);
          if (seg_row) {
            const int id = kid[4 * tx + j];
            ok = ok && id == sq[i] && id != 0;
          }
          x = ok ? x : kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // a row's 16 column lanes are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = s[i][j] == kNeg ? 0.f : exp2f((s[i][j] - m_new) * kLog2e);
        sum += p[j];
      }
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * BK + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K and the ids are free; the p tile is complete
    if (it + 1 < ntiles) {
      stage_kt<D>(kt, kg, k0 + BK, t, tid);
      if (seg_row)
        for (int i = tid; i < BK; i += kF32Threads) {
          const bool ok = k0 + BK + i < t;
          cp_async4(kid + i, seg_row + (ok ? k0 + BK + i : 0), ok);
        }
      cp_async_commit();
      cp_async_wait<1>();  // this V tile (the next K tile may still fly)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (4 * ty + i) * BK + kk);
        pr[i][0] = x.x;
        pr[i][1] = x.y;
        pr[i][2] = x.z;
        pr[i][3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(
              vt + (kk + u) * D + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * c + 0] = fmaf(pr[i][u], w.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i][u], w.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i][u], w.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i][u], w.w, acc[i][4 * c + 3]);
          }
        }
    }
    __syncthreads();  // V and p are free
    if (it + 1 < ntiles) {
      stage_v<D>(vt, vg, k0 + BK, t, tid);
      cp_async_commit();
    }
  }

  float* og = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= t) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(og + static_cast<size_t>(row) * D + 64 * c +
                                 4 * tx) =
          make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                      acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* seg, void* o, int bh, int t, int heads,
                       int causal, void* stream) {
  constexpr int bytes = F32Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kF32BQ - 1) / kF32BQ);
  flash_fwd_f32_kernel<D>
      <<<grid, kF32Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const int*>(seg),
          static_cast<float*>(o), t, heads, softmax_scale<D>(), causal);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_bf16_d128(int block_k, const void* q, const void* k,
                             const void* v, const void* seg, void* o, int bh,
                             int t, int heads, int causal, void* stream) {
  switch (block_k) {
    case 32:
      return launch_bf16<128, BQ, 32>(q, k, v, seg, o, bh, t, heads, causal,
                                      stream);
    case 64:
      return launch_bf16<128, BQ, 64>(q, k, v, seg, o, bh, t, heads, causal,
                                      stream);
    case 128:
      return launch_bf16<128, BQ, 128>(q, k, v, seg, o, bh, t, heads, causal,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous f32 [bh, t, d], 16-byte aligned; seg: contiguous
// int32 [bh / heads, t] segment ids, or null for no segment mask. Tiles
// 32 x 64. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* seg, void* o,
                                   int bh, int t, int d, int heads,
                                   int causal, void* stream) {
  if (bh <= 0 || t <= 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch_f32<64>(q, k, v, seg, o, bh, t, heads, causal, stream);
    case 128:
      return launch_f32<128>(q, k, v, seg, o, bh, t, heads, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// As flash_attention_f32 on bf16 q, k, v, o, with the tile block_q x
// block_k: 64 x 64 at d = 64; any of {32, 64, 128} x {32, 64, 128} at
// d = 128 (the T2 sweep's instantiations). Other tiles return
// cudaErrorInvalidValue.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* seg, void* o,
                                    int bh, int t, int d, int heads,
                                    int causal, int block_q, int block_k,
                                    void* stream) {
  if (bh <= 0 || t <= 0) return cudaSuccess;
  if (d == 64) {
    if (block_q != 64 || block_k != 64) return cudaErrorInvalidValue;
    return launch_bf16<64, 64, 64>(q, k, v, seg, o, bh, t, heads, causal,
                                   stream);
  }
  if (d != 128) return cudaErrorInvalidValue;
  switch (block_q) {
    case 32:
      return launch_bf16_d128<32>(block_k, q, k, v, seg, o, bh, t, heads,
                                  causal, stream);
    case 64:
      return launch_bf16_d128<64>(block_k, q, k, v, seg, o, bh, t, heads,
                                  causal, stream);
    case 128:
      return launch_bf16_d128<128>(block_k, q, k, v, seg, o, bh, t, heads,
                                   causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
