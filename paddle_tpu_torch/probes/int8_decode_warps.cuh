// B3's earlier decode design, for `python3 -m paddle_tpu_torch.probes.int8
// variants` only: inserted into an edited copy of csrc/int8_matmul.cu (the
// variant "warps-split-k"), never built into the package. One CTA per
// 16 x 32 output tile whose 8 warps split k (warp-private shared tiles,
// the partial sums added in shared memory), each CTA first reading its
// rows' amax over all of k, then quantizing x on its way into shared
// memory; 4-byte weight loads, one k tile of 64 in registers ahead.

constexpr int kBK = 64;            // k per tile
constexpr int kKW = kBK / 4;       // 32-bit words of 4 int8 per tile row
constexpr int kPad = 4;            // words of padding: conflict-free MMA loads

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
