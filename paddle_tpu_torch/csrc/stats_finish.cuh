// The last launch of kernel B1 (csrc/conv_bn_stats.cu) and of T1
// (csrc/conv1x1_bn_relu.cu): each output channel's partial sums of y and
// y * y, one a tile of pixels or rows, added in a fixed order in double,
// so two runs give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace
