// Warp-level bit helpers shared by the kernels (K1 dbscan_block.cu, K4
// radius.cu). Header only; each source includes it.
#pragma once

#include <stdint.h>

namespace vtkcp {

// 32 x 32 bit transpose across a warp: lane r holds row r (bit c = A[r][c]);
// returns column `lane` (bit r = A[r][lane]). Five steps of one shuffle,
// one rotate and one bit select: at step s a lane keeps the half of its
// word that stays and takes the other half from lane ^ s, shifted by s.
// The masks leave the bits that a rotate wraps around out, so a rotate
// (left by s, or right by s for the upper lanes) serves as the shift.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const bool upper = (lane & s) != 0;
    const uint32_t keep = upper ? ~masks[k] : masks[k];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    const uint32_t moved = __funnelshift_l(y, y, upper ? 32 - s : s);
    x = (x & keep) | (moved & ~keep);
  }
  return x;
}

}  // namespace vtkcp
