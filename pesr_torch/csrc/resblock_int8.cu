// Fused int8 (W8A8) residual block for Hopper (sm_90a): one launch per
// block of the int8 inference path (--quant int8),
//
//   q1  = clip(rint(f32(y) * qin1), -127, 127)                 s8
//   h   = clip(rint(max(f32(conv3x3(q1, w1)) * mq + bq, 0)), -127, 127)
//   y2  = bf16(f32(conv3x3(h, w2)) * m2 + b2)
//   out = bf16(f32(y) + f32(bf16(res_scale * f32(y2))))
//
// with SAME zero padding, s8 x s8 -> s32 convolutions and per-channel f32
// vectors (mq = m1 qin2 and bq = bias1 qin2 formed on the host).  Every
// float operation rounds on its own, in the order the plain version
// (pesr_torch/ops/kernels/resblock_int8.py, int8_resblock_reference)
// computes it, so the output is bitwise the plain version's.  Note the
// two bf16 roundings of the residual (torch's y + rs * y2 on bf16
// tensors), unlike fused_resblock's single one.
//
// Replaces no Pallas kernel: the JAX block (pesr_tpu/models/
// quant_apply.py:235-262) is lax.conv(int8, int8) -> int32 twice, with the
// quantize, the conv1 -> conv2 requant, the dequant and the residual fused
// around the convs by XLA.  This is the port of what XLA compiles there,
// in place of two int8 im2cols in device memory, two library GEMMs and
// ~16 f32 elementwise passes.
//
// What bounds it on the H100: the int8 tensor cores (2 x 9 x C x C MACs
// per pixel at 1,979 TOP/s; ~0.42 ms at the x4 tile batch
// [2, 342, 516, 256]), far above its ~1 KB of activation traffic per
// pixel.  The design is csrc/resblock.cu's line mode with the element
// type changed (conv3x3_s8.cuh):
//
//   * a CTA owns a strip segment, 62 output columns x `rows` rows of one
//     image, and walks down it as a line buffer; each step runs conv1 on
//     two 64-pixel hidden rows (one per consumer warpgroup) and conv2 on
//     two output rows from the four newest hidden rows;
//   * conv1's bf16 input streams by TMA in 64-channel chunks of 4 rows x
//     66 pixels (zero fill = SAME padding; 0 quantizes to 0); the two
//     consumer warpgroups quantize each chunk once with qin1 into an int8
//     window in shared memory, which the nine taps read;
//   * conv1's epilogue requantizes into an int8 hidden ring of 4 rows x
//     64 pixels (64 KB at C = 256), hidden pixels outside the image 0;
//     the hidden activation, an im2col or any f32 tensor never reach
//     device memory;
//   * conv2's epilogue dequantizes, reads the bf16 carry once more for
//     the residual and writes the output as 16-byte vectors;
//   * int8 weights, packed once at load time, stream through the 4-stage
//     TMA ring multicast across a cluster of 2 CTAs, 64 channels a stage.
//
// Line mode with a ragged last strip covers every W >= 1 (a strip of 62
// columns clipped to the image), so there is no flat mode: the int8
// engines' tiles are wide.  C must be 64, 128 or 256.
//
// Shared memory at C = 256: hidden ring 65,536 B, weight ring 4 x 256 x
// 64 B = 65,536 B, bf16 window ring 2 x 33,792 B, int8 window 16,896 B,
// barriers: 215,648 B.
//
// This first form is simple, not fast: the quantization of each window
// chunk stalls both warpgroups between two barriers, and neither
// epilogue overlaps the MMAs (ping-pong warpgroups would).

#include "conv3x3_s8.cuh"

namespace pesr {
namespace {

constexpr int kHidW = 64;             // hidden row width (one m64 tile)
constexpr int kStripOut = kHidW - 2;  // output columns per strip

template <int C>
struct Layout {
  static constexpr int kHidden = 4 * kHidW * C;  // int8 hidden ring
  static constexpr int kWRing = kWStages * C * kChunkBytes;
  static constexpr int kWRingOff = kHidden;
  static constexpr int kWinOff = kWRingOff + kWRing;
  static constexpr int kWin8Off = kWinOff + 2 * kS8SlotBytes;
  static constexpr int kPipesOff = kWin8Off + kS8WinBytes;
  static constexpr int kBytes = kPipesOff + sizeof(Pipes<kWStages>);
  static_assert(kWRingOff % 1024 == 0 && kWinOff % 512 == 0 && kS8SlotBytes % 512 == 0 &&
                    kWin8Off % 512 == 0,
                "swizzle alignment");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Hidden ring: pixel q of hidden row k sits at ((k & 3) * 64 + q) * C
// bytes, its 16-byte chunk c at chunk c ^ (q & m), m = min(C / 16, 8) - 1
// (bank-conflict-free for ldmatrix at C >= 128).
template <int C>
__device__ __forceinline__ uint32_t hidden_addr(uint32_t hid, int k, int q, int c) {
  constexpr int kMask = (C / 16 < 8 ? C / 16 : 8) - 1;
  return hid + ((k & 3) * kHidW + q) * C + ((c ^ (q & kMask)) << 4);
}

// conv1's A address: the warpgroup's pixel p of row wg reads int8 window
// pixel (wg + dy, p + dx), 16-byte chunk 2 h + kh.
struct WindowA {
  uint32_t win8;  // smem address of the int8 window
  int wg, p, kh;
  __device__ __forceinline__ uint32_t operator()(int, int dy, int dx, int h) const {
    return sw64_addr(win8, (wg + dy) * kWinW + p + dx, 2 * h + kh);
  }
};

// conv2's A address at step s: the warpgroup's output pixel p reads
// hidden row 2s - 2 + wg + dy, column p + dx (clamped for the two columns
// past the strip, whose outputs are dropped), 16-byte chunk 4 kc + 2 h +
// kh.
template <int C>
struct HiddenA {
  uint32_t hid;
  int wg, p, kh, s;
  __device__ __forceinline__ uint32_t operator()(int kc, int dy, int dx, int h) const {
    return hidden_addr<C>(hid, 2 * s - 2 + wg + dy, min(p + dx, kHidW - 1), kc * 4 + 2 * h + kh);
  }
};

// conv1 -> conv2's int8 input, clip(rint(max(f32(acc) * m + b, 0)), ..,
// 127), in the low byte.
__device__ __forceinline__ uint32_t requant(int32_t acc, float m, float b) {
  return rint_bits(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b), 0.0f);
}

// One output channel: y + bf16(rs * bf16(f32(acc) * m + b)), before the
// output's bf16 rounding.
__device__ __forceinline__ float residual(float y, int32_t acc, float m, float b, float rs) {
  const float y2 = __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b)));
  return __fadd_rn(y, __bfloat162float(__float2bfloat16_rn(__fmul_rn(rs, y2))));
}

// conv2's epilogue of pixel row v (0, 1) of this lane's D fragment for
// the C channels of flat pixel `pix`, if `valid` (the same for the 4
// lanes of a quad; every lane of the warp calls it).  The carry and the
// output move as 16-byte vectors, 8 channels a lane, transposed across
// the quad to and from the fragment's 2 channels per lane and group (as
// residual_epilogue in conv3x3_tile.cuh).
template <int C>
__device__ __forceinline__ void residual_epilogue_s8(const int32_t (&acc)[C / 2], int v,
                                                     const float* __restrict__ m2,
                                                     const float* __restrict__ b2,
                                                     const bf16* __restrict__ y,
                                                     bf16* __restrict__ out, int64_t pix,
                                                     bool valid, float res_scale) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < C / 32; ++t) {
    // An invalid pixel loads pixel 0 (no branch) and stores nothing.
    const int64_t at = (valid ? pix : 0) * C + 8 * (4 * t + q);
    const uint4 u = *reinterpret_cast<const uint4*>(y + at);
    uint32_t r[4] = {u.x, u.y, u.z, u.w};
    quad_transpose(r);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = 4 * t + g;
      const float2 mm = __ldg(reinterpret_cast<const float2*>(m2 + 8 * j + 2 * q));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * q));
      const float lo = __uint_as_float(r[g] << 16), hi = __uint_as_float(r[g] & 0xffff0000u);
      r[g] = pack_bf16x2(residual(lo, acc[4 * j + 2 * v], mm.x, bb.x, res_scale),
                         residual(hi, acc[4 * j + 2 * v + 1], mm.y, bb.y, res_scale));
    }
    quad_transpose(r);
    if (valid) *reinterpret_cast<uint4*>(out + at) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_int8_kernel(const __grid_constant__ CUtensorMap ymap,
                         const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ y,
                         const float* __restrict__ qin1, const float* __restrict__ mq,
                         const float* __restrict__ bq, const float* __restrict__ m2,
                         const float* __restrict__ b2, bf16* __restrict__ out, int B, int H,
                         int W, float res_scale, int rows, int strips, int segs) {
  using L = Layout<C>;
  constexpr int KC = C / kS8Chunk;
  extern __shared__ __align__(1024) uint8_t smem[];
  auto& pipes = *reinterpret_cast<Pipes<kWStages>*>(smem + L::kPipesOff);
  const uint32_t rank = cluster_rank();

  // Work item: strip segment of image b (b >= B: a CTA that pads the
  // item count to a multiple of kCluster; it loads zeros and stores
  // nothing).
  const int item = blockIdx.x;
  const int b = item / (strips * segs);
  const int r = item % (strips * segs);
  const int y0 = (r / strips) * rows, x0 = (r % strips) * kStripOut;
  const int steps = rows / 2;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();
    init_pipes(pipes);
  }
  __syncthreads();
  cluster_sync();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      RingPos wpos, ipos;
      for (int s = 0; s <= steps; ++s) {
        for (int kc = 0; kc < KC; ++kc) {
          produce_window_s8(pipes, smem + L::kWinOff, ipos, &ymap, kc, x0 - 2, y0 - 2 + 2 * s, b);
          for (int tap = 0; tap < 9; ++tap)
            produce_weights_s8<C>(pipes, smem + L::kWRingOff, wpos, &w1map, kc, tap, rank);
        }
        if (s > 0)
          for (int kc = 0; kc < KC; ++kc)
            for (int tap = 0; tap < 9; ++tap)
              produce_weights_s8<C>(pipes, smem + L::kWRingOff, wpos, &w2map, kc, tap, rank);
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- two consumer warpgroups: conv1 -> int8 hidden ring -> conv2 ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t hid = smem_u32(smem), wring = smem_u32(smem + L::kWRingOff);
    const uint32_t wins = smem_u32(smem + L::kWinOff), win8 = smem_u32(smem + L::kWin8Off);
    const WindowA wa{win8, wg, lane_row(), lane_khalf()};
    RingPos wpos, ipos;
    int32_t acc[C / 2];
    for (int s = 0; s <= steps; ++s) {
      // conv1 on hidden row k = 2s + wg (image row y0 - 1 + k).
      conv3x3_s8<C, C, true>(acc, pipes, wring, wpos, ipos, wa, wins, win8, qin1);
      if (s > 0) named_barrier(1, kConsumers);  // conv2 of step s-1 is done with the ring
      {
        const int k = 2 * s + wg, gy = y0 - 1 + k;
        const bool row_in = gy >= 0 && gy < H;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const float2 mm = __ldg(reinterpret_cast<const float2*>(mq + n));
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bq + n));
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = warp * 16 + (lane >> 2) + 8 * v;
            const int gx = x0 - 1 + p;
            const bool in = row_in && gx >= 0 && gx < W;
            const uint32_t h0 = in ? requant(acc[4 * j + 2 * v], mm.x, bb.x) : 0u;
            const uint32_t h1 = in ? requant(acc[4 * j + 2 * v + 1], mm.y, bb.y) : 0u;
            const uint32_t a = hidden_addr<C>(hid, k, p, j >> 1) + 8 * (j & 1) + 2 * (lane & 3);
            asm volatile("st.shared.b16 [%0], %1;" ::"r"(a),
                         "h"(static_cast<unsigned short>(__byte_perm(h0, h1, 0x0040)))
                         : "memory");
          }
        }
      }
      named_barrier(2, kConsumers);  // the hidden rows of step s are written
      if (s == 0) continue;
      // conv2 on output row o = y0 + 2s - 2 + wg.
      conv3x3_s8<C, C, false>(acc, pipes, wring, wpos, ipos,
                              HiddenA<C>{hid, wg, lane_row(), lane_khalf(), s});
      const int o = y0 + 2 * s - 2 + wg;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int p = warp * 16 + (lane >> 2) + 8 * v;
        const int gx = x0 + p;
        residual_epilogue_s8<C>(acc, v, m2, b2, y, out,
                                (static_cast<int64_t>(b) * H + o) * W + gx,
                                b < B && o < H && p < kStripOut && gx < W, res_scale);
      }
    }
    cluster_sync();
  }
}

template <int C>
int launch(const void* y, const void* w1, const void* qin1, const void* mq, const void* bq,
           const void* w2, const void* m2, const void* b2, void* out, int B, int H, int W,
           float res_scale, int rows, int strips, int segs, int ctas, cudaStream_t stream) {
  CUtensorMap ym, w1m, w2m;
  if (!make_window_map(&ym, y, B, H, W, C) || !make_s8_weight_map(&w1m, w1, C, C, C / kCluster) ||
      !make_s8_weight_map(&w2m, w2, C, C, C / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      resblock_int8_kernel<C>, ctas, Layout<C>::kBytes, stream, ym, w1m, w2m,
      static_cast<const bf16*>(y), static_cast<const float*>(qin1),
      static_cast<const float*>(mq), static_cast<const float*>(bq),
      static_cast<const float*>(m2), static_cast<const float*>(b2), static_cast<bf16*>(out), B,
      H, W, res_scale, rows, strips, segs));
}

template <int C>
int max_clusters() {
  return max_active_clusters(resblock_int8_kernel<C>, Layout<C>::kBytes);
}

}  // namespace
}  // namespace pesr

// y, out: [batch, H, W, C] bf16 NHWC, 16-byte aligned (out must not alias
// y); w1, w2: [3, 3, C, C] int8 packed as [tap][output][input]; qin1, mq, bq, m2,
// b2: [C] f32; res_scale: the bf16 res_scale as a float.  rows / strips /
// segs / ctas: the line-mode schedule of resblock_int8_schedule (rows
// even; ctas a multiple of the cluster size 2 and >= batch * strips *
// segs).  Returns the CUDA error code of the launch (0 = launched).  C
// must be 64, 128 or 256.
extern "C" int pesr_fused_resblock_int8(const void* y, const void* w1, const void* qin1,
                                        const void* mq, const void* bq, const void* w2,
                                        const void* m2, const void* b2, void* out, int batch,
                                        int H, int W, int C, float res_scale, int rows,
                                        int strips, int segs, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas % pesr::kCluster || rows < 2 || rows % 2 || ctas < batch * strips * segs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 64:
      return pesr::launch<64>(y, w1, qin1, mq, bq, w2, m2, b2, out, batch, H, W, res_scale, rows,
                              strips, segs, ctas, s);
    case 128:
      return pesr::launch<128>(y, w1, qin1, mq, bq, w2, m2, b2, out, batch, H, W, res_scale,
                               rows, strips, segs, ctas, s);
    case 256:
      return pesr::launch<256>(y, w1, qin1, mq, bq, w2, m2, b2, out, batch, H, W, res_scale,
                               rows, strips, segs, ctas, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of 2 CTAs of the C-channel kernel the device runs at once
// (negative: minus the CUDA error code).
extern "C" int pesr_resblock_int8_max_clusters(int C) {
  switch (C) {
    case 64:
      return pesr::max_clusters<64>();
    case 128:
      return pesr::max_clusters<128>();
    case 256:
      return pesr::max_clusters<256>();
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}
