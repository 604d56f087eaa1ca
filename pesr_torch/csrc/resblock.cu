// Fused residual block for Hopper (sm_90a):
//   out = x + res_scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)
// with SAME zero padding, bf16 activations and weights, f32 accumulation.
//
// Replaces the TPU kernel pesr_tpu/ops/pallas/resblock.py
// (_resblock_kernel / _resblock_pallas_forward, reached through
// fused_resblock).  As there, the hidden activation never reaches device
// memory: it lives in a ring of four hidden rows in shared memory.
//
// What bounds it on the H100: the tensor cores (2 x 9 x C x C MACs per
// pixel for ~1 KB of activation traffic), and behind them the L2 traffic
// of the weights (2 x 9 x C x C x 2 B per block step), which no tile that
// fits in shared memory can amortise over many pixels.  The design:
//
//   * a CTA owns a strip segment: 62 output columns x `rows` output rows
//     of one image, and walks down it as a line buffer.  Each step runs
//     conv1 on two 64-pixel hidden rows (M = 128: one row per consumer
//     warpgroup) into the hidden ring, then conv2 on two 64-pixel output
//     rows (62 real) from the four newest hidden rows.  The vertical halo
//     is recomputed once per segment (2 hidden rows per `rows`), the
//     horizontal one costs 2 of 64 columns: ~1.04x x ~1.03x the useful
//     FLOPs per strip, 1.15x at the main path's [2, 336, 510] (9 strips
//     of 62 cover 510 columns), against 1.56x for 16-wide virtual rows;
//   * conv1's input streams in 32-channel chunks of 4 rows x 66 pixels
//     (TMA, zero fill = SAME padding); conv2 reads the hidden ring;
//     the residual comes from global memory in the epilogue;
//   * the weights stream through the 4-stage TMA ring of
//     conv3x3_tile.cuh, multicast across a cluster of 2 CTAs on
//     neighbouring strips: L2 serves each weight byte once per 2 x 124
//     output pixels of a step;
//   * the schedule (rows per segment, strips, segments) comes from the
//     wrapper (pesr_torch/ops/kernels/resblock.py,
//     resblock_schedule), sized so that the main path's tile batch fills
//     one wave.
//
// Shared memory at C = 256: hidden ring 4 x 64 px x 512 B = 131,072 B,
// weight ring 4 x 256 x 64 B = 65,536 B, window ring 2 x 16,896 B,
// barriers: 230,496 B of the 232,448.
//
// Rounding matches the TPU kernel: bias added in f32, the hidden rounded
// to bf16 before conv2 (resblock.py:65), the residual added in f32 before
// the single bf16 rounding of the output (resblock.py:69-71).  Hidden
// pixels outside the image are ZERO (SAME padding of conv2's input), not
// relu(b1 + partial sums) (the ring mask of resblock.py:56-65).

#include "conv3x3_tile.cuh"

namespace pesr {
namespace {

constexpr int kHidW = 64;              // hidden row width (one m64 tile)
constexpr int kStripOut = kHidW - 2;   // output columns per strip

template <int C>
struct Layout {
  static constexpr int kPix = C * 2;  // bytes of one hidden pixel
  static constexpr int kHidden = 4 * kHidW * kPix;
  static constexpr int kWRing = kWStages * C * kChunkBytes;
  static constexpr int kWRingOff = kHidden;
  static constexpr int kWinOff = kWRingOff + kWRing;
  static constexpr int kPipesOff = kWinOff + 2 * kWinBytes;
  static constexpr int kBytes = kPipesOff + sizeof(Pipes<kWStages>);
  static_assert(kWRingOff % 1024 == 0 && kWinOff % 512 == 0, "swizzle alignment");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Hidden ring: pixel q of hidden row k sits at ((k & 3) * 64 + q) * 2C
// bytes, its 16-byte chunk c at chunk c ^ (q & 7) (bank-conflict-free
// for ldmatrix and for the epilogue's stores).
template <int C>
__device__ __forceinline__ uint32_t hidden_addr(uint32_t hid, int k, int q, int c) {
  return hid + ((k & 3) * kHidW + q) * Layout<C>::kPix + ((c ^ (q & 7)) << 4);
}

// conv2's A address at step s: the warpgroup's output pixel p reads
// hidden row 2s - 2 + wg + dy, column p + dx (clamped for the two
// columns past the strip, whose outputs are dropped).
template <int C>
struct HiddenA {
  uint32_t hid;
  int wg, p, kh, s;
  __device__ __forceinline__ uint32_t operator()(int, int kc, int dy, int dx, int k16) const {
    return hidden_addr<C>(hid, 2 * s - 2 + wg + dy, min(p + dx, kHidW - 1),
                          kc * 4 + 2 * k16 + kh);
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    bf16* __restrict__ out, int B, int H, int W, float res_scale, int rows,
                    int strips, int segs) {
  using L = Layout<C>;
  constexpr int KC = C / kKChunk;
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
          produce_window(pipes, smem + L::kWinOff, ipos, &xmap, kc, x0 - 2, y0 - 2 + 2 * s, b);
          for (int tap = 0; tap < 9; ++tap)
            produce_weights<C>(pipes, smem + L::kWRingOff, wpos, &w1map, kc, 0, tap, rank);
        }
        if (s > 0)
          for (int kc = 0; kc < KC; ++kc)
            for (int tap = 0; tap < 9; ++tap)
              produce_weights<C>(pipes, smem + L::kWRingOff, wpos, &w2map, kc, 0, tap, rank);
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- two consumer warpgroups: conv1 -> hidden ring -> conv2 ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t hid = smem_u32(smem), wring = smem_u32(smem + L::kWRingOff);
    const WindowA wa{smem_u32(smem + L::kWinOff), wg, lane_row(), lane_khalf()};
    RingPos wpos, ipos;
    float acc[C / 2];
    for (int s = 0; s <= steps; ++s) {
      // conv1 on hidden row k = 2s + wg (image row y0 - 1 + k).
      conv3x3_wgmma<C, KC, kWStages, true>(acc, pipes, wring, wpos, ipos, wa);
      if (s > 0) named_barrier(1, kConsumers);  // conv2 of step s-1 is done with the ring
      {
        const int k = 2 * s + wg, gy = y0 - 1 + k;
        const bool row_in = gy >= 0 && gy < H;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + n));
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = warp * 16 + (lane >> 2) + 8 * v;
            const int gx = x0 - 1 + p;
            const bool in = row_in && gx >= 0 && gx < W;
            const float h0 = in ? fmaxf(acc[4 * j + 2 * v] + bb.x, 0.0f) : 0.0f;
            const float h1 = in ? fmaxf(acc[4 * j + 2 * v + 1] + bb.y, 0.0f) : 0.0f;
            const uint32_t a = hidden_addr<C>(hid, k, p, j) + 4 * (lane & 3);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(pack_bf16x2(h0, h1))
                         : "memory");
          }
        }
      }
      named_barrier(2, kConsumers);  // the hidden rows of step s are written
      if (s == 0) continue;
      // conv2 on output row o = y0 + 2s - 2 + wg.
      conv3x3_wgmma<C, KC, kWStages, false>(
          acc, pipes, wring, wpos, ipos, HiddenA<C>{hid, wg, lane_row(), lane_khalf(), s});
      const int o = y0 + 2 * s - 2 + wg;
      if (b < B && o < H) {
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + n));
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = warp * 16 + (lane >> 2) + 8 * v;
            const int gx = x0 + p;
            if (p < kStripOut && gx < W) {
              const int64_t idx = ((static_cast<int64_t>(b) * H + o) * W + gx) * C + n;
              const float2 res =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + idx));
              const float o0 = res.x + res_scale * (acc[4 * j + 2 * v] + bb.x);
              const float o1 = res.y + res_scale * (acc[4 * j + 2 * v + 1] + bb.y);
              *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16x2(o0, o1);
            }
          }
        }
      }
    }
    cluster_sync();
  }
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int B, int H, int W, float res_scale, int rows, int strips, int segs,
           int ctas, cudaStream_t stream) {
  CUtensorMap xm, w1m, w2m;
  if (!make_window_map(&xm, x, B, H, W, C) || !make_weight_map(&w1m, w1, C, C, C / kCluster) ||
      !make_weight_map(&w2m, w2, C, C, C / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      resblock_kernel<C>, ctas, Layout<C>::kBytes, stream, xm, w1m, w2m,
      static_cast<const bf16*>(x), static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<bf16*>(out), B, H, W, res_scale, rows, strips, segs));
}

template <int C>
int max_clusters() {
  return max_active_clusters(resblock_kernel<C>, Layout<C>::kBytes);
}

}  // namespace
}  // namespace pesr

// x, out: [batch, H, W, C] bf16 NHWC, 16-byte aligned (out must not alias
// x); w1, w2: [3, 3, C, C] bf16 packed as [tap][output][input]; b1, b2:
// [C] f32.  rows / strips / segs / ctas: the schedule of
// resblock_schedule (rows even; ctas a multiple of the cluster size 2 and
// >= batch * strips * segs).  Returns the CUDA error code of
// the launch (0 = launched).  C must be 64, 128 or 256.
extern "C" int pesr_fused_resblock(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out, int batch,
                                   int H, int W, int C, float res_scale, int rows, int strips,
                                   int segs, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 2 || rows % 2 || ctas % pesr::kCluster || ctas < batch * strips * segs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 64:
      return pesr::launch<64>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, rows, strips,
                              segs, ctas, s);
    case 128:
      return pesr::launch<128>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, rows, strips,
                               segs, ctas, s);
    case 256:
      return pesr::launch<256>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, rows, strips,
                               segs, ctas, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of 2 CTAs of the C-channel kernel the device runs at once
// (negative: minus the CUDA error code).
extern "C" int pesr_resblock_max_clusters(int C) {
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
