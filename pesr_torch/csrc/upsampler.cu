// Fused x2 sub-pixel upsampler stage for Hopper (sm_90a):
//   out = pixel_shuffle(conv3x3_SAME(x, w) + b, 2)
// [B, H, W, C] -> [B, 2H, 2W, C], bf16 activations and weights, f32
// accumulation, torch channel order (conv column c * 4 + i * 2 + j lands
// at out[b, 2h + i, 2w + j, c]).
//
// Replaces the TPU kernel pesr_tpu/ops/pallas/upsampler.py
// (_upsampler_kernel / _upsampler_pallas_forward, reached through
// fused_upsampler_stage).  As there, the [H, W, 4C] conv output never
// reaches device memory: the epilogue shuffles each tile in shared memory
// and one TMA store writes it.  Left behind are the Mosaic-only
// workarounds: the f32 output cast back afterwards, the <=128-channel
// chunk grid and the silent XLA fallback; the wrapper raises on a shape
// this kernel does not take.
//
// What bounds it on the H100: the tensor cores (9 x C x 4C MACs per input
// pixel against 2 B x C in and 8 B x C out), and behind them the L2
// traffic of the weights, re-streamed for every 128-pixel tile.  The
// design:
//
//   * persistent clusters of 2 CTAs walk a list of tiles
//     (wrapper: upsampler_schedule).  A CTA tile is two conv rows x 64
//     pixels (M = 128, one row per consumer warpgroup) x 256 packed conv
//     columns (N = 256: 64 output channels x 4 sub-pixel phases).  The
//     CTAs of a cluster take consecutive CTA tiles of the list (row
//     pair-major, 64-pixel segment-minor) in the same column group, and
//     each multicasts half of every weight box to both: L2 serves each
//     weight byte once per 2 x 128 conv pixels.  On a wide image the
//     pair is two neighbouring segments of one row pair; on a narrow one
//     (an odd number of segments per row, W = 48 of the training patches
//     among them) it may be the same segment of two row pairs, so no CTA
//     computes a segment that lies outside the image;
//   * the mainloop of conv3x3_tile.cuh: wgmma with A from registers
//     (ldmatrix on a streamed 4 x 66-pixel window), B through a 6-stage
//     TMA ring;
//   * epilogue: bias in f32, one bf16 rounding, the pixel shuffle into a
//     [2 rows, 128 columns, 64 channels] staging tile (128-byte swizzle),
//     then one TMA store per warpgroup, which clips at the image edge.
//     The store of one tile overlaps the next tile's mainloop.
//
// The wrapper repacks the weights once, when they are loaded, to
// [tap][packed column][input channel] with the columns of each
// 64-channel group ordered [phase q][channel t].

#include "conv3x3_tile.cuh"

namespace pesr {
namespace {

constexpr int kN = 256;            // packed conv columns per tile
constexpr int kGroup = kN / 4;     // output channels per tile
constexpr int kTileW = 64;         // conv pixels per row of a tile
constexpr int kStages = 6;         // weight ring depth
constexpr int kStageOut = 2 * 2 * kTileW * kGroup * 2;  // 32,768 B per warpgroup

struct Layout {
  static constexpr int kStageOff = 0;
  static constexpr int kWRingOff = 2 * kStageOut;
  static constexpr int kWinOff = kWRingOff + kStages * kN * kChunkBytes;
  static constexpr int kPipesOff = kWinOff + 2 * kWinBytes;
  static constexpr int kBytes = kPipesOff + sizeof(Pipes<kStages>);
  static_assert(kWRingOff % 1024 == 0 && kWinOff % 512 == 0, "swizzle alignment");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Cluster tile ct of the list: channel group g, and CTA tile u =
// kCluster * (ct / groups) + rank = (b * rpairs + rp) * segs + seg: image
// b, row pair rp, 64-pixel segment seg (b >= B: past the last CTA tile).
struct Tile {
  int b, g, y0, x0;  // y0: first conv row; x0: first pixel of this CTA
  __device__ __forceinline__ Tile(int ct, int groups, int segs, int rpairs, uint32_t rank) {
    g = ct % groups;
    const int u = kCluster * (ct / groups) + static_cast<int>(rank);
    const int t = u / segs;
    x0 = (u % segs) * kTileW;
    y0 = 2 * (t % rpairs);
    b = t / rpairs;
  }
};

// w: [9][4C][C] bf16 packed; bias: [4C] f32 packed.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    upsampler_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ bias,
                     int B, int H, int W, int tiles, int rpairs, int segs) {
  constexpr int KC = C / kKChunk;
  constexpr int G = C / kGroup;
  extern __shared__ __align__(1024) uint8_t smem[];
  auto& pipes = *reinterpret_cast<Pipes<kStages>*>(smem + Layout::kPipesOff);
  const uint32_t rank = cluster_rank();
  const int first = blockIdx.x / kCluster, stride = gridDim.x / kCluster;

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
      for (int ct = first; ct < tiles; ct += stride) {
        const Tile t(ct, G, segs, rpairs, rank);
        for (int kc = 0; kc < KC; ++kc) {
          produce_window(pipes, smem + Layout::kWinOff, ipos, &xmap, kc, t.x0 - 1, t.y0 - 1, t.b);
          for (int tap = 0; tap < 9; ++tap)
            produce_weights<kN>(pipes, smem + Layout::kWRingOff, wpos, &wmap, kc, t.g * kN, tap,
                                rank);
        }
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- two consumer warpgroups: conv row y0 + wg of each tile ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const bool leader = (threadIdx.x & 127) == 0;
    const uint32_t stage = smem_u32(smem + Layout::kStageOff + wg * kStageOut);
    const uint32_t wring = smem_u32(smem + Layout::kWRingOff);
    const WindowA wa{smem_u32(smem + Layout::kWinOff), wg, lane_row(), lane_khalf()};
    RingPos wpos, ipos;
    float acc[kN / 2];
    for (int ct = first; ct < tiles; ct += stride) {
      const Tile t(ct, G, segs, rpairs, rank);
      conv3x3_wgmma<kN, KC, kStages, true>(acc, pipes, wring, wpos, ipos, wa);
      // The previous tile's store has read the staging tile.
      if (leader) tma_store_wait_read();
      named_barrier(3 + wg, 128);
      // Packed column n = q * 64 + ch (phase q = 2i + j) of pixel p goes
      // to staging row i * 128 + 2p + j, channel ch; 16-byte chunk c of
      // a 128-byte row at c ^ (row & 7) (the TMA 128-byte swizzle).
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int n = 8 * j + 2 * (lane & 3), q = j / 8;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + t.g * kN + n));
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int p = warp * 16 + (lane >> 2) + 8 * v;
          const int row = (q >> 1) * (2 * kTileW) + 2 * p + (q & 1);
          const uint32_t a = stage + row * 128 + (((j % 8) ^ (row & 7)) << 4) + 4 * (lane & 3);
          const uint32_t val =
              pack_bf16x2(acc[4 * j + 2 * v] + bb.x, acc[4 * j + 2 * v + 1] + bb.y);
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(val) : "memory");
        }
      }
      fence_async_shared();
      named_barrier(3 + wg, 128);
      const int y = t.y0 + wg;
      if (leader && t.b < B && y < H)
        tma_store_4d(&omap, smem + Layout::kStageOff + wg * kStageOut, t.g * kGroup, 2 * t.x0,
                     2 * y, t.b);
    }
    if (leader) tma_store_wait_all();
    cluster_sync();
  }
}

template <int C>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           int tiles, int rpairs, int segs, int ctas, cudaStream_t stream) {
  CUtensorMap xm, wm, om;
  const uint64_t odims[4] = {uint64_t(C), uint64_t(2 * W), uint64_t(2 * H), uint64_t(B)};
  const uint64_t ostrides[3] = {uint64_t(C) * 2, uint64_t(2 * W) * C * 2,
                                uint64_t(4) * H * W * C * 2};
  const uint32_t obox[4] = {kGroup, 2 * kTileW, 2, 1};
  if (!make_window_map(&xm, x, B, H, W, C) || !make_weight_map(&wm, w, C, 4 * C, kN / kCluster) ||
      !make_map(&om, out, 4, odims, ostrides, obox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(upsampler_kernel<C>, ctas, Layout::kBytes, stream, xm,
                                          wm, om, static_cast<const float*>(bias), B, H, W, tiles,
                                          rpairs, segs));
}

}  // namespace
}  // namespace pesr

// x: [batch, H, W, C] bf16 NHWC; w: [3, 3, 4C, C] bf16 packed as
// [tap][packed column][input]; bias: [4C] f32 packed; out: [batch, 2H,
// 2W, C] bf16; all 16-byte aligned.  tiles / rpairs / segs / ctas:
// the schedule of upsampler_schedule (ctas a multiple of the cluster
// size 2).  Returns the CUDA error code of the launch (0 =
// launched).  C must be 64, 128 or 256.
extern "C" int pesr_fused_upsampler_stage(const void* x, const void* w, const void* bias,
                                          void* out, int batch, int H, int W, int C, int tiles,
                                          int rpairs, int segs, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas < pesr::kCluster || ctas % pesr::kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 64:
      return pesr::launch<64>(x, w, bias, out, batch, H, W, tiles, rpairs, segs, ctas, s);
    case 128:
      return pesr::launch<128>(x, w, bias, out, batch, H, W, tiles, rpairs, segs, ctas, s);
    case 256:
      return pesr::launch<256>(x, w, bias, out, batch, H, W, tiles, rpairs, segs, ctas, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of 2 CTAs the device runs at once (negative: minus the CUDA
// error code); the same for every C.
extern "C" int pesr_upsampler_max_clusters() {
  return pesr::max_active_clusters(pesr::upsampler_kernel<256>, pesr::Layout::kBytes);
}
