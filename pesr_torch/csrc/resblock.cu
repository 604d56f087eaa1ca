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
// fits in shared memory can amortise over many pixels.  Two
// decompositions, chosen per shape by the wrapper
// (pesr_torch/ops/kernels/resblock.py, resblock_schedule):
//
// Line mode (wide images; the inference and eval tile batches):
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
//     the residual comes from global memory in the epilogue.
//
// Flat mode (narrow images, 2 <= W <= 48: the training patches).  A
// 64-pixel row wastes a quarter of every MMA at W = 48, so here the
// pixels of the batch are one flat sequence o = (b H + y) W + x and a CTA
// owns `span` consecutive ones (a multiple of 64, rows and images
// crossed freely).  Each step runs conv1 on the next 128 hidden pixels
// and conv2 on the next 128 output pixels; ldmatrix takes one address
// per A row, so every lane gathers its own pixel's taps, and a tap
// outside the image (a row of the neighbouring image, a column past the
// edge) reads a zero pixel instead.  conv1's grid runs W + 1 pixels
// ahead of conv2's (step j ends where conv2 step j - 1's last tap
// ends), so the hidden ring holds 128 + 2W + 2 <= kRing pixels of the
// flat sequence and a span costs span / 128 + 1 conv1 and span / 128
// conv2 steps.  Where span is an odd number of 64s, the last step is
// warpgroup 0's alone (warpgroup 1 waits out its stages without MMAs);
// it runs after the loop of full steps, whose control flow must not
// depend on the warpgroup or the compiler gives up the uniform
// registers of the mainloop (its SASS then moves each weight descriptor
// with R2UR before the HGMMA, and the loop runs slower).
// At [16, 48, 48]: 116 CTAs of 320 pixels, 6 step-equivalents each,
// 1.21x the useful FLOPs (line mode: 7 steps, 1.56x).  conv1's input
// streams as windows of the rows its 128 pixels touch (W + 2 pixels x
// up to 6 rows at W = 48).
//
// Both modes' conv2 epilogue moves the residual and the output as
// 16-byte vectors (residual_epilogue, conv3x3_tile.cuh): a quarter of the
// load and store instructions of 4-byte ones, and whole 32-byte sectors.
// The epilogue does not overlap the MMAs: every CTA reaches it at about
// the same time, so its traffic comes in bursts.
//
// Both modes stream the weights through the 4-stage TMA ring of
// conv3x3_tile.cuh, multicast across a cluster of 2 CTAs (neighbouring
// strips or spans) that walk the same weight sequence: L2 serves each
// weight byte once per 2 x 128 pixels of a step.
//
// Shared memory at C = 256, line mode: hidden ring 4 x 64 px x 512 B =
// 131,072 B, weight ring 4 x 256 x 64 B = 65,536 B, window ring 2 x
// 16,896 B, barriers: 230,496 B of the 232,448.  Flat mode: hidden ring
// 232 px = 118,784 B, the same weight ring, window ring 2 x 19,968 B
// (the largest window, W = 42: 44 x 7 pixels x 64 B), a zero pixel of
// 512 B, barriers: 224,864 B.
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
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int p = warp * 16 + (lane >> 2) + 8 * v;
        const int gx = x0 + p;
        residual_epilogue<C>(acc, v, b2, x, out, (static_cast<int64_t>(b) * H + o) * W + gx,
                             b < B && o < H && p < kStripOut && gx < W, res_scale);
      }
    }
    cluster_sync();
  }
}

// ---------------------------------------------------------- flat mode ---

constexpr int kRing = 232;             // hidden ring pixels: >= 128 + 2W + 2
constexpr int kFlatMaxW = 48;          // widest image of flat mode
constexpr int kFlatWinBytes = 19968;   // window slot: >= (W + 2) x rows x 64 B, 512-aligned

template <int C>
struct FlatLayout {
  static constexpr int kPix = C * 2;
  static constexpr int kWRingOff = kRing * kPix;
  static constexpr int kWinOff = kWRingOff + kWStages * C * kChunkBytes;
  static constexpr int kZeroOff = kWinOff + 2 * kFlatWinBytes;
  static constexpr int kPipesOff = kZeroOff + kPix;
  static constexpr int kBytes = kPipesOff + sizeof(Pipes<kWStages>);
  static_assert(kWRingOff % 1024 == 0 && kWinOff % 512 == 0 && kFlatWinBytes % 512 == 0,
                "swizzle alignment");
  static_assert(kRing >= 128 + 2 * kFlatMaxW + 2, "hidden ring");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Rows of conv1's window at width W: the most image rows 128 consecutive
// flat pixels touch, plus the conv's halo row above and below.
__host__ __device__ constexpr int flat_window_rows(int W) { return (W + 126) / W + 3; }

// floor(a / b) for b > 0 and a >= -128 b (every caller: a > -128), with no
// branch on the sign.
__device__ __forceinline__ int floor_div(int a, int b) { return (a + 128 * b) / b - 128; }

// Flat hidden ring: flat pixel position q (relative to the CTA's first
// output - 128) sits in slot q % kRing, its 16-byte chunk c at chunk
// c ^ (slot & 7).
template <int C>
__device__ __forceinline__ uint32_t ring_addr(uint32_t hid, int slot, int c) {
  return hid + slot * FlatLayout<C>::kPix + ((c ^ (slot & 7)) << 4);
}

// conv1's A address in flat mode: this lane's hidden pixel reads window
// pixel q + dy (W + 2) + dx, or the zero pixel where tap row dy lies
// outside its image (bit dy of `rows` clear).  `smem`: the shared
// memory's address (the window ring and the zero pixel sit at fixed
// offsets from it).
template <int C>
struct FlatWindowA {
  uint32_t smem;
  int q, ww;
  uint32_t rows;
  int kh;
  __device__ __forceinline__ uint32_t operator()(int slot, int, int dy, int dx, int k16) const {
    const int ch = 2 * k16 + kh;
    const uint32_t in = 0u - ((rows >> dy) & 1);  // all ones: the tap row is in the image
    return (sw64_addr(smem + FlatLayout<C>::kWinOff + slot * kFlatWinBytes, q + dy * ww + dx,
                      ch) & in) |
           ((smem + FlatLayout<C>::kZeroOff + (ch << 4)) & ~in);
  }
};

// conv2's A address in flat mode: this lane's output pixel reads ring
// slot pos + dy W + dx (mod kRing; pos < kRing), or the zero pixel where
// the tap lies outside the image (bit 3 dy + dx of `taps` clear).  The
// hidden ring sits at `smem`.
template <int C>
struct FlatHiddenA {
  uint32_t smem;
  int pos, w;
  uint32_t taps;
  int kh;
  __device__ __forceinline__ uint32_t operator()(int, int kc, int dy, int dx, int k16) const {
    const int ch = kc * 4 + 2 * k16 + kh;
    int slot = pos + dy * w + dx;
    slot -= slot >= kRing ? kRing : 0;
    const uint32_t in = 0u - ((taps >> (3 * dy + dx)) & 1);  // all ones: the tap is in the image
    return (ring_addr<C>(smem, slot, ch) & in) |
           ((smem + FlatLayout<C>::kZeroOff + (ch << 4)) & ~in);
  }
};

// CTA i owns output pixels [i span, i span + span) of the flat sequence
// (those at or past `total` = B H W: nothing; a CTA may own none, to pad
// the grid to a multiple of kCluster).  Step s (0..steps) runs conv1 on
// hidden pixels [hs, hs + 128), hs = i span + 128 (s - 1) + W + 1, then
// (s > 0) conv2 on outputs [i span + 128 (s - 1), + 128).
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_flat_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                         const float* __restrict__ b1, const float* __restrict__ b2,
                         bf16* __restrict__ out, int H, int W, int total, float res_scale,
                         int span, int wrows) {
  using L = FlatLayout<C>;
  constexpr int KC = C / kKChunk;
  extern __shared__ __align__(1024) uint8_t smem[];
  auto& pipes = *reinterpret_cast<Pipes<kWStages>*>(smem + L::kPipesOff);
  const uint32_t rank = cluster_rank();
  const int o0 = blockIdx.x * span;
  const int steps = (span + 127) / 128;

  static_assert(L::kPix / 16 <= kThreads, "zero pixel");
  if (threadIdx.x < L::kPix / 16)
    reinterpret_cast<uint4*>(smem + L::kZeroOff)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
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
      const int win_bytes = wrows * (W + 2) * kChunkBytes;
      RingPos wpos, ipos;
      for (int s = 0; s <= steps; ++s) {
        const int row0 = floor_div(o0 + 128 * (s - 1) + W + 1, W) - 1;
        for (int kc = 0; kc < KC; ++kc) {
          produce_window(pipes, smem + L::kWinOff, ipos, &xmap, kc, -1, row0, 0, kFlatWinBytes,
                         win_bytes);
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
    // ---- two consumer warpgroups: 64 pixels each per conv step ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t hid = smem_u32(smem), wring = smem_u32(smem + L::kWRingOff);
    const int oend = min(o0 + span, total);
    RingPos wpos, ipos;
    float acc[C / 2];
    // Step s: conv1 on hidden pixels [hs, hs + 128), then (s > 0) conv2 on
    // outputs [k0, k0 + 128), k0 = o0 + 128 (s - 1); a warpgroup that is
    // not `active` has no pixels in the step and only keeps the rings in
    // step.
    auto step = [&](int s, bool active) {
      const int hs = o0 + 128 * (s - 1) + W + 1;
      if (active) {
        // This lane's A row: hidden pixel h, image row r of the flat batch
        // (row y of its image; h < 0 only in a CTA's first step, a pixel
        // before the batch whose hidden value no output reads).
        const int h = hs + 64 * wg + lane_row();
        const int r = floor_div(h, W);
        const int y = (r + 128 * H) % H;
        uint32_t rows = 0;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          rows |= static_cast<uint32_t>(static_cast<unsigned>(y + dy - 1) <
                                        static_cast<unsigned>(H))
                  << dy;
        const FlatWindowA<C> wa{hid, (r - floor_div(hs, W)) * (W + 2) + h - r * W, W + 2, rows,
                                lane_khalf()};
        conv3x3_wgmma<C, KC, kWStages, true>(acc, pipes, wring, wpos, ipos, wa);
      } else {
        conv3x3_skip<KC, kWStages, true>(pipes, wpos, ipos);
      }
      if (s > 0) named_barrier(1, kConsumers);  // conv2 of step s-1 is done with the ring
      if (active) {
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + n));
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = warp * 16 + (lane >> 2) + 8 * v;
            const int slot = (hs - o0 + 128 + 64 * wg + p) % kRing;
            const float h0 = fmaxf(acc[4 * j + 2 * v] + bb.x, 0.0f);
            const float h1 = fmaxf(acc[4 * j + 2 * v + 1] + bb.y, 0.0f);
            const uint32_t a = ring_addr<C>(hid, slot, j) + 4 * (lane & 3);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(pack_bf16x2(h0, h1))
                         : "memory");
          }
        }
      }
      named_barrier(2, kConsumers);  // the hidden pixels of step s are written
      if (s == 0) return;
      const int k0 = o0 + 128 * (s - 1);
      if (!active) {
        conv3x3_skip<KC, kWStages, false>(pipes, wpos, ipos);
        return;
      }
      const int o = k0 + 64 * wg + lane_row();
      const int r = o / W, c = o - r * W, y = r % H;
      uint32_t taps = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          taps |= static_cast<uint32_t>(
                      static_cast<unsigned>(y + dy - 1) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(c + dx - 1) < static_cast<unsigned>(W))
                  << (3 * dy + dx);
      conv3x3_wgmma<C, KC, kWStages, false>(
          acc, pipes, wring, wpos, ipos,
          FlatHiddenA<C>{hid, (o - W - 1 - (o0 - 128)) % kRing, W, taps, lane_khalf()});
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int po = k0 + 64 * wg + warp * 16 + (lane >> 2) + 8 * v;
        residual_epilogue<C>(acc, v, b2, x, out, po, po < oend, res_scale);
      }
    };
    // Every step but the last in a loop whose control flow does not
    // depend on the warpgroup: a branch on it there costs the mainloop
    // its uniform registers.  Where span is an odd number of 64s,
    // warpgroup 1 sits the last step out.
    const bool half = (span & 127) != 0;
    for (int s = 0; s < steps; ++s) step(s, true);
    step(steps, !half || wg == 0);
    cluster_sync();
  }
}

template <int C>
int launch_flat(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* out, int B, int H, int W, float res_scale, int span, int ctas,
                cudaStream_t stream) {
  const int wrows = flat_window_rows(W);
  if (W < 2 || W > kFlatMaxW || (W + 2) * wrows * kChunkBytes > kFlatWinBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, w1m, w2m;
  // The batch as one tall image of B H rows: a window may cross images
  // (the kernel reads the zero pixel for a tap in the neighbouring one).
  const uint64_t dims[4] = {uint64_t(C), uint64_t(W), uint64_t(B) * H, 1};
  const uint64_t strides[3] = {uint64_t(C) * 2, uint64_t(W) * C * 2,
                               uint64_t(B) * H * W * C * 2};
  const uint32_t box[4] = {kKChunk, uint32_t(W + 2), uint32_t(wrows), 1};
  if (!make_map(&xm, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_weight_map(&w1m, w1, C, C, C / kCluster) ||
      !make_weight_map(&w2m, w2, C, C, C / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      resblock_flat_kernel<C>, ctas, FlatLayout<C>::kBytes, stream, xm, w1m, w2m,
      static_cast<const bf16*>(x), static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<bf16*>(out), H, W, B * H * W, res_scale, span, wrows));
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
// [C] f32.  rows / strips / segs / ctas / span: the schedule of
// resblock_schedule.  span = 0: line mode (rows even; ctas a multiple of
// the cluster size 2 and >= batch * strips * segs); span > 0: flat mode
// (span a multiple of 64, 2 <= W <= 48, ctas even and ctas * span >=
// batch * H * W).  Returns the CUDA error code of the launch (0 =
// launched).  C must be 64, 128 or 256.
extern "C" int pesr_fused_resblock(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out, int batch,
                                   int H, int W, int C, float res_scale, int rows, int strips,
                                   int segs, int ctas, int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas % pesr::kCluster) return static_cast<int>(cudaErrorInvalidValue);
  if (span > 0) {
    if (span % 64 || static_cast<int64_t>(ctas) * span < static_cast<int64_t>(batch) * H * W)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (C) {
      case 64:
        return pesr::launch_flat<64>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, span,
                                     ctas, s);
      case 128:
        return pesr::launch_flat<128>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, span,
                                      ctas, s);
      case 256:
        return pesr::launch_flat<256>(x, w1, b1, w2, b2, out, batch, H, W, res_scale, span,
                                      ctas, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rows < 2 || rows % 2 || ctas < batch * strips * segs)
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
