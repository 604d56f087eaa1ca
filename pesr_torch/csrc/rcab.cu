// Fused residual channel-attention block (RCAB; Zhang et al., "Image
// Super-Resolution Using Very Deep Residual Channel Attention Networks",
// ECCV 2018) for Hopper (sm_90a), at 64 channels:
//
//   x = h + s_prev * r_prev                       (the previous block's output)
//   r = conv3x3(relu(conv3x3(x) + b1)) + b2       (this block's branch)
//   pool[b][c] += sum over the tile of r[b][:, :, c]
//
// with s = sigmoid(Wu relu(Wd mean_hw(r) + bd) + bu) per image and channel
// (the squeeze MLP, Wd: C -> C / reduction, Wu: back to C).  SAME zero
// padding, bf16 activations and weights, f32 accumulation.
//
// It replaces no TPU kernel: the JAX package has no RCAN.  It was added
// because the channel attention puts a reduction over the whole tile
// between a block's second conv and its residual add, which no CTA of a
// fused residual block (resblock.cu) can see: s exists only once every
// CTA of the launch has pooled its part of the tile.  So a block's output
// h + s * r is left pending, and the NEXT block applies it as it loads its
// input: each launch reads the carry h and the branch r of the block
// before (its windows, by TMA), recomputes that block's s from its pooled
// partial sums (64 x C/16 + C/16 x 64 MACs per image, cheap enough for
// every CTA), writes the carry x it made and its own branch r, and leaves
// one partial sum per segment (below) and channel.  One launch per block;
// the last block of a residual group is applied by rcab_excite_kernel.
//
// What bounds it on the H100, per LR pixel and block at C = 64: the two
// convs are 147,456 FLOP (0.149 ns at 989 TFLOP/s); it reads h and r and
// writes x and r, 512 B (0.153 ns at 3.35 TB/s), against 256 B for a block
// whose output is final: the block sits at the ridge.  At 64 channels a
// weight stage (a 32-channel x 64-column box of one tap) feeds little MMA
// work, so the per-stage waits and loads of the mainloop, not the tensor
// cores, set the pace.  The design:
//
//   * one wave of CTAs, as many clusters of two as the device runs at
//     once: a tile's work is its image-strips (62 output columns each) in
//     steps of four rows, and each CTA runs a list of segments, as a rule
//     one contiguous run of those steps, cut so that the busiest CTA runs
//     as few steps as it can (rcab_schedule).  A run may cross a strip
//     and an image: each piece of it is a segment, resblock.cu's
//     line mode (conv1 into a ring of hidden rows, conv2 from it, the TMA
//     weight ring multicast across the cluster; conv3x3_tile.cuh), which
//     starts with a conv1-only step that fills its hidden ring.  The two
//     CTAs of a cluster run segments of the same lengths (the same weight
//     sequence).  In a step each consumer warpgroup runs two 64-pixel rows
//     per weight stage (four m64n64k16 MMAs on one pair of descriptors),
//     twice resblock.cu's work per wait; hence 6-row windows, an 8-row
//     hidden ring and an 8-stage weight ring.  A chunk's nine taps are
//     unrolled (constant A offsets), and its MMAs drain at its end;
//   * three warps of the producer warpgroup load each 32-channel chunk's
//     h window into the window ring and its r window beside it (TMA,
//     zero fill = SAME padding: h + s * 0 = 0 outside the image), apart
//     from the weight stream, and make the window x = bf16(h + s * r) in
//     place, in the same swizzled layout (a chunk's channel follows from
//     its swizzled position), so no extra pass moves x through device
//     memory.  The same warps write the carry x of the CTA's own pixels
//     (rows 2-5 of each step's window), so the consumers' epilogue reads
//     nothing from device memory;
//   * the conv2 epilogue writes r (bf16) and sums r (f32, before
//     rounding) over the segment's valid pixels per channel in registers.
//     At the segment's end the CTA reduces its sums in a fixed order and
//     writes its row of its image's P rows of partials, and the image's
//     last segment zeros the rows no segment fills: no atomics and no
//     memset, so a launch is deterministic;
//   * the combining warps recompute s where a run enters another image.
//
// Shared memory: hidden ring 65,536 B, weight ring 32,768 B, window and r
// rings 2 x 2 x 25,600 B, barriers, s, the squeeze's scratch and the
// reduction rows: 203,696 B (one CTA per SM).

#include <algorithm>

#include "conv3x3_tile.cuh"

namespace pesr {
namespace {

constexpr int kC = 64;                   // channels: the kernel takes C = 64 only
constexpr int kKC = kC / kKChunk;        // 32-channel chunks
constexpr int kHidW = 64;                // hidden row width (one m64 tile)
constexpr int kStripOut = kHidW - 2;     // output columns per strip
constexpr int kStepRows = 4;             // rows of a step: two per warpgroup
constexpr int kHidRows = 8;              // hidden ring rows
constexpr int kWin6Rows = kStepRows + 2; // window rows: a step's rows + halo
constexpr int kWin6Bytes = kWin6Rows * kWinW * kChunkBytes;  // 25,344
constexpr int kWinSlot = 25600;          // a window slot, 512-aligned
constexpr int kCombine = 96;             // combining threads: producer warps 1-3
constexpr int kMaxReduced = 64;          // widest squeeze (C / reduction)
constexpr int kConsumerWarps = kConsumers / 32;
// Weight ring depth: a stage (one 32-channel x 64-column box of one tap)
// feeds four m64n64k16 MMAs a warpgroup at C = 64.
constexpr int kStages = 8;

struct RcabBars {
  Pipes<kStages> p;
  uint64_t raw_full[2];
};

struct Layout {
  static constexpr int kPix = kC * 2;  // bytes of one hidden pixel
  static constexpr int kWRingOff = kHidRows * kHidW * kPix;
  static constexpr int kWinOff = kWRingOff + kStages * kC * kChunkBytes;
  static constexpr int kROff = kWinOff + 2 * kWinSlot;
  static constexpr int kBarsOff = kROff + 2 * kWinSlot;
  static constexpr int kSOff = kBarsOff + sizeof(RcabBars);
  static constexpr int kScratchOff = kSOff + kC * 4;
  static constexpr int kRedOff = kScratchOff + (kC + kMaxReduced) * 4;
  static constexpr int kBytes = kRedOff + kConsumerWarps * kC * 4;
  static_assert(kWRingOff % 1024 == 0 && kWinOff % 512 == 0 && kROff % 512 == 0 &&
                    kWinSlot % 512 == 0 && kWinSlot >= kWin6Bytes,
                "swizzle alignment");
  static_assert(sizeof(RcabBars) % 16 == 0, "alignment");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// The squeeze MLP of one image: s[c] = sigmoid(bu[c] + sum_j wu[c][j]
// relu(bd[j] + sum_c' wd[j][c'] mean[c'])), mean[c] = the sum of the P
// partials pool[b][p][c] over hw.  Threads t = 0 .. n - 1, n >= kC, call
// it together; sync() is their barrier.
struct Squeeze {
  const float* wd;  // [cr][C]
  const float* bd;  // [cr]
  const float* wu;  // [C][cr]
  const float* bu;  // [C]
  int cr;
};

template <class Sync>
__device__ void squeeze_excite(float* s, float* scratch, const float* __restrict__ pool, int P,
                               int b, float hw, const Squeeze& q, int t, Sync sync) {
  if (t < kC) {
    float a = 0.0f;
    for (int p = 0; p < P; ++p) a += pool[(static_cast<int64_t>(b) * P + p) * kC + t];
    scratch[t] = a / hw;
  }
  sync();
  if (t < q.cr) {
    float z = q.bd[t];
    for (int c = 0; c < kC; ++c) z += q.wd[t * kC + c] * scratch[c];
    scratch[kC + t] = fmaxf(z, 0.0f);
  }
  sync();
  if (t < kC) {
    float u = q.bu[t];
    for (int j = 0; j < q.cr; ++j) u += q.wu[t * q.cr + j] * scratch[kC + j];
    s[t] = 1.0f / (1.0f + expf(-u));
  }
  sync();
}

// s of image b for the combining threads (t = 0 .. kCombine - 1, barrier
// 4): the squeeze, or zeros past the batch (h = r = 0 there).
__device__ __forceinline__ void combine_scales(float* s, float* scratch, const float* pool, int P,
                                               int b, int B, float hw, const Squeeze& q, int t) {
  const auto sync = [] { named_barrier(4, kCombine); };
  if (b < B) {
    squeeze_excite(s, scratch, pool, P, b, hw, q, t, sync);
  } else {
    if (t < kC) s[t] = 0.0f;
    sync();
  }
}

// bf16(h + s r) for 8 channels (16 bytes) whose scales start at s: the
// product and the sum each rounded to f32 (no fused multiply-add), as the
// plain version computes it, then rounded to bf16 once.
__device__ __forceinline__ uint4 excite8(uint4 h, uint4 r, const float* s) {
  const uint32_t hw[4] = {h.x, h.y, h.z, h.w}, rw[4] = {r.x, r.y, r.z, r.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __fadd_rn(__uint_as_float(hw[i] << 16),
                               __fmul_rn(s[2 * i], __uint_as_float(rw[i] << 16)));
    const float hi = __fadd_rn(__uint_as_float(hw[i] & 0xffff0000u),
                               __fmul_rn(s[2 * i + 1], __uint_as_float(rw[i] & 0xffff0000u)));
    o[i] = pack_bf16x2(lo, hi);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Hidden ring: pixel q of hidden row k sits at ((k & 7) * 64 + q) * 2C
// bytes, its 16-byte chunk c at chunk c ^ (q & 7) (resblock.cu's layout,
// eight rows).
__device__ __forceinline__ uint32_t hidden_addr(uint32_t hid, int k, int q, int c) {
  return hid + ((k & (kHidRows - 1)) * kHidW + q) * Layout::kPix + ((c ^ (q & 7)) << 4);
}

// conv1's A address: row r of warpgroup wg (hidden row 4 s + 2 wg + r)
// reads window row 2 wg + r + dy, pixel p + dx.
struct WindowA2 {
  uint32_t wins;  // smem address of window slot 0
  int wg, p, kh;
  __device__ __forceinline__ uint32_t operator()(int slot, int, int dy, int dx, int k16,
                                                 int r) const {
    return sw64_addr(wins + slot * kWinSlot, (2 * wg + r + dy) * kWinW + p + dx, 2 * k16 + kh);
  }
};

// conv2's A address at step s: row r of warpgroup wg (output row
// y0 + 4 s - 4 + 2 wg + r) reads hidden row 4 s - 4 + 2 wg + r + dy,
// column p + dx (clamped for the two columns past the strip, whose
// outputs are dropped).
struct HiddenA2 {
  uint32_t hid;
  int wg, p, kh, s;
  __device__ __forceinline__ uint32_t operator()(int, int kc, int dy, int dx, int k16,
                                                 int r) const {
    return hidden_addr(hid, 4 * s - 4 + 2 * wg + r + dy, min(p + dx, kHidW - 1),
                       kc * 4 + 2 * k16 + kh);
  }
};

// One 3x3 conv of this warpgroup's two rows of 64 pixels into acc[0],
// acc[1] (zeroed first): conv3x3_tile.cuh's conv3x3_wgmma with each
// weight stage feeding both rows (four MMAs a stage, one descriptor
// pair), and the 9 taps of a chunk unrolled so that their A offsets are
// constants (at 64 channels a stage's MMAs are short, and the
// instructions around them would otherwise set the pace); the MMAs drain
// at the end of each chunk, which releases its window.
template <int KC, int WS, bool kWindowed, class AAddr>
__device__ __forceinline__ void conv3x3_rows2(float (&acc)[2][kC / 2], Pipes<WS>& p,
                                              uint32_t wring, RingPos& wpos, RingPos& ipos,
                                              AAddr a_addr) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) acc[r][i] = 0.0f;
  uint32_t a[2][2][2][4];  // [tap parity][row][k16]
#pragma unroll 1
  for (int kc = 0; kc < KC; ++kc) {
    if (kWindowed) mbar_wait(&p.in_full[ipos.slot<2>()], ipos.parity<2>());
    const int slot_in = ipos.slot<2>();
    uint32_t prev_w = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int h = tap & 1;
      const uint32_t ws = wpos.slot<WS>();
      mbar_wait(&p.w_full[ws], wpos.parity<WS>());
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ldmatrix_x4(a[h][r][0], a_addr(slot_in, kc, tap / 3, tap % 3, 0, r));
        ldmatrix_x4(a[h][r][1], a_addr(slot_in, kc, tap / 3, tap % 3, 1, r));
      }
      wgmma_fence();
      const uint32_t base = wring + ws * (kC * kChunkBytes);
      const uint64_t d0 = b_desc_sw64(base, 0), d1 = b_desc_sw64(base, 1);
      Wgmma<kC>::mma(acc[0], a[h][0][0], d0);
      Wgmma<kC>::mma(acc[0], a[h][0][1], d1);
      Wgmma<kC>::mma(acc[1], a[h][1][0], d0);
      Wgmma<kC>::mma(acc[1], a[h][1][1], d1);
      wgmma_commit();
      wgmma_wait<1>();
      if (tap > 0) release_weights(p, prev_w);
      prev_w = ws;
      ++wpos.n;
    }
    wgmma_wait<0>();
    release_weights(p, prev_w);
    if (kWindowed) {
      release_window(p, slot_in);
      ++ipos.n;
    }
  }
}

// The window map of a [B, H, W, C] NHWC tensor: boxes of 32 channels x
// 66 pixels x 6 rows, 64-byte swizzle, zero fill outside the image.
inline bool make_window6_map(CUtensorMap* map, const void* x, int B, int H, int W) {
  const uint64_t dims[4] = {uint64_t(kC), uint64_t(W), uint64_t(H), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(kC) * 2, uint64_t(W) * kC * 2,
                               uint64_t(H) * W * kC * 2};
  const uint32_t box[4] = {kKChunk, kWinW, kWin6Rows, 1};
  return make_map(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// Where a combining thread writes the carry x of its window pieces: the
// CTA's image b, strip x0, the window's first image row y, and whether
// its rows 2-5 are the CTA's (every step but the last: rows y0 + 4 s ..
// y0 + 4 s + 3 of the segment, each written once).
struct CarryOut {
  bf16* x;
  int b, B, H, W, x0, y;
  bool rows;
};

// The combining threads' part of chunk k (window slot k % 2, its
// 32-channel chunk kc = k % kKC): the first of them waits for the slot to
// be free and loads h into it and r into the r slot (TMA, zero fill:
// h + s * 0 = 0 outside the image); then each thread t makes its pieces
// x = bf16(h + s r) in place (h as it is without a pending block) and
// writes the CTA's own ones (window rows 2-5, columns 2-63) into the
// carry.  A 64-byte row of the box is one pixel's 32 channels of the
// chunk; its 16-byte piece v & 3 holds channels 8 c.., c = (v & 3) ^
// ((row >> 1) & 3) (the 64-byte swizzle).
__device__ __forceinline__ void combine_window(RcabBars& q, uint8_t* wins, uint8_t* rbuf, int k,
                                               const float* s, bool has_prev,
                                               const CUtensorMap* hmap, const CUtensorMap* rmap,
                                               const CarryOut& o, int t) {
  const uint32_t ws = k & 1, parity = (k >> 1) & 1;
  const int kc = k % kKC;
  uint8_t* win = wins + ws * kWinSlot;
  uint8_t* rw = rbuf + ws * kWinSlot;
  if (t == 0) {
    mbar_wait<true>(&q.p.in_empty[ws], parity ^ 1);
    mbar_expect_tx(&q.raw_full[ws], (has_prev ? 2 : 1) * kWin6Bytes);
    tma_load_4d(win, hmap, &q.raw_full[ws], kc * kKChunk, o.x0 - 2, o.y, o.b);
    if (has_prev) tma_load_4d(rw, rmap, &q.raw_full[ws], kc * kKChunk, o.x0 - 2, o.y, o.b);
  }
  mbar_wait<true>(&q.raw_full[ws], parity);
  uint4* xs = reinterpret_cast<uint4*>(win);
  const uint4* rs = reinterpret_cast<const uint4*>(rw);
  for (int v = t; v < kWin6Bytes / 16; v += kCombine) {
    const int row = v >> 2, c = (v & 3) ^ ((row >> 1) & 3);
    uint4 xv = xs[v];
    if (has_prev) {
      xv = excite8(xv, rs[v], s + kc * kKChunk + 8 * c);
      xs[v] = xv;
    }
    const int j = row / kWinW, col = row - j * kWinW;
    const int gy = o.y + j, gx = o.x0 - 2 + col;
    if (o.rows && j >= 2 && col >= 2 && col < 2 + kStripOut && gy < o.H && gx < o.W &&
        o.b < o.B)
      *reinterpret_cast<uint4*>(o.x + ((static_cast<int64_t>(o.b) * o.H + gy) * o.W + gx) * kC +
                                kc * kKChunk + 8 * c) = xv;
  }
  fence_async_shared();  // this thread's reads and writes before the next TMA into the slots
  mbar_arrive(&q.p.in_full[ws]);
}

// Barrier counts: as init_pipes, but a window is complete when the
// kCombine combining threads have arrived.
__device__ __forceinline__ void init_bars(RcabBars& q) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&q.p.w_full[i], 1);
    mbar_init(&q.p.w_empty[i], 8 * kCluster);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&q.p.in_full[i], kCombine);
    mbar_init(&q.p.in_empty[i], 8);
    mbar_init(&q.raw_full[i], 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One segment of a CTA's run (rcab_schedule in ops/kernels/rcab.py):
// image-strip g (image g / strips, output columns [62 (g % strips), +62)),
// 4-row steps [j0, j0 + n) (output rows [4 j0, 4 j0 + 4 n), those past the
// image computed on zeros and not stored; g past the batch stores
// nothing); its pooled sums go to row `row` of its image, zeros to the
// `fill` rows after it.
struct Segment {
  int g, j0, n, row, fill;
};
static_assert(sizeof(Segment) == 5 * sizeof(int), "the schedule's table layout");

// A launch is one wave: CTA i runs segments [runs[i], runs[i + 1]) of the
// Segment table that follows runs[0 .. gridDim.x], in order, carrying its
// rings from one to the next; the two CTAs of a cluster run segments of
// the same lengths, so they walk one multicast weight sequence.  A
// segment is resblock.cu's line-mode segment in steps of four rows: step
// s (0..n) runs conv1 on its hidden rows 4 s .. 4 s + 3 (image rows
// y0 - 1 + k, y0 = 4 j0), then (s > 0) conv2 on output rows
// y0 + 4 s - 4 .. y0 + 4 s - 1.  r_prev == nullptr: the first block of a
// group, whose input is h itself (x = h; r_prev is only tested, its
// windows come through rmap).
__global__ void __launch_bounds__(kThreads, 1)
    rcab_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap rmap,
                const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ r_prev,
                const float* __restrict__ pool_prev, int p_prev, Squeeze sq,
                const float* __restrict__ b1, const float* __restrict__ b2,
                bf16* __restrict__ x_out, bf16* __restrict__ r_out, float* __restrict__ pool_out,
                int B, int H, int W, int strips, int P, const int* __restrict__ runs) {
  using L = Layout;
  extern __shared__ __align__(1024) uint8_t smem[];
  auto& bars = *reinterpret_cast<RcabBars*>(smem + L::kBarsOff);
  float* s_vec = reinterpret_cast<float*>(smem + L::kSOff);
  float* scratch = reinterpret_cast<float*>(smem + L::kScratchOff);
  const uint32_t rank = cluster_rank();
  const bool has_prev = r_prev != nullptr;
  const float hw = static_cast<float>(H) * static_cast<float>(W);

  const int e0 = __ldg(runs + blockIdx.x), e1 = __ldg(runs + blockIdx.x + 1);
  const Segment* segs = reinterpret_cast<const Segment*>(runs + gridDim.x + 1);
  const int b_first = e0 < e1 ? __ldg(&segs[e0].g) / strips : B;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();
    init_bars(bars);
  }
  if (has_prev && b_first < B) {
    squeeze_excite(s_vec, scratch, pool_prev, p_prev, b_first, hw, sq, threadIdx.x,
                   [] { __syncthreads(); });
  } else if (threadIdx.x < kC) {
    s_vec[threadIdx.x] = 0.0f;
  }
  __syncthreads();
  cluster_sync();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: thread 0 issues the weights' TMA loads;
    // warps 1-3 load h and r, combine them into the windows and write the
    // carry ----
    const int t = threadIdx.x - kConsumers;
    if (t == 0) {
      RingPos wpos;
      for (int si = e0; si < e1; ++si) {
        const int steps = __ldg(&segs[si].n);
        for (int s = 0; s <= steps; ++s) {
          for (int kc = 0; kc < kKC; ++kc)
            for (int tap = 0; tap < 9; ++tap)
              produce_weights<kC>(bars.p, smem + L::kWRingOff, wpos, &w1map, kc, 0, tap, rank);
          if (s > 0)
            for (int kc = 0; kc < kKC; ++kc)
              for (int tap = 0; tap < 9; ++tap)
                produce_weights<kC>(bars.p, smem + L::kWRingOff, wpos, &w2map, kc, 0, tap, rank);
        }
      }
    } else if (t >= 32) {
      // Chunk k counts on across segments (window slot k % 2); a step's
      // window starts at image row y0 - 2 + 4 s.
      int k = 0, b_s = b_first;  // b_s: the image s_vec is for
      for (int si = e0; si < e1; ++si) {
        const int g = __ldg(&segs[si].g), steps = __ldg(&segs[si].n);
        const int b = g / strips, x0 = (g % strips) * kStripOut;
        const int y0 = kStepRows * __ldg(&segs[si].j0);
        if (has_prev && b != b_s) {
          named_barrier(4, kCombine);  // every combining thread is done with image b_s
          combine_scales(s_vec, scratch, pool_prev, p_prev, b, B, hw, sq, t - 32);
          b_s = b;
        }
        for (int i = 0; i < (steps + 1) * kKC; ++i, ++k) {
          const int s = i / kKC;
          combine_window(bars, smem + L::kWinOff, smem + L::kROff, k, s_vec, has_prev, &hmap,
                         &rmap, CarryOut{x_out, b, B, H, W, x0, y0 - 2 + 4 * s, s < steps},
                         t - 32);
        }
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- two consumer warpgroups, two rows each: conv1 -> hidden ring ->
    // conv2 ----
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, q = lane & 3;
    const uint32_t hid = smem_u32(smem), wring = smem_u32(smem + L::kWRingOff);
    const WindowA2 wa{smem_u32(smem + L::kWinOff), wg, lane_row(), lane_khalf()};
    float* red = reinterpret_cast<float*>(smem + L::kRedOff);
    RingPos wpos, ipos;
    float acc[2][kC / 2];
    for (int si = e0; si < e1; ++si) {
      const int g = __ldg(&segs[si].g), steps = __ldg(&segs[si].n);
      const int b = g / strips, x0 = (g % strips) * kStripOut;
      const int y0 = kStepRows * __ldg(&segs[si].j0);
      float psum[kC / 4];  // channel 8 j + 2 q + e at 2 j + e
#pragma unroll
      for (int i = 0; i < kC / 4; ++i) psum[i] = 0.0f;
      for (int s = 0; s <= steps; ++s) {
        conv3x3_rows2<kKC, kStages, true>(acc, bars.p, wring, wpos, ipos, wa);
        // conv2 of step s-1 is done with the ring (a segment's last one:
        // its barrier 3)
        if (s > 0) named_barrier(1, kConsumers);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // hidden row k = 4 s + 2 wg + r (image row y0 - 1 + k)
          const int k = kStepRows * s + 2 * wg + r, gy = y0 - 1 + k;
          const bool row_in = gy >= 0 && gy < H;
#pragma unroll
          for (int j = 0; j < kC / 8; ++j) {
            const int n = 8 * j + 2 * q;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + n));
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int p = warp * 16 + (lane >> 2) + 8 * v;
              const int gx = x0 - 1 + p;
              const bool in = row_in && gx >= 0 && gx < W;
              const float h0 = in ? fmaxf(acc[r][4 * j + 2 * v] + bb.x, 0.0f) : 0.0f;
              const float h1 = in ? fmaxf(acc[r][4 * j + 2 * v + 1] + bb.y, 0.0f) : 0.0f;
              const uint32_t a = hidden_addr(hid, k, p, j) + 4 * q;
              asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(pack_bf16x2(h0, h1))
                           : "memory");
            }
          }
        }
        named_barrier(2, kConsumers);  // the hidden rows of step s are written
        if (s == 0) continue;
        conv3x3_rows2<kKC, kStages, false>(acc, bars.p, wring, wpos, ipos,
                                           HiddenA2{hid, wg, lane_row(), lane_khalf(), s});
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = y0 + kStepRows * (s - 1) + 2 * wg + r;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int p = warp * 16 + (lane >> 2) + 8 * v;
            const int gx = x0 + p;
            const bool valid = b < B && o < H && p < kStripOut && gx < W;
            const int64_t pix = (static_cast<int64_t>(b) * H + o) * W + gx;
#pragma unroll
            for (int t = 0; t < kC / 32; ++t) {
              uint32_t e[4];
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const int j = 4 * t + g;
                const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * q));
                const float r0 = acc[r][4 * j + 2 * v] + bb.x;
                const float r1 = acc[r][4 * j + 2 * v + 1] + bb.y;
                psum[2 * j] += valid ? r0 : 0.0f;
                psum[2 * j + 1] += valid ? r1 : 0.0f;
                e[g] = pack_bf16x2(r0, r1);
              }
              quad_transpose(e);  // lane q: the 8 channels of group 4 t + q
              if (valid)
                *reinterpret_cast<uint4*>(r_out + pix * kC + 8 * (4 * t + q)) =
                    make_uint4(e[0], e[1], e[2], e[3]);
            }
          }
        }
      }
      // The segment's sums: over the 8 lanes of each q, then over the 8
      // warps in order, into its row of image b (and zeros into the fill
      // rows after it).  The next segment writes `red` only after its
      // first barrier 2, when these reads are done.
#pragma unroll
      for (int i = 0; i < kC / 4; ++i)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], m);
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          red[(threadIdx.x >> 5) * kC + 8 * j + 2 * lane] = psum[2 * j];
          red[(threadIdx.x >> 5) * kC + 8 * j + 2 * lane + 1] = psum[2 * j + 1];
        }
      named_barrier(3, kConsumers);
      if (threadIdx.x < kC && b < B) {
        float a = 0.0f;
        for (int w = 0; w < kConsumerWarps; ++w) a += red[w * kC + threadIdx.x];
        const int row = __ldg(&segs[si].row), fill = __ldg(&segs[si].fill);
        float* out = pool_out + (static_cast<int64_t>(b) * P + row) * kC + threadIdx.x;
        out[0] = a;
        for (int z = 1; z <= fill; ++z) out[z * kC] = 0.0f;
      }
    }
    cluster_sync();
  }
}

// out = bf16(h + s r) over image blockIdx.y, s from the pooled partials
// (the last block of a residual group, whose output no later RCAB applies).
__global__ void __launch_bounds__(256)
    rcab_excite_kernel(const bf16* __restrict__ h, const bf16* __restrict__ r,
                       const float* __restrict__ pool, int P, Squeeze sq, bf16* __restrict__ out,
                       int H, int W) {
  __shared__ float s[kC], scratch[kC + kMaxReduced];
  const int b = blockIdx.y;
  squeeze_excite(s, scratch, pool, P, b, static_cast<float>(H) * static_cast<float>(W), sq,
                 threadIdx.x, [] { __syncthreads(); });
  const int64_t per = static_cast<int64_t>(H) * W * (kC / 8);  // 16-byte pieces per image
  const uint4* hv = reinterpret_cast<const uint4*>(h) + b * per;
  const uint4* rv = reinterpret_cast<const uint4*>(r) + b * per;
  uint4* ov = reinterpret_cast<uint4*>(out) + b * per;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < per;
       v += static_cast<int64_t>(gridDim.x) * blockDim.x)
    ov[v] = excite8(hv[v], rv[v], s + 8 * static_cast<int>(v % (kC / 8)));
}

bool valid_squeeze(const Squeeze& q) {
  return q.cr >= 1 && q.cr <= kMaxReduced && q.wd && q.bd && q.wu && q.bu;
}

}  // namespace
}  // namespace pesr

// h, r_prev, x_out, r_out: [B, H, W, 64] bf16 NHWC, 16-byte aligned (the
// outputs alias no input); r_prev == nullptr: no pending block (x = h;
// pool_prev is not read).  pool_prev: [B][p_prev][64] f32 partial sums of
// r_prev; wd [cr][64], bd [cr], wu [64][cr], bu [64] f32: the squeeze of
// the block before.  w1, w2: [3, 3, 64, 64] bf16 packed [tap][output]
// [input]; b1, b2: [64] f32.  strips (of 62 columns), P, ctas and runs
// (device int32: ctas + 1 offsets, then the Segment table): the schedule
// of rcab_schedule, ctas a multiple of 2 that the device runs at once;
// pool_out: [B][P][64] f32.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int pesr_fused_rcab(const void* h, const void* r_prev, const void* pool_prev,
                               int p_prev, const void* wd, const void* bd, const void* wu,
                               const void* bu, int cr, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* x_out, void* r_out,
                               void* pool_out, int B, int H, int W, int C, int strips, int P,
                               int ctas, const void* runs, void* stream) {
  using namespace pesr;
  const Squeeze sq{static_cast<const float*>(wd), static_cast<const float*>(bd),
                   static_cast<const float*>(wu), static_cast<const float*>(bu), cr};
  if (C != kC || strips != (W + kStripOut - 1) / kStripOut || P < 1 || ctas < kCluster ||
      ctas % kCluster || runs == nullptr ||
      (r_prev != nullptr && (p_prev < 1 || pool_prev == nullptr || !valid_squeeze(sq))))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap hm, rm, w1m, w2m;
  if (!make_window6_map(&hm, h, B, H, W) ||
      !make_window6_map(&rm, r_prev != nullptr ? r_prev : h, B, H, W) ||
      !make_weight_map(&w1m, w1, kC, kC, kC / kCluster) ||
      !make_weight_map(&w2m, w2, kC, kC, kC / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      rcab_kernel, ctas, Layout::kBytes, static_cast<cudaStream_t>(stream), hm, rm, w1m, w2m,
      static_cast<const bf16*>(r_prev),
      static_cast<const float*>(pool_prev), p_prev, sq, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<bf16*>(x_out), static_cast<bf16*>(r_out),
      static_cast<float*>(pool_out), B, H, W, strips, P, static_cast<const int*>(runs)));
}

// out = bf16(h + s r), s the squeeze of r's pooled partials pool [B][p][64];
// h, r, out [B, H, W, 64] bf16 NHWC, 16-byte aligned.
extern "C" int pesr_rcab_excite(const void* h, const void* r, const void* pool, int p,
                                const void* wd, const void* bd, const void* wu, const void* bu,
                                int cr, void* out, int B, int H, int W, int C, void* stream) {
  using namespace pesr;
  const Squeeze sq{static_cast<const float*>(wd), static_cast<const float*>(bd),
                   static_cast<const float*>(wu), static_cast<const float*>(bu), cr};
  if (C != kC || p < 1 || B < 1 || !valid_squeeze(sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = static_cast<int64_t>(H) * W * (kC / 8);
  const int blocks = static_cast<int>(std::min<int64_t>((per + 255) / 256, 128));
  rcab_excite_kernel<<<dim3(blocks, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(r), static_cast<const float*>(pool),
      p, sq, static_cast<bf16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of 2 CTAs of rcab_kernel the device runs at once (negative:
// minus the CUDA error code).
extern "C" int pesr_rcab_max_clusters() {
  return pesr::max_active_clusters(pesr::rcab_kernel, pesr::Layout::kBytes);
}
