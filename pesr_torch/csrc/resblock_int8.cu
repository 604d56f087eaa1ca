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
//     66 pixels (zero fill = SAME padding; 0 quantizes to 0) into one bf16
//     slot; three warps of the producer warpgroup quantize each chunk once
//     with qin1 into one of three int8 windows, off the MMA path, while
//     the consumers run the nine taps of an earlier chunk;
//   * conv1's epilogue requantizes into an int8 hidden ring of 4 rows x
//     64 pixels (64 KB at C = 256), hidden pixels outside the image 0;
//     the hidden activation, an im2col or any f32 tensor never reach
//     device memory;
//   * conv2's epilogue dequantizes, reads the bf16 carry once more for
//     the residual and writes the output as 16-byte vectors;
//   * int8 weights, packed once at load time, stream through a 5-stage
//     TMA ring multicast across a cluster of 2 CTAs, 64 channels a stage.
//
// The epilogues stall the MMAs of both warpgroups (they share every weight
// stage), so they are made short without changing a bit:
//   * both convs' output channels are packed in an order
//     (output_channel_orders in resblock_int8.py) that hands each lane
//     channels lying side by side: conv1's epilogue stores 16 hidden bytes
//     per st.shared.v4 and loads its mq, bq as float4; conv2's moves the
//     carry and the output as 16-byte vectors with no shuffle and loads
//     m2, b2 as float4, once for both pixel rows;
//   * the requant clips at 0 by the saturation of a multiply by 2^-7 and
//     rounds by a fused add of 1.5 x 2^23 to 128 times it (requant);
//   * the residual's two bf16 roundings of a product and a sum of bf16
//     values are mul.rn.bf16x2 / add.rn.bf16x2, each the f32 operation
//     rounded to bf16 (bf16x2_mul);
//   * the carry is loaded after conv2's MMAs (loaded before them, its 32
//     registers made ptxas spill), the second pixel row's vector by
//     vector.
//
// Line mode with a ragged last strip covers every W >= 1 (a strip of 62
// columns clipped to the image), so there is no flat mode: the int8
// engines' tiles are wide.  C must be 64, 128 or 256.
//
// Shared memory at C = 256: hidden ring 65,536 B, weight ring 5 x 256 x
// 64 B = 81,920 B, bf16 slot 33,792 B, three int8 windows 50,688 B,
// barriers 176 B: 232,112 of 232,448 B.
//
// What holds it back now (PERF.md, Findings): the two epilogues, in which
// the tensor cores idle (the residual's carry and output traffic comes in
// one burst from all CTAs at once), and a mainloop that reads 56 KB of
// shared memory per weight stage.

#include "conv3x3_s8.cuh"

namespace pesr {
namespace {

constexpr int kHidW = 64;             // hidden row width (one m64 tile)
constexpr int kStripOut = kHidW - 2;  // output columns per strip

template <int C>
struct Layout {
  static constexpr int kHidden = 4 * kHidW * C;  // int8 hidden ring
  static constexpr int kWRing = kS8WStages * C * kChunkBytes;
  static constexpr int kWRingOff = kHidden;
  static constexpr int kSlotOff = kWRingOff + kWRing;       // the bf16 window slot
  static constexpr int kWin8Off = kSlotOff + kS8SlotBytes;  // the int8 windows
  static constexpr int kPipesOff = kWin8Off + kS8Wins * kS8WinBytes;
  static constexpr int kS8PipesOff = kPipesOff + sizeof(Pipes<kS8WStages>);
  static constexpr int kBytes = kS8PipesOff + sizeof(S8Pipes);
  static_assert(kWRingOff % 1024 == 0 && kSlotOff % 512 == 0 && kS8SlotBytes % 512 == 0 &&
                    kWin8Off % 512 == 0 && kS8WinBytes % 512 == 0 && kPipesOff % 8 == 0,
                "swizzle alignment");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Register budgets after setmaxnreg: their sum over the warpgroups is
// what the launch gives one CTA (168 x 384 = 64,512).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 168 * kThreads,
              "register budgets");

// Hidden ring: pixel q of hidden row k sits at ((k & 3) * 64 + q) * C
// bytes, its 16-byte chunk c at chunk c ^ (q & m), m = min(C / 16, 8) - 1
// (bank-conflict-free for ldmatrix at C >= 128).
template <int C>
__device__ __forceinline__ uint32_t hidden_addr(uint32_t hid, int k, int q, int c) {
  constexpr int kMask = (C / 16 < 8 ? C / 16 : 8) - 1;
  return hid + ((k & 3) * kHidW + q) * C + ((c ^ (q & kMask)) << 4);
}

// conv1's A address: the warpgroup's pixel p of row wg reads pixel
// (wg + dy, p + dx) of int8 window `win`, 16-byte chunk 2 h + kh.
struct WindowA {
  uint32_t win8;  // smem address of int8 window 0
  int wg, p, kh;
  __device__ __forceinline__ uint32_t operator()(uint32_t win, int, int dy, int dx, int h) const {
    return sw64_addr(win8 + win * kS8WinBytes, (wg + dy) * kWinW + p + dx, 2 * h + kh);
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
  __device__ __forceinline__ uint32_t operator()(uint32_t, int kc, int dy, int dx, int h) const {
    return hidden_addr<C>(hid, 2 * s - 2 + wg + dy, min(p + dx, kHidW - 1), kc * 4 + 2 * h + kh);
  }
};

// conv1 -> conv2's int8 input, rint(clip(f32(acc) * m + b, 0, 127)), in
// the low byte.  The clip to 0 is the saturation of a multiply by 2^-7
// (exact: it clamps t / 128 to [0, 1]), and rint the add of 1.5 x 2^23
// to 128 times it (one rounding of an exact value), so that only the
// clip to 127 takes an FMNMX.
__device__ __forceinline__ uint32_t requant(int32_t acc, float m, float b) {
  const float t = fminf(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b), 127.0f);
  float c;
  asm("mul.rn.sat.f32 %0, %1, 0f3C000000;" : "=f"(c) : "f"(t));  // 0f3C000000 = 2^-7
  return __float_as_uint(__fmaf_rn(c, 128.0f, 12582912.0f));
}

// conv1's epilogue for hidden row k (image row gy) into the ring.  With
// conv1's output channels in the packed order (output_channel_orders in
// resblock_int8.py), lane r of a quad holds channels 64 u + 16 r .. + 15
// of pixels p and p + 8 in its D fragment (8-column groups j = 8 u + i,
// columns 2 r, 2 r + 1): it requantizes them with 16 consecutive mq, bq
// and stores one 16-byte chunk; hidden pixels outside the image are 0.
template <int C>
__device__ __forceinline__ void requant_epilogue(const int32_t (&acc)[C / 2], uint32_t hid, int k,
                                                 int gy, int x0, int H, int W,
                                                 const float* __restrict__ mq,
                                                 const float* __restrict__ bq) {
  const int lane = threadIdx.x & 31, r = lane & 3;
  const int p0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const bool row_in = gy >= 0 && gy < H;
#pragma unroll
  for (int u = 0; u < C / 64; ++u) {
    // channel 64 u + 16 r + 2 i + e: mm[i / 2], component 2 (i & 1) + e
    float4 mm[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mm[i] = __ldg(reinterpret_cast<const float4*>(mq + 64 * u + 16 * r) + i);
      bb[i] = __ldg(reinterpret_cast<const float4*>(bq + 64 * u + 16 * r) + i);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int p = p0 + 8 * v, gx = x0 - 1 + p;
      const uint32_t in = row_in && gx >= 0 && gx < W ? ~0u : 0u;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j0 = 8 * u + 2 * i, j1 = j0 + 1;  // word i: channels 4 i .. + 3
        w[i] = in & pack_s8x4(requant(acc[4 * j0 + 2 * v], mm[i].x, bb[i].x),
                              requant(acc[4 * j0 + 2 * v + 1], mm[i].y, bb[i].y),
                              requant(acc[4 * j1 + 2 * v], mm[i].z, bb[i].z),
                              requant(acc[4 * j1 + 2 * v + 1], mm[i].w, bb[i].w));
      }
      st_shared_v4(hidden_addr<C>(hid, k, p, 4 * u + r), w[0], w[1], w[2], w[3]);
    }
  }
}

// bf16 pairs: round(a * b) and round(a + b), each half rounded once to
// nearest even.  For bf16 operands with a normal f32 result they equal
// the f32 operation rounded to bf16 (PyTorch's bf16 arithmetic): the
// product of two bf16 values is exact in f32, and rounding a sum to f32
// and then to bf16 is rounding it to bf16 (24 >= 2 x 8 + 2 bits).
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two output channels (the bf16 pair yw of the carry): y + bf16(rs *
// bf16(f32(acc) * m + b)), as a bf16 pair; rs2 holds the bf16 res_scale
// in both halves.
__device__ __forceinline__ uint32_t residual2(uint32_t yw, int32_t a0, int32_t a1, float2 m,
                                              float2 b, uint32_t rs2) {
  const uint32_t y2 = pack_bf16x2(__fadd_rn(__fmul_rn(__int2float_rn(a0), m.x), b.x),
                                  __fadd_rn(__fmul_rn(__int2float_rn(a1), m.y), b.y));
  return bf16x2_add(yw, bf16x2_mul(rs2, y2));
}

// With conv2's output channels in the packed order (output_channel_orders
// in resblock_int8.py), lane r of a quad holds channels 32 i + 8 r .. + 7
// of its pixels in D-fragment groups 4 i .. 4 i + 3 (columns 2 r, 2 r + 1
// of each): one 16-byte vector of the carry and of the output, the quad
// two whole 32-byte sectors of a pixel.

// This lane's carry vectors at flat pixel `pix` (pixel 0 if not `valid`).
template <int C>
__device__ __forceinline__ void load_carry(uint4 (&cy)[C / 32], const bf16* __restrict__ y,
                                           int64_t pix, bool valid) {
  const bf16* at = y + (valid ? pix : 0) * C + 8 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < C / 32; ++i) cy[i] = *reinterpret_cast<const uint4*>(at + 32 * i);
}

// conv2's epilogue of both pixel rows of this lane's D fragment (v = 0,
// 1: flat pixels pix0, pix1, stored if valid0, valid1; the same for the 4
// lanes of a quad), the first row's carry in c0 (load_carry), the
// second's loaded vector by vector (both in registers: ptxas spills).
template <int C>
__device__ __forceinline__ void residual_epilogue_s8(const int32_t (&acc)[C / 2],
                                                     const uint4 (&c0)[C / 32],
                                                     const float* __restrict__ m2,
                                                     const float* __restrict__ b2,
                                                     const bf16* __restrict__ y,
                                                     bf16* __restrict__ out, int64_t pix0,
                                                     bool valid0, int64_t pix1, bool valid1,
                                                     uint32_t rs2) {
  const int n0 = 8 * (threadIdx.x & 3);
  const bf16* y1 = y + (valid1 ? pix1 : 0) * C + n0;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const uint4 c1 = *reinterpret_cast<const uint4*>(y1 + 32 * i);
    // channel 32 i + n0 + 2 e + f: group 4 i + e, column 2 r + f
    const float4* mp = reinterpret_cast<const float4*>(m2 + 32 * i + n0);
    const float4* bp = reinterpret_cast<const float4*>(b2 + 32 * i + n0);
    const float4 ma = __ldg(mp), mb = __ldg(mp + 1), ba = __ldg(bp), bb = __ldg(bp + 1);
    const float2 m[4] = {{ma.x, ma.y}, {ma.z, ma.w}, {mb.x, mb.y}, {mb.z, mb.w}};
    const float2 b[4] = {{ba.x, ba.y}, {ba.z, ba.w}, {bb.x, bb.y}, {bb.z, bb.w}};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 cy = v ? c1 : c0[i];
      const uint32_t yw[4] = {cy.x, cy.y, cy.z, cy.w};
      uint32_t r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = residual2(yw[e], acc[16 * i + 4 * e + 2 * v], acc[16 * i + 4 * e + 2 * v + 1],
                         m[e], b[e], rs2);
      if (v ? valid1 : valid0)
        *reinterpret_cast<uint4*>(out + (v ? pix1 : pix0) * C + 32 * i + n0) =
            make_uint4(r[0], r[1], r[2], r[3]);
    }
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
  auto& pipes = *reinterpret_cast<Pipes<kS8WStages>*>(smem + L::kPipesOff);
  auto& s8p = *reinterpret_cast<S8Pipes*>(smem + L::kS8PipesOff);
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
    init_s8_pipes(s8p);
    init_pipes(pipes);  // its fence publishes both sets of barriers
  }
  __syncthreads();
  cluster_sync();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x - kConsumers;
    if (t == 0) {
      // ---- producer warp 0, one thread: the weight ring ----
      uint8_t* wring = smem + L::kWRingOff;
      RingPos wpos;
      for (int s = 0; s <= steps; ++s) {
        for (int kc = 0; kc < KC; ++kc)
          for (int tap = 0; tap < 9; ++tap)
            produce_weights_s8<C>(pipes, wring, wpos, &w1map, kc, tap, rank);
        if (s > 0)
          for (int kc = 0; kc < KC; ++kc)
            for (int tap = 0; tap < 9; ++tap)
              produce_weights_s8<C>(pipes, wring, wpos, &w2map, kc, tap, rank);
      }
    } else if (t >= 32) {
      // ---- producer warps 1-3: quantize each window chunk g (step g /
      // KC, input chunk g % KC); their first thread loads the next chunk
      // into the bf16 slot as soon as all of them are done with it ----
      const int qt = t - 32, chunks = (steps + 1) * KC;
      uint8_t* slot = smem + L::kSlotOff;
      const uint32_t win8 = smem_u32(smem + L::kWin8Off);
      auto window = [&](int g) {
        produce_slot_s8(s8p, slot, g, &ymap, g % KC, x0 - 2, y0 - 2 + 2 * (g / KC), b);
      };
      if (qt == 0) window(0);
      RingPos wq;
      for (int g = 0; g < chunks; ++g) {
        const uint32_t w = wq.slot<kS8Wins>();
        mbar_wait<true>(&s8p.slot_full, g & 1);
        mbar_wait<true>(&s8p.win_empty[w], wq.parity<kS8Wins>() ^ 1);
        quantize_chunk(smem_u32(slot), win8 + w * kS8WinBytes, qin1, g % KC, qt);
        mbar_arrive(&s8p.slot_empty);
        mbar_arrive(&s8p.win_full[w]);
        if (qt == 0 && g + 1 < chunks) window(g + 1);
        ++wq.n;
      }
    }
    __syncwarp();
    cluster_sync();
  } else {
    // ---- two consumer warpgroups: conv1 -> int8 hidden ring -> conv2 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t hid = smem_u32(smem), wring = smem_u32(smem + L::kWRingOff);
    const WindowA wa{smem_u32(smem + L::kWin8Off), wg, lane_row(), lane_khalf()};
    const uint32_t rs2 = (__float_as_uint(res_scale) >> 16) * 0x10001u;
    const int p0 = warp * 16 + (lane >> 2);  // this lane's pixels: p0, p0 + 8
    RingPos wpos, ipos;
    int32_t acc[C / 2];
    for (int s = 0; s <= steps; ++s) {
      // conv1 on hidden row k = 2s + wg (image row y0 - 1 + k).
      conv3x3_s8<C, C, kS8WStages, true>(acc, pipes, s8p, wring, wpos, ipos, wa);
      if (s > 0) named_barrier(1, kConsumers);  // conv2 of step s-1 is done with the ring
      requant_epilogue<C>(acc, hid, 2 * s + wg, y0 - 1 + 2 * s + wg, x0, H, W, mq, bq);
      release_last_window(s8p, ipos);
      named_barrier(2, kConsumers);  // the hidden rows of step s are written
      if (s == 0) continue;
      // conv2 on output row o = y0 + 2s - 2 + wg, pixels x0 + p0 (v = 0)
      // and x0 + p0 + 8 (v = 1).
      conv3x3_s8<C, C, kS8WStages, false>(acc, pipes, s8p, wring, wpos, ipos,
                                          HiddenA<C>{hid, wg, lane_row(), lane_khalf(), s});
      const int o = y0 + 2 * s - 2 + wg;
      const int64_t row = (static_cast<int64_t>(b) * H + o) * W + x0;
      const bool in = b < B && o < H;
      const bool valid0 = in && p0 < kStripOut && x0 + p0 < W;
      const bool valid1 = in && p0 + 8 < kStripOut && x0 + p0 + 8 < W;
      uint4 c0[C / 32];
      load_carry<C>(c0, y, row + p0, valid0);
      residual_epilogue_s8<C>(acc, c0, m2, b2, y, out, row + p0, valid0, row + p0 + 8, valid1,
                              rs2);
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
