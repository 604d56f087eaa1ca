// Shared device code of the int8 (W8A8) 3x3-conv kernel (resblock_int8.cu):
// the s8 counterparts of conv3x3_tile.cuh's bf16 pieces, which it reuses
// for everything that is not about the element type (barriers, TMA,
// window maps, the 64-byte swizzle, the cluster launch).
//
//   * MMA: wgmma.mma_async m64 x N x k32, s8 x s8 -> s32, A from registers
//     (the RS form takes s8: the k32 s8 A fragment has the byte layout of
//     the k16 bf16 one, so ldmatrix.b16 loads it from int8 rows as is);
//   * weights: int8, packed once to [tap][output column][input channel]
//     (K-major); a ring stage carries 64 input channels x N columns, one
//     64-byte swizzled row per column: the bytes of a 32-channel bf16
//     stage, so the bf16 B descriptor (b_desc_sw64) addresses the two
//     k32 halves of a stage as it addresses the two k16 halves there;
//   * quantize off the MMA path: conv1's bf16 input arrives in 64-channel
//     window chunks (4 rows x 66 pixels) in one bf16 slot.  Warps 1-3 of
//     the producer warpgroup (kQuantizers threads; warp 0 keeps the
//     weight ring) quantize each chunk into one of kS8Wins int8 windows
//     (64-byte rows, the TMA tile's swizzle), and their first thread loads
//     the next chunk into the slot (TMA) as soon as all of them are done
//     with it.  Full / empty mbarriers (S8Pipes) hand the slot and the
//     windows between TMA, quantizers and consumers: the consumers wait
//     only for a window that is not ready, never on a named barrier, and
//     the weight ring's thread never waits for a window.  Three windows
//     let the quantizers run two chunks ahead of the MMAs (faster than
//     two on the H100: PERF.md, Findings).
//
// Rounding: every float operation is one IEEE operation rounded to
// nearest even (__fmul_rn, __fadd_rn, __int2float_rn), as PyTorch's
// elementwise kernels compute the plain version; nothing is contracted
// into an FMA.  rint is an add of 1.5 x 2^23 (see rint_bits), exact for
// the clamped values and cheaper than a conversion instruction.

#pragma once

#include <type_traits>
#include <utility>

#include "conv3x3_tile.cuh"

namespace pesr {

constexpr int kS8Chunk = 64;                 // int8 input channels per K stage
constexpr int kS8SlotBytes = 2 * kWinBytes;  // the bf16 window slot: two 32-channel boxes
constexpr int kS8WinBytes = kWinBytes;       // an int8 window: 4 x 66 pixels x 64 B
constexpr int kS8WStages = 5;                // weight ring depth
constexpr int kS8Wins = 3;                   // int8 windows
constexpr int kQuantizers = 96;              // producer warps 1-3

// The window barriers of the int8 kernel (its weight ring keeps
// conv3x3_tile.cuh's Pipes): the bf16 slot (filled by TMA, emptied by the
// quantizers) and the int8 windows (filled by the quantizers, emptied by
// the 8 consumer warps).
struct S8Pipes {
  uint64_t slot_full, slot_empty, win_full[kS8Wins], win_empty[kS8Wins];
};

__device__ __forceinline__ void init_s8_pipes(S8Pipes& q) {
  mbar_init(&q.slot_full, 1);
  mbar_init(&q.slot_empty, kQuantizers);
  for (int i = 0; i < kS8Wins; ++i) {
    mbar_init(&q.win_full[i], kQuantizers);
    mbar_init(&q.win_empty[i], 8);
  }
}

// ---------------------------------------------------------------- PTX ---

// wgmma m64 x N x k32, A from registers (4 x 4 s8), B by descriptor,
// D += A * B in s32.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int32_t (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ __forceinline__ static void mma(int32_t (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p;\n}"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void ld_shared_v4(uint4& v, uint32_t addr) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// ------------------------------------------------------------ quantize ---

// rint(clip(v, lo, 127)) in the low byte of the result's bits: for |t|
// <= 127, t + 1.5 x 2^23 is an integer-valued float whose low mantissa
// bits hold rint(t) in two's complement (rounded to nearest, ties to
// even: 1.5 x 2^23 is even).  Clipping before rint equals clipping
// after it, the bounds being integers.
__device__ __forceinline__ uint32_t rint_bits(float t, float lo) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(t, lo), 127.0f), 12582912.0f));
}

// clip(rint(v * s), -127, 127) in the low byte (torch.round: half to even).
__device__ __forceinline__ uint32_t quant_bits(float v, float s) {
  return rint_bits(__fmul_rn(v, s), -127.0f);
}

// The low bytes of a, b, c, d as one word (byte 0 from a).
__device__ __forceinline__ uint32_t pack_s8x4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Quantizer thread qt's share (0 <= qt < kQuantizers) of conv1's window
// chunk kc: the 64 bf16 channels of the slot at `slot` (two 32-channel
// halves) quantized with qin into the int8 window at `win8`.  The thread
// owns 8 channels, c8 = 4 h + c (16-byte chunk c of half h), of pixels
// pix0 + 12 i; a quarter warp takes 2 pixels x 4 chunks of one half, so
// its 16-byte loads cover one 128-byte row pair: no bank conflict.  Its
// 8 scales stay in registers for the chunk.
__device__ __forceinline__ void quantize_chunk(uint32_t slot, uint32_t win8,
                                               const float* __restrict__ qin, int kc, int qt) {
  const int c = qt & 3, h = (qt >> 3) & 1, c8 = 4 * h + c;
  const float4* sc = reinterpret_cast<const float4*>(qin + kc * kS8Chunk + 8 * c8);
  const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1);
  const uint32_t src = slot + h * kWinBytes;
#pragma unroll 2
  for (int pix = ((qt >> 2) & 1) + 2 * (qt >> 4); pix < kWinRows * kWinW;
       pix += kQuantizers / 8) {
    uint4 u;
    ld_shared_v4(u, sw64_addr(src, pix, c));
    const uint32_t lo = pack_s8x4(quant_bits(__uint_as_float(u.x << 16), s0.x),
                                  quant_bits(__uint_as_float(u.x & 0xffff0000u), s0.y),
                                  quant_bits(__uint_as_float(u.y << 16), s0.z),
                                  quant_bits(__uint_as_float(u.y & 0xffff0000u), s0.w));
    const uint32_t hi = pack_s8x4(quant_bits(__uint_as_float(u.z << 16), s1.x),
                                  quant_bits(__uint_as_float(u.z & 0xffff0000u), s1.y),
                                  quant_bits(__uint_as_float(u.w << 16), s1.z),
                                  quant_bits(__uint_as_float(u.w & 0xffff0000u), s1.w));
    // bytes 8 c8 .. + 7 of the int8 row: 8-byte half (c8 & 1) of its
    // 16-byte chunk c8 / 2
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(sw64_addr(win8, pix, c8 >> 1) +
                                                           8 * (c8 & 1)),
                 "r"(lo), "r"(hi)
                 : "memory");
  }
}

// ----------------------------------------------------------- mainloop ---

// Producer side: the next int8 weight box (tap, input chunk kc of 64
// channels, all N columns) into the ring, this CTA loading 1 / kCluster
// of the columns and multicasting them to the cluster.
template <int N, int WS>
__device__ __forceinline__ void produce_weights_s8(Pipes<WS>& p, uint8_t* wring, RingPos& pos,
                                                   const CUtensorMap* map, int kc, int tap,
                                                   uint32_t rank) {
  const uint32_t s = pos.slot<WS>();
  constexpr int kPart = N / kCluster;
  mbar_wait<true>(&p.w_empty[s], pos.parity<WS>() ^ 1);
  mbar_expect_tx(&p.w_full[s], N * kChunkBytes);
  tma_load_3d_mc(wring + s * (N * kChunkBytes) + rank * kPart * kChunkBytes, map, &p.w_full[s],
                 kc * kS8Chunk, rank * kPart, tap, static_cast<uint16_t>((1u << kCluster) - 1));
  ++pos.n;
}

// Producer side: conv1's window of input chunk kc (64 bf16 channels) from
// (x0, y0) of image b, as two 32-channel boxes of the window map into the
// two halves of the bf16 slot, once the quantizers have emptied it (fill
// n, counted from 0).
__device__ __forceinline__ void produce_slot_s8(S8Pipes& q, uint8_t* slot, uint32_t n,
                                                const CUtensorMap* map, int kc, int x0, int y0,
                                                int b) {
  mbar_wait<true>(&q.slot_empty, (n & 1) ^ 1);
  mbar_expect_tx(&q.slot_full, kS8SlotBytes);
  tma_load_4d(slot, map, &q.slot_full, kc * kS8Chunk, x0, y0, b);
  tma_load_4d(slot + kWinBytes, map, &q.slot_full, kc * kS8Chunk + kKChunk, x0, y0, b);
}

// f(integral_constant<int, S>) for S = 0, 1, ..., in order.
template <class F, int... S>
__device__ __forceinline__ void unroll_stages(F&& f, std::integer_sequence<int, S...>) {
  (f(std::integral_constant<int, S>{}), ...);
}

// One 3x3 s8 conv of this warpgroup's 64 pixels into acc (zeroed first):
// 9 * (C / 64) stages in the order kc-major, tap-minor, matching the
// producer, two k32 MMAs each; a_addr(win, kc, dy, dx, h) gives this
// lane's ldmatrix address of k32 half h of the stage's A rows (win: the
// int8 window of the chunk).  kConv1: A is the int8 window that the
// quantizers filled (waited for at each chunk's first tap, released after
// its last; the last chunk's window is left to the caller to release, see
// release_last_window); otherwise the hidden ring.
template <int N, int C, int WS, bool kConv1, class AAddr>
__device__ __forceinline__ void conv3x3_s8(int32_t (&acc)[N / 2], Pipes<WS>& p, S8Pipes& q,
                                           uint32_t wring, RingPos& wpos, RingPos& ipos,
                                           AAddr a_addr) {
  constexpr int kStages = 9 * (C / kS8Chunk);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  uint32_t a[2][2][4];
  uint32_t prev_w = 0;
  // Stage s into A buffer hb (= s & 1: the MMA of stage s - 1, on the
  // other buffer, may still run; that of s - 2 has completed).
  auto stage = [&](auto hc, int s) {
    constexpr int hb = decltype(hc)::value;
    const int kc = s / 9, tap = s % 9;
    const uint32_t win = ipos.slot<kS8Wins>();
    if (kConv1 && tap == 0) mbar_wait(&q.win_full[win], ipos.parity<kS8Wins>());
    const uint32_t ws = wpos.slot<WS>();
    mbar_wait(&p.w_full[ws], wpos.parity<WS>());
#pragma unroll
    for (int h = 0; h < 2; ++h) ldmatrix_x4(a[hb][h], a_addr(win, kc, tap / 3, tap % 3, h));
    wgmma_fence();
    const uint32_t base = wring + ws * (N * kChunkBytes);
    WgmmaS8<N>::mma(acc, a[hb][0], b_desc_sw64(base, 0));
    WgmmaS8<N>::mma(acc, a[hb][1], b_desc_sw64(base, 1));
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) release_weights(p, prev_w);
    if (kConv1 && tap == 8) {
      // the chunk's A fragments are in registers: the window is free
      if (kc + 1 < C / kS8Chunk && (threadIdx.x & 31) == 0) mbar_arrive(&q.win_empty[win]);
      ++ipos.n;
    }
    prev_w = ws;
    ++wpos.n;
  };
  if constexpr (kStages % 2) {
    // C = 64: 9 stages, unrolled (after a loop of pairs, a ninth stage
    // made ptxas serialize the wgmma: C7513).
    unroll_stages(
        [&](auto sc) {
          constexpr int s = decltype(sc)::value;
          stage(std::integral_constant<int, s & 1>{}, s);
        },
        std::make_integer_sequence<int, kStages>{});
  } else {
#pragma unroll 1
    for (int s = 0; s < kStages; s += 2) {
      stage(std::integral_constant<int, 0>{}, s);
      stage(std::integral_constant<int, 1>{}, s + 1);
    }
  }
  wgmma_wait<0>();
  release_weights(p, prev_w);
}

// Consumer side: release the int8 window of conv1's last chunk (ipos has
// moved past it).  Called after conv1's epilogue, so that the quantizers
// fill it with the next step's second chunk while conv2's MMAs run, not
// while the epilogue needs the FP32 pipes.
__device__ __forceinline__ void release_last_window(S8Pipes& q, const RingPos& ipos) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&q.win_empty[(ipos.n - 1) % kS8Wins]);
}

// ------------------------------------------------------------- host ---

// The map of packed int8 weights [9][ncols][cin]: boxes of 64 input
// channels x `rows` output columns of one tap, 64-byte swizzle.
inline bool make_s8_weight_map(CUtensorMap* map, const void* w, int cin, int ncols, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(w) & 15) != 0) return false;
  const cuuint64_t dims[3] = {uint64_t(cin), uint64_t(ncols), 9};
  const cuuint64_t strides[2] = {uint64_t(cin), uint64_t(ncols) * cin};
  const cuuint32_t box[3] = {kS8Chunk, uint32_t(rows), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pesr
