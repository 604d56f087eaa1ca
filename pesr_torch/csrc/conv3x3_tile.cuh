// Shared device code of the two fused 3x3-conv kernels (resblock.cu,
// upsampler.cu): the Hopper counterpart of pesr_tpu/ops/pallas/common.py.
//
// The TPU kernels cut the padded activation into overlapping halo windows
// in HBM (common.halo_tiles) and run each 3x3 conv as nine full-tile
// matmuls (common.conv3x3_shift_acc).  Here each conv is an implicit GEMM
// on the Hopper tensor cores, M = output pixels, N = output columns,
// K = 9 taps x C input channels, bf16 in, f32 accumulate:
//
//   * warp specialisation: warpgroups 0 and 1 are consumers, each issuing
//     wgmma.mma_async m64 x N x k16 on 64 pixels of one image row;
//     warpgroup 2 is the producer, one thread of which issues every TMA
//     load.  setmaxnreg moves registers from the producer to the
//     consumers;
//   * A (activations) comes from registers (the RS form of wgmma), loaded
//     with ldmatrix from a window in shared memory.  Every lane gives the
//     address of its own pixel, so output pixel p reads window pixel
//     p + (dy, dx) for any window width: no virtual columns, no
//     recompute beyond the conv's halo;
//   * B (weights) comes from shared memory through a wgmma descriptor.
//     The wrappers repack the weights once, at load time, to
//     [tap][output column][input channel] (K-major), and TMA streams
//     32-channel x N-column boxes (64-byte swizzle) into a ring of
//     kWStages = 4 stages guarded by full/empty mbarriers;
//   * clusters of kCluster = 2 CTAs walk the same weight sequence on
//     neighbouring pixels: each CTA loads half of every weight box and
//     multicasts it to both, so L2 serves each weight byte once per
//     cluster (the H100 runs 66 clusters of 2 at once, every SM, but
//     only 30 of 4: PERF.md, Findings);
//   * activation windows stream in 32-channel chunks (TMA, 64-byte
//     swizzle, zero fill outside the image = SAME padding);
//   * epilogues read the f32 accumulators from registers in the wgmma
//     D-fragment layout.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pesr {

using bf16 = __nv_bfloat16;

constexpr int kKChunk = 32;            // input channels per K stage
constexpr int kChunkBytes = kKChunk * 2;  // one 64-byte swizzle row
constexpr int kWinW = 66;              // window width: 64 pixels + halo
constexpr int kWinRows = 4;            // two output rows + halo
constexpr int kWinBytes = kWinRows * kWinW * kChunkBytes;  // 16,896 = 33 x 512
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = 384;          // + one producer warpgroup
constexpr int kWStages = 4;            // weight ring depth
constexpr int kCluster = 2;            // CTAs sharing each weight fetch
constexpr int kMaxSmem = 232448;       // dynamic shared memory of one block

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase with `parity` to complete.  With kGuard (the
// producer's waits), a wait of more than ~2^35 cycles (~20 s) can only be
// a broken pipeline: it traps, so that the launch fails with an error
// instead of hanging the card (a stuck consumer stalls the producer too).
// The consumers' waits stay unguarded: the two registers of the clock
// push their loop past the budget ptxas needs to keep wgmma asynchronous.
template <bool kGuard = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  if (kGuard) t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (kGuard && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// 4-D tiled TMA load global -> this CTA's shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 3-D tiled TMA load, multicast to the CTAs of `mask` (same smem offset
// and barrier offset in each).
__device__ __forceinline__ void tma_load_3d_mc(void* dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1, int c2,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "h"(mask)
      : "memory");
}

// 4-D tiled TMA store shared -> global (out-of-bounds elements are not
// written), as one bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy shared-memory writes -> visible to TMA (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma descriptor of a K-major B tile with 64-byte swizzle: rows of 64 B
// (32 bf16 of K), 8-row groups 512 B apart.  k16 = 0 / 1 selects the
// first / second 16 channels (32 B into each swizzled row).
__device__ __forceinline__ uint64_t b_desc_sw64(uint32_t saddr, int k16) {
  const uint64_t start = ((saddr + 32u * k16) & 0x3FFFFu) >> 4;
  return start | (1ull << 16) | (uint64_t(512 >> 4) << 32) | (2ull << 62);
}

// Byte address of 16-byte chunk `c` (0..3) of 64-byte row `row` in a
// TMA tile with 64-byte swizzle at 512-aligned `base`.
__device__ __forceinline__ uint32_t sw64_addr(uint32_t base, int row, int c) {
  return base + row * 64 + ((c ^ ((row >> 1) & 3)) << 4);
}

// wgmma m64 x N x k16, A from registers (bf16 pairs, the mma.sync A
// fragment of the warp's 16 rows), B by descriptor, D += A * B in f32.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// ----------------------------------------------------------- mainloop ---

// Ring position: stage index and the phase parity of its barriers.
struct RingPos {
  uint32_t n = 0;  // items consumed (or produced) so far
  template <int S>
  __device__ __forceinline__ uint32_t slot() const { return n % S; }
  template <int S>
  __device__ __forceinline__ uint32_t parity() const { return (n / S) & 1; }
};

// The barriers of the weight ring (WS stages) and the window ring (2).
template <int WS>
struct Pipes {
  uint64_t w_full[WS], w_empty[WS], in_full[2], in_empty[2];
};

// Producer side: the next weight box (tap, input chunk kc, columns
// [n0, n0 + N)) into the ring, this CTA (rank of kCluster) loading
// 1/kCluster of it (the map's box is N / kCluster columns) and
// multicasting to the cluster.
template <int N, int WS>
__device__ __forceinline__ void produce_weights(Pipes<WS>& p, uint8_t* wring, RingPos& pos,
                                                const CUtensorMap* map, int kc, int n0,
                                                int tap, uint32_t rank) {
  const uint32_t s = pos.slot<WS>();
  constexpr int kPart = N / kCluster;
  mbar_wait<true>(&p.w_empty[s], pos.parity<WS>() ^ 1);
  mbar_expect_tx(&p.w_full[s], N * kChunkBytes);
  tma_load_3d_mc(wring + s * (N * kChunkBytes) + rank * kPart * kChunkBytes, map, &p.w_full[s],
                 kc * kKChunk, n0 + rank * kPart, tap,
                 static_cast<uint16_t>((1u << kCluster) - 1));
  ++pos.n;
}

// Producer side: the next activation window chunk, the map's box (32
// channels x `bytes` / 64 pixels) from (x0, y0) of image b (zero outside
// the image), into window slot `pos` of `slot_bytes` bytes each.
template <int WS>
__device__ __forceinline__ void produce_window(Pipes<WS>& p, uint8_t* wins, RingPos& pos,
                                               const CUtensorMap* map, int kc, int x0, int y0,
                                               int b, int slot_bytes = kWinBytes,
                                               int bytes = kWinBytes) {
  const uint32_t s = pos.slot<2>();
  mbar_wait<true>(&p.in_empty[s], pos.parity<2>() ^ 1);
  mbar_expect_tx(&p.in_full[s], bytes);
  tma_load_4d(wins + s * slot_bytes, map, &p.in_full[s], kc * kKChunk, x0, y0, b);
  ++pos.n;
}

// Consumer side: release weight stage `s` in every CTA of the cluster
// (lane 0 of every consumer warp arrives: 8 per CTA, 8 kCluster in all).
template <int WS>
__device__ __forceinline__ void release_weights(Pipes<WS>& p, uint32_t s) {
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&p.w_empty[s], r);
  }
}

template <int WS>
__device__ __forceinline__ void release_window(Pipes<WS>& p, uint32_t s) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&p.in_empty[s]);
}

// Producer-side barrier counts: weights are released by 8 consumer warps
// in each of the kCluster CTAs, windows by the 8 consumer warps of this
// CTA.
template <int WS>
__device__ __forceinline__ void init_pipes(Pipes<WS>& p) {
  for (int i = 0; i < WS; ++i) {
    mbar_init(&p.w_full[i], 1);
    mbar_init(&p.w_empty[i], 8 * kCluster);
  }
  for (int i = 0; i < 2; ++i) {
    mbar_init(&p.in_full[i], 1);
    mbar_init(&p.in_empty[i], 8);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One 3x3 conv of this warpgroup's 64 pixels into acc (zeroed first):
// 9 * KC stages in the order kc-major, tap-minor, matching the producer.
// a_addr(slot, kc, dy, dx, k16) gives this lane's ldmatrix row address
// (slot: the window ring's current slot); with
// kWindowed the A rows come from the streamed window ring (a window
// chunk per kc, released after its ninth tap).
template <int N, int KC, int WS, bool kWindowed, class AAddr>
__device__ __forceinline__ void conv3x3_wgmma(float (&acc)[N / 2], Pipes<WS>& p,
                                              uint32_t wring, RingPos& wpos, RingPos& ipos,
                                              AAddr a_addr) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  uint32_t a[2][2][4];
  uint32_t prev_w = 0, prev_in = 0;
#pragma unroll 1
  for (int st = 0; st < 9 * KC; st += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = st + h;
      const int kc = s / 9, tap = s % 9;
      if (kWindowed && tap == 0) mbar_wait(&p.in_full[ipos.slot<2>()], ipos.parity<2>());
      const uint32_t ws = wpos.slot<WS>();
      mbar_wait(&p.w_full[ws], wpos.parity<WS>());
      const int slot_in = ipos.slot<2>();
      ldmatrix_x4(a[h][0], a_addr(slot_in, kc, tap / 3, tap % 3, 0));
      ldmatrix_x4(a[h][1], a_addr(slot_in, kc, tap / 3, tap % 3, 1));
      wgmma_fence();
      const uint32_t base = wring + ws * (N * kChunkBytes);
      Wgmma<N>::mma(acc, a[h][0], b_desc_sw64(base, 0));
      Wgmma<N>::mma(acc, a[h][1], b_desc_sw64(base, 1));
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0) {
        release_weights(p, prev_w);
        if (kWindowed && tap == 0) release_window(p, prev_in);
      }
      prev_w = ws;
      ++wpos.n;
      if (kWindowed && tap == 8) {
        prev_in = ipos.slot<2>();
        ++ipos.n;
      }
    }
  }
  wgmma_wait<0>();
  release_weights(p, prev_w);
  if (kWindowed) release_window(p, prev_in);
}

// The same stages as conv3x3_wgmma for a warpgroup with no pixels in this
// step: no MMA, but every stage waited for and released with the other
// warpgroup, so that the rings stay in step across the CTA and the
// cluster.
template <int KC, int WS, bool kWindowed>
__device__ __forceinline__ void conv3x3_skip(Pipes<WS>& p, RingPos& wpos, RingPos& ipos) {
#pragma unroll 1
  for (int s = 0; s < 9 * KC; ++s) {
    const int tap = s % 9;
    if (kWindowed && tap == 0) mbar_wait(&p.in_full[ipos.slot<2>()], ipos.parity<2>());
    const uint32_t ws = wpos.slot<WS>();
    mbar_wait(&p.w_full[ws], wpos.parity<WS>());
    release_weights(p, ws);
    ++wpos.n;
    if (kWindowed && tap == 8) {
      release_window(p, ipos.slot<2>());
      ++ipos.n;
    }
  }
}

// Lane's ldmatrix row and 8-channel half within a k16 slice: matrices
// (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the warp's 16-pixel A fragment.
__device__ __forceinline__ int lane_row() {
  const int l = threadIdx.x & 31;
  return ((threadIdx.x >> 5) & 3) * 16 + (l & 7) + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_khalf() { return (threadIdx.x & 31) >> 4; }

// A address in a streamed window chunk: the warpgroup's pixel p of row
// wg reads window pixel (wg + dy, p + dx).
struct WindowA {
  uint32_t wins;  // smem address of window slot 0
  int wg, p, kh;
  __device__ __forceinline__ uint32_t operator()(int slot, int, int dy, int dx, int k16) const {
    return sw64_addr(wins + slot * kWinBytes, (wg + dy) * kWinW + p + dx, 2 * k16 + kh);
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 4 x 4 transpose across the 4 lanes of a quad (lane & 3 = q): word w of
// lane q <-> word q of lane w.  The wgmma D fragment gives lane q channels
// 8 g + 2 q, + 1 of a pixel for each 8-channel group g; transposed, lane q
// holds all 8 channels of group q of 4, one 16-byte vector.
__device__ __forceinline__ void quad_transpose(uint32_t (&e)[4]) {
  const int q = threadIdx.x & 3;
  const bool hi = q & 2, odd = q & 1;
  uint32_t t0 = hi ? e[0] : e[2], t1 = hi ? e[1] : e[3];
  t0 = __shfl_xor_sync(0xffffffffu, t0, 2);
  t1 = __shfl_xor_sync(0xffffffffu, t1, 2);
  e[0] = hi ? t0 : e[0];
  e[1] = hi ? t1 : e[1];
  e[2] = hi ? e[2] : t0;
  e[3] = hi ? e[3] : t1;
  t0 = odd ? e[0] : e[1];
  t1 = odd ? e[2] : e[3];
  t0 = __shfl_xor_sync(0xffffffffu, t0, 1);
  t1 = __shfl_xor_sync(0xffffffffu, t1, 1);
  e[0] = odd ? t0 : e[0];
  e[2] = odd ? t1 : e[2];
  e[1] = odd ? e[1] : t0;
  e[3] = odd ? e[3] : t1;
}

// The residual epilogue of pixel row v (0, 1) of this lane's D fragment:
// out = x + res_scale * (acc + bias), added in f32 and rounded to bf16
// once, for the C channels of flat pixel `pix`, if `valid` (the same for
// the 4 lanes of a quad; every lane of the warp calls it, with no branch
// around the call).  The residual and the
// output move as 16-byte vectors, 8 channels a lane (two full 32-byte
// sectors per pixel and quad), transposed across the quad to and from
// the fragment's 2 channels per lane and group.
template <int C>
__device__ __forceinline__ void residual_epilogue(const float (&acc)[C / 2], int v,
                                                  const float* __restrict__ bias,
                                                  const bf16* __restrict__ x,
                                                  bf16* __restrict__ out, int64_t pix,
                                                  bool valid, float res_scale) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < C / 32; ++t) {
    // An invalid pixel loads pixel 0 (no branch) and stores nothing.
    const int64_t at = (valid ? pix : 0) * C + 8 * (4 * t + q);
    const uint4 u = *reinterpret_cast<const uint4*>(x + at);
    uint32_t r[4] = {u.x, u.y, u.z, u.w};
    quad_transpose(r);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int j = 4 * t + g;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * q));
      const float lo = __uint_as_float(r[g] << 16), hi = __uint_as_float(r[g] & 0xffff0000u);
      r[g] = pack_bf16x2(lo + res_scale * (acc[4 * j + 2 * v] + bb.x),
                         hi + res_scale * (acc[4 * j + 2 * v + 1] + bb.y));
    }
    quad_transpose(r);
    if (valid) *reinterpret_cast<uint4*>(out + at) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// ------------------------------------------------------------- host ---

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tiled tensor map: dims and box innermost first, byte strides of
// dims 1.. (multiples of 16); zero fill out of bounds.
inline bool make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The activation window map of a [B, H, W, C] NHWC tensor: boxes of
// 32 channels x 66 pixels x 4 rows, 64-byte swizzle.
inline bool make_window_map(CUtensorMap* map, const void* x, int B, int H, int W, int C) {
  const uint64_t dims[4] = {uint64_t(C), uint64_t(W), uint64_t(H), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(C) * 2, uint64_t(W) * C * 2, uint64_t(H) * W * C * 2};
  const uint32_t box[4] = {kKChunk, kWinW, kWinRows, 1};
  return make_map(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The map of packed weights [9][ncols][cin]: boxes of 32 input channels x
// `rows` output columns of one tap, 64-byte swizzle.
inline bool make_weight_map(CUtensorMap* map, const void* w, int cin, int ncols, int rows) {
  const uint64_t dims[3] = {uint64_t(cin), uint64_t(ncols), 9};
  const uint64_t strides[2] = {uint64_t(cin) * 2, uint64_t(ncols) * cin * 2};
  const uint32_t box[3] = {kKChunk, uint32_t(rows), 1};
  return make_map(map, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// Launch `kernel` in clusters of kCluster CTAs along x, with `smem` bytes
// of dynamic shared memory.
template <class Kernel, class... Args>
inline cudaError_t launch_clusters(Kernel kernel, int ctas, int smem,
                                   cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of kCluster CTAs of `kernel` the device runs at once
// (negative: the CUDA error).
template <class Kernel>
inline int max_active_clusters(Kernel kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

}  // namespace pesr
