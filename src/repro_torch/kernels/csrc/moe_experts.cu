// Held experts of one MoE layer for Hopper (sm_90a): DeepSeek-V3's
// SwiGLU experts, each on exactly the (token, slot)s routed to it,
//   h_s = silu(x_t W_gate[e]) * (x_t W_up[e])        (f32, h stored once)
//   y[t] += w_s (h_s W_down[e])                      (f32)
// for every slot s = (token t, expert e) with e among the held experts,
// with the slots' layout built and read on the device: nothing is read
// to the host, and the grids are sized from shapes the host knows.
//
// Replaces no TPU kernel: the reference's MoE is einsums over capacity
// buffers (src/repro/models/moe.py).  The port's plain version
// (kernels/ref.py moe_experts_ref, which the CPU takes) is a loop over the
// held experts that reads their slot counts to the host and launches
// ~11 PyTorch operations an expert.
//
// What bounds it: the weights.  At DeepSeek-V3's widths (d 7168, ff 2048)
// a held expert is 3 x 7168 x 2048 bf16 = 88 MB, so a card's 8 held
// experts are 704.6 MB a layer: 0.210 ms at 3.35 TB/s.  At decode an
// expert sees ~8 of the 256 slots' rows (~16 flops a weight byte, under
// the card's ~295), so the time is the weights' bytes; at a 4096-token
// prefill ~128 rows an expert, and the products approach the tensor
// cores' rate.  The design streams each weight byte from device memory
// once an expert's token tile and keeps enough bytes in flight:
//
// * Layout (moe_layout_kernel, one block): the slots' local experts
//   (non-held ones dropped), their counts, the exclusive scan
//   (offsets[held + 1]) and a stable counting sort: for each sorted slot
//   its token and its routing weight.  Then moe_gather_kernel copies the
//   sorted slots' token rows into a contiguous buffer (so that TMA reads
//   them as tiles) and zeroes y.  Rows past offsets[held] are neither
//   written nor needed.
// * Products (moe_grouped_kernel, twice: gate and up with SwiGLU, then
//   down): swap-AB, so that a handful of tokens does not waste wgmma's
//   64-row M: a 64-row tile of W^T (the weight's output columns, read
//   M-major where it lies) is the M operand and the expert's token rows
//   (K-major) are N (MOE_TILE_* rows, chosen by the host from the
//   tokens a call routes).  A tile is (expert, token tile, 128 weight
//   columns, K split); one persistent block an SM walks the tiles,
//   enumerated from offsets[] on the device, so a block never waits on
//   an empty expert and the ring runs on across tiles.  One producer
//   warp keeps a ring of TMA loads in flight (per stage: 64 K-rows of
//   two 64-column weight boxes, of gate and of up in the first kernel,
//   and the token rows; 128-byte swizzle); two consumer warpgroups each
//   own 64 weight columns and run wgmma (m64nNk16, f32 accumulators,
//   A transposed).  Gate and up share each token tile in one block.
//   Epilogues: SwiGLU in f32 and h stored once in bf16,
//   in sorted-slot order; then y[t] += w_s * acc with f32 atomics
//   (red.global.add), so the sum over a token's held slots and over the
//   down product's K splits runs in no fixed order, as index_add_ on the
//   card does.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// what the library compiles (kernels/moe_experts.py reads these)
#define MOE_BM 128          // weight columns a tile: two warpgroups of 64
#define MOE_BK 64           // K a stage: 128 bytes of 16 bits
#define MOE_TILE_SMALL 64   // token rows a tile (wgmma N), few tokens
#define MOE_TILE_LARGE 128  // token rows a tile, many tokens
#define MOE_MAX_HELD 64     // held experts a layer
#define MOE_MAX_STAGES 8

namespace {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = MOE_BM / 64 * 128;  // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and the producer warp
constexpr int kBox = 64 * MOE_BK * 2;          // a 64 x 64 weight box: 8 KB
constexpr int kRingBudget = 200 * 1024;
constexpr int kLayoutThreads = 1024;
constexpr int kGatherThreads = 256;

// a kernel's ring: per stage the weight boxes (gate's two, then up's two
// when gated) and the token rows, every part a multiple of 1024 bytes
template <bool GATED, int WN>
struct Ring {
  static constexpr int kW = (GATED ? 4 : 2) * kBox;
  static constexpr int kStage = kW + WN * MOE_BK * 2;
  static constexpr int kStages =
      kRingBudget / kStage < MOE_MAX_STAGES ? kRingBudget / kStage
                                            : MOE_MAX_STAGES;
  static constexpr int kBars = kStages * kStage;
  // the ring, full and empty barriers, offsets and unit prefix (held +
  // 1 ints each), and slack to align the ring to 1024 bytes
  static constexpr int kSmem =
      kBars + 2 * kStages * 8 + 2 * (MOE_MAX_HELD + 1) * 4 + 1024;
  static_assert(kStage % 1024 == 0, "stage parts stay 1024-aligned");
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kSmem <= 232448, "one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Returns once the phase of parity `parity` has completed (a fresh
// barrier counts the phase before its first as completed: parity 1).  A
// wait still open after 10 s traps, so that a fault in the ring's
// bookkeeping ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = globaltimer_ns();
    else if (globaltimer_ns() - t0 > 10000000000ull) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define MOE_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N): A from shared memory
// M-major (transposed: the weight's output columns lie contiguous), B
// K-major (the token rows); scale_d 0 overwrites D.
#define MOE_WGMMA_N64                                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "%32, %33, p, 1, 1, 1, 0;\n}\n"                                        \
      : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24)                         \
      : "l"(da), "l"(db), "r"(scale_d))

#define MOE_WGMMA_N128                                                       \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "%64, %65, p, 1, 1, 1, 0;\n}\n"                                        \
      : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24),                        \
        MOE_D8(32), MOE_D8(40), MOE_D8(48), MOE_D8(56)                       \
      : "l"(da), "l"(db), "r"(scale_d))

template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    MOE_WGMMA_N64;
  } else {
    static_assert(N == 128, "token tiles of 64 or 128 rows");
    MOE_WGMMA_N128;
  }
}
#undef MOE_WGMMA_N64
#undef MOE_WGMMA_N128
#undef MOE_D8

// ------------------------------------------------------------- layout
// One block.  local = experts - lo, held where it is not held.  Pass 1
// counts each held expert's slots; thread 0 scans them into offsets.
// Pass 2, 1024 slots at a time in slot order: a slot's place is its
// expert's offset, plus the expert's slots in earlier chunks and in
// earlier warps of this chunk, plus its rank among its warp's lanes of
// the same expert, so the order within an expert is the slots' (a stable
// sort, tokens ascending).
__global__ void __launch_bounds__(kLayoutThreads)
moe_layout_kernel(const long long* __restrict__ experts,
                  const float* __restrict__ weights, int NK, int K, int lo,
                  int held, int* __restrict__ offsets,
                  int* __restrict__ stok, float* __restrict__ sw) {
  constexpr int kWarps = kLayoutThreads / 32;
  __shared__ int cnt[MOE_MAX_HELD];
  __shared__ int base[MOE_MAX_HELD];
  __shared__ int wc[kWarps * MOE_MAX_HELD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < held) cnt[tid] = 0;
  __syncthreads();
  for (int i = tid; i < NK; i += kLayoutThreads) {
    const long long e = experts[i] - lo;
    if (e >= 0 && e < held) atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < held; ++e) {
      base[e] = run;
      offsets[e] = run;
      run += cnt[e];
    }
    offsets[held] = run;
  }
  for (int c0 = 0; c0 < NK; c0 += kLayoutThreads) {
    for (int j = tid; j < kWarps * held; j += kLayoutThreads) wc[j] = 0;
    __syncthreads();
    const int i = c0 + tid;
    int e = -1;
    if (i < NK) {
      const long long x = experts[i] - lo;
      if (x >= 0 && x < held) e = (int)x;
    }
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & ((1u << lane) - 1));
    if (e >= 0 && rank == 0) wc[warp * held + e] = __popc(same);
    __syncthreads();
    if (tid < held) {
      int run = base[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int n = wc[w * held + tid];
        wc[w * held + tid] = run;
        run += n;
      }
      base[tid] = run;
    }
    __syncthreads();
    if (e >= 0) {
      const int pos = wc[warp * held + e] + rank;
      stok[pos] = i / K;
      sw[pos] = weights[i];
    }
    __syncthreads();
  }
}

// The sorted slots' token rows into xs (rows of d elements, 16 bytes a
// thread), then y (ny floats) zeroed; grid-strided, so any grid covers
// both.
__global__ void __launch_bounds__(kGatherThreads)
moe_gather_kernel(const bf16* __restrict__ x, const int* __restrict__ offsets,
                  int held, const int* __restrict__ stok, bf16* __restrict__ xs,
                  int d, float* __restrict__ y, long long ny) {
  const int total = offsets[held];
  const int chunks = d / 8;
  for (int r = blockIdx.x; r < total; r += gridDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (long long)stok[r] * d);
    uint4* dst = reinterpret_cast<uint4*>(xs + (long long)r * d);
    for (int c = threadIdx.x; c < chunks; c += kGatherThreads) dst[c] = src[c];
  }
  float4* y4 = reinterpret_cast<float4*>(y);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
       i < ny / 4; i += (long long)gridDim.x * kGatherThreads)
    y4[i] = z;
}

// ------------------------------------------------------------ products
// A tile of the walk: expert e, its sorted rows row0 .. row0 + rows - 1
// (rows <= WN), weight columns m0 .. m0 + MOE_BM - 1, K tiles kt0 .. kt1.
struct Tile {
  int e, row0, rows, m0, kt0, kt1;
};
// unit[e] .. unit[e + 1] - 1 are expert e's token tiles; tile t is
// unit t / per's column block (t % per) / splits and K split
// (t % per) % splits, so that the blocks working at once share a unit's
// token rows.
template <int WN>
__device__ __forceinline__ Tile tile_of(int t, const int* off,
                                        const int* unit, int per, int splits,
                                        int kps, int k_tiles) {
  const int u = t / per, r = t % per;
  int e = 0;
  while (unit[e + 1] <= u) ++e;
  Tile w;
  w.e = e;
  w.row0 = off[e] + (u - unit[e]) * WN;
  w.rows = min(WN, off[e + 1] - w.row0);
  w.m0 = (r / splits) * MOE_BM;
  w.kt0 = (r % splits) * kps;
  w.kt1 = min(k_tiles, w.kt0 + kps);
  return w;
}

// GATED: h[row, m] = silu(g) * u of gate's and up's products, rows in
// sorted-slot order, in bf16.  Otherwise y[stok[row], m] += sw[row] * acc,
// f32 atomics.  W0 (W1) are (held, K, M) weights, M contiguous (TMA
// maps); the token rows are xs (rows_max, K) (map).
template <bool GATED, int WN>
__global__ void __launch_bounds__(kThreads, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap map_w0,
                   const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_x,
                   const int* __restrict__ offsets, int held, int M,
                   int k_tiles, int splits, bf16* __restrict__ h,
                   long long ldh, float* __restrict__ y, long long ldy,
                   const int* __restrict__ stok,
                   const float* __restrict__ sw) {
  using R = Ring<GATED, WN>;
  extern __shared__ __align__(1024) unsigned char moe_smem[];
  const uint32_t raw = smem_u32(moe_smem);
  unsigned char* smem = moe_smem + ((1024 - (raw & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBars);
  uint64_t* empty = full + R::kStages;
  int* off_s = reinterpret_cast<int*>(empty + R::kStages);
  int* unit_s = off_s + MOE_MAX_HELD + 1;
  const int tid = threadIdx.x;
  if (tid <= held) off_s[tid] = offsets[tid];
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    unit_s[0] = 0;
    for (int e = 0; e < held; ++e)
      unit_s[e + 1] = unit_s[e] + (off_s[e + 1] - off_s[e] + WN - 1) / WN;
  }
  __syncthreads();
  const int per = (M + MOE_BM - 1) / MOE_BM * splits;
  const int kps = (k_tiles + splits - 1) / splits;
  const int total = unit_s[held] * per;
  if ((int)blockIdx.x >= total) return;  // no tile for this block
  const int warp = tid / 32, lane = tid % 32;

  if (warp == kConsumers / 32) {
    // ---- producer: one lane keeps the ring full, tile after tile
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile w =
            tile_of<WN>(t, off_s, unit_s, per, splits, kps, k_tiles);
        for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
          const int s = it % R::kStages;
          mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);
          unsigned char* st = smem + s * R::kStage;
          const int k = kt * MOE_BK;
          mbar_expect_tx(&full[s], R::kStage);
          tma_load_3d(st, &map_w0, &full[s], w.m0, k, w.e);
          tma_load_3d(st + kBox, &map_w0, &full[s], w.m0 + 64, k, w.e);
          if constexpr (GATED) {
            tma_load_3d(st + 2 * kBox, &map_w1, &full[s], w.m0, k, w.e);
            tma_load_3d(st + 3 * kBox, &map_w1, &full[s], w.m0 + 64, k, w.e);
          }
          tma_load_2d(st + R::kW, &map_x, &full[s], k, w.row0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns weight columns m0 + 64 wg ..
  // read through a shuffle, so that ptxas sees it uniform across the
  // warp and does not serialise the warpgroups' wgmma
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int g = lane / 4, q = lane % 4;
  // this thread's accumulator rows (weight columns): mr + 8 ((i / 2) % 2)
  const int mr = wg * 64 + (warp % 4) * 16 + g;
  const uint32_t ring = smem_u32(smem);
  float a0[WN / 2], a1[GATED ? WN / 2 : 1];
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile w = tile_of<WN>(t, off_s, unit_s, per, splits, kps, k_tiles);
    for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
      const int s = it % R::kStages;
      mbar_wait(&full[s], (it / R::kStages) & 1);
      const uint32_t st = ring + s * R::kStage;
      // a k16 slice: 16 K-rows of the weight box (2048 bytes; SBO 8
      // rows), 32 bytes into the token rows' 128-byte lines
      const uint32_t wa = st + wg * kBox;
      const uint32_t xb = st + R::kW;
      fence_acc(a0);
      if constexpr (GATED) fence_acc(a1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MOE_BK / 16; ++kk) {
        const int sc = (kt > w.kt0) || (kk > 0);
        const uint64_t db = gmma_desc(xb + kk * 32, 16, 1024);
        wgmma_tn<WN>(a0, gmma_desc(wa + kk * 2048, kBox, 1024), db, sc);
        if constexpr (GATED)
          wgmma_tn<WN>(a1, gmma_desc(wa + 2 * kBox + kk * 2048, kBox,
                                        1024), db, sc);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(a0);
      if constexpr (GATED) fence_acc(a1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // ---- epilogue: register i holds weight column w.m0 + mr + 8 ((i /
    // 2) % 2) of sorted row w.row0 + 8 (i / 4) + 2 q + i % 2
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) {
      const int m = w.m0 + mr + 8 * ((i / 2) % 2);
      const int n = 8 * (i / 4) + 2 * q + (i % 2);
      if (n >= w.rows || m >= M) continue;
      const int row = w.row0 + n;
      if constexpr (GATED) {
        const float gv = a0[i];
        h[(long long)row * ldh + m] =
            __float2bfloat16_rn(gv / (1.0f + __expf(-gv)) * a1[i]);
      } else {
        atomicAdd(y + (long long)stok[row] * ldy + m, sw[row] * a0[i]);
      }
    }
  }
}

// ------------------------------------------------------------- dispatch
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A map of `rank` dims of bf16 (dims innermost first, byte strides of
// dims 1..), boxes `box`, 128-byte swizzle; reads past an edge give
// zeros.
CUresult make_map(CUtensorMap* map, const void* p, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool GATED, int WN>
int launch_grouped(const CUtensorMap& w0, const CUtensorMap& w1,
                   const CUtensorMap& xm, const int* offsets, int held,
                   int M, int k_tiles, int splits, void* out,
                   long long ld_out, const int* stok, const float* sw,
                   int grid, cudaStream_t stream) {
  using R = Ring<GATED, WN>;
  auto kern = moe_grouped_kernel<GATED, WN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, R::kSmem, stream>>>(
      w0, w1, xm, offsets, held, M, k_tiles, splits,
      GATED ? static_cast<bf16*>(out) : nullptr, ld_out,
      GATED ? nullptr : static_cast<float*>(out), ld_out, stok, sw);
  return (int)cudaGetLastError();
}

int grouped(int gated, int wn, const CUtensorMap& w0, const CUtensorMap& w1,
            const CUtensorMap& xm, const int* offsets, int held, int M,
            int k_tiles, int splits, void* out, long long ld_out,
            const int* stok, const float* sw, int grid, cudaStream_t s) {
  if (gated)
    return wn == MOE_TILE_SMALL
        ? launch_grouped<true, MOE_TILE_SMALL>(w0, w1, xm, offsets, held, M,
                                               k_tiles, splits, out, ld_out,
                                               stok, sw, grid, s)
        : launch_grouped<true, MOE_TILE_LARGE>(w0, w1, xm, offsets, held, M,
                                               k_tiles, splits, out, ld_out,
                                               stok, sw, grid, s);
  return wn == MOE_TILE_SMALL
      ? launch_grouped<false, MOE_TILE_SMALL>(w0, w1, xm, offsets, held, M,
                                              k_tiles, splits, out, ld_out,
                                              stok, sw, grid, s)
      : launch_grouped<false, MOE_TILE_LARGE>(w0, w1, xm, offsets, held, M,
                                              k_tiles, splits, out, ld_out,
                                              stok, sw, grid, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
}  // namespace

// dtype: 3, bfloat16 (x, xs), the one it takes.  experts (N, K) int64 and
// weights (N, K) float32, contiguous; x (N, d) contiguous.  Writes
// offsets (held + 1 ints: an exclusive scan of the held experts'
// counts), stok and sw (N * min(K, held) each: each sorted slot's token
// and weight), xs (N * min(K, held), d: the sorted slots' rows) and
// zeroes y (N, d) float32.  `grid` blocks gather.  Returns the launches'
// cudaGetLastError() (0 on success), -1 for a dtype or size it does not
// take, -2 for operands it cannot read.
extern "C" int moe_layout(int dtype, const void* experts, const void* weights,
                          const void* x, int N, int K, int d, int lo,
                          int held, void* offsets, void* stok, void* sw,
                          void* xs, void* y, int grid, void* stream) {
  if (dtype != 3 || N <= 0 || K <= 0 || held <= 0 ||
      held > MOE_MAX_HELD || grid <= 0 || (long long)N * K > 0x7fffffff)
    return -1;
  if (d <= 0 || d % 8 || !aligned16(x) || !aligned16(xs) || !aligned16(y))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  moe_layout_kernel<<<1, kLayoutThreads, 0, s>>>(
      static_cast<const long long*>(experts),
      static_cast<const float*>(weights), N * K, K, lo, held,
      static_cast<int*>(offsets), static_cast<int*>(stok),
      static_cast<float*>(sw));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long ny = (long long)N * d;
  moe_gather_kernel<<<grid, kGatherThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(offsets), held,
      static_cast<const int*>(stok), static_cast<bf16*>(xs), d,
      static_cast<float*>(y), ny);
  return (int)cudaGetLastError();
}

// One grouped product over the held experts' sorted rows.  dtype 3,
// bfloat16, the one it takes; gated 1: w0, w1 are gate and up (held, K,
// M) and out is h (rows_max, M) in bf16; gated 0: w0 is down (held, K, M) and
// out is y (N, M) float32 (atomically added to; stok, sw the sorted
// slots' tokens and weights).  The weights' M axis contiguous, their K
// and expert axes ws_k and ws_e elements apart; xs (rows_max, K)
// contiguous; offsets (held + 1) on the device; wn the token rows a tile
// (MOE_TILE_*); K cut into `splits` runs of whole MOE_BK tiles (1 when
// gated); `grid` persistent blocks.  Returns cudaGetLastError() (0 on
// success), -1 for a dtype, tile, split or size it does not take, -2 for
// operands TMA cannot read, 1000 + a CUresult where a map could not be
// made.
extern "C" int moe_grouped(int dtype, int gated, int wn, const void* w0,
                           const void* w1, long long ws_k, long long ws_e,
                           const void* xs, int rows_max, const void* offsets,
                           int held, int M, int K, int splits, void* out,
                           long long ld_out, const void* stok,
                           const void* sw, int grid, void* stream) {
  if (dtype != 3 || (wn != MOE_TILE_SMALL && wn != MOE_TILE_LARGE) ||
      held <= 0 || held > MOE_MAX_HELD || M <= 0 || K <= 0 ||
      rows_max <= 0 || grid <= 0 || splits < 1 || (gated && splits != 1))
    return -1;
  const int k_tiles = (K + MOE_BK - 1) / MOE_BK;
  const int kps = (k_tiles + splits - 1) / splits;
  if ((splits - 1) * kps >= k_tiles) return -1;  // an empty split
  if (M % 8 || K % 8 || ws_k % 8 || ws_e % 8 || !aligned16(w0) ||
      !aligned16(xs) || (gated && !aligned16(w1)) ||
      (!gated && (stok == nullptr || sw == nullptr)))
    return -2;
  const cuuint64_t wdims[3] = {(cuuint64_t)M, (cuuint64_t)K,
                               (cuuint64_t)held};
  const cuuint64_t wstr[2] = {(cuuint64_t)ws_k * 2, (cuuint64_t)ws_e * 2};
  const cuuint32_t wbox[3] = {64, MOE_BK, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)rows_max};
  const cuuint64_t xstr[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {MOE_BK, (cuuint32_t)wn};
  CUtensorMap m0, m1, mx;
  CUresult r = make_map(&m0, w0, 3, wdims, wstr, wbox);
  if (r == CUDA_SUCCESS)
    r = make_map(&m1, gated ? w1 : w0, 3, wdims, wstr, wbox);
  if (r == CUDA_SUCCESS) r = make_map(&mx, xs, 2, xdims, xstr, xbox);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int* off = static_cast<const int*>(offsets);
  const int* tok = static_cast<const int*>(stok);
  const float* wt = static_cast<const float*>(sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grouped(gated, wn, m0, m1, mx, off, held, M, k_tiles, splits, out,
                 ld_out, tok, wt, grid, s);
}
