// MLA absorbed decode for Hopper (sm_90a): one decode step of multi-head
// latent attention against the compressed cache, with W_uk already
// absorbed into q:
//   o_c[b, h] = softmax_j(scale * (q_c[b, h] . ckv[b, j]
//                                  + q_rope[b, h] . k_rope[b, j])) ckv[b, j]
// over the live positions j < idx[b] + 1 of each slot b, in f32.
//
// Replaces no TPU kernel: the reference's absorbed decode is plain jnp
// (src/repro/models/attention.py, mla_attention's decode branch).  The
// port's plain version (kernels/ref.py mla_decode_ref, which the CPU
// takes) widens the whole padded latent cache to f32, twice a layer and
// step, and multiplies over every padded position.
//
// What bounds it: each live position is a 576-wide bf16 row (512 latent,
// 64 RoPE key) that all H heads read, so at DeepSeek-V3's 128 heads a row
// costs 1152 bytes against 128 * 2 * (576 + 512) flops: ~240 flops a byte,
// under the card's ~295, so read once it is bound by bytes.  q_c and P go
// into the products as two 16-bit terms each (hi = rn(x), lo = rn(x - hi)),
// so that 16-bit operands keep ~16 bits of them and the result matches the
// f32 plain version up to the order of summation; that doubles the tensor
// work and puts the operations' bound a little above the bytes' (PERF.md).
// The design reads each cache row from device memory once a 64-head group
// and keeps the tensor cores busy while the next rows arrive:
//
// * wgmma path (bf16/f16).  One block: a (slot, 64-head group, KV split).
//   Live lengths only: the block reads idx[b] from device memory, walks
//   only its split's live positions, BK at a time, masks the ragged last
//   tile, and exits at once where the split starts past the slot's live
//   length.  A two-stage ring of cache tiles is filled by TMA, read in
//   place through the cache's strides (128-byte swizzle, 9 boxes of 64
//   columns: 8 of c_kv, 1 of the RoPE key).  q_c
//   and q_rope (f32) are split into hi and lo once a block into shared
//   memory in the same swizzle.  Warpgroup 0 computes S = Q [c_kv |
//   k_rope]^T (wgmma m64n32k16, both operands in shared memory, hi and lo
//   into one f32 accumulator), the scaled, masked, f32 online softmax
//   (log2 units, exp2), and writes P as hi and lo terms to shared
//   memory; warpgroups 1 and 2 each add P c_kv into their half of o's 512
//   columns (wgmma m64n256k16, the same c_kv tile read N-major), 128 f32
//   registers a thread.  Tile i + 1's scores run under tile i's P c_kv,
//   and tile i + 2 is loaded under them.  What limits it on an
//   H100 is shared memory's bandwidth: q in two terms takes 147 KB, so
//   a tile is 32 positions and each of the 72 score products a tile
//   (m64n32k16) reads 3 KB of operands for 32K multiply-adds; at the
//   benchmark cell's shape a tile takes ~4.3k clocks against ~2.6k for
//   its bytes (PERF.md).
//   A block that holds its slot's only live split writes o normalised;
//   otherwise it writes its running max, sum and unnormalised o (f32) to a
//   workspace, and the combine kernel merges a slot's splits.
// * simt path (f32 caches alone, any widths up to MLA_SIMT_MAX_R latent
//   and MLA_SIMT_MAX_DQ in all): one block a (slot, head), each warp an
//   online softmax over every eighth live position with IEEE FP32 FMAs,
//   the warps merged at the end.  Only tests and reduced models decode
//   from an f32 cache; it is plain, not fast.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// what the library compiles (kernels/mla_decode.py reads these)
#define MLA_R 512        // latent width of the tensor-core path
#define MLA_ROPE 64      // RoPE key width of the tensor-core path
#define MLA_HEADS 64     // heads a block (one wgmma M)
#define MLA_BK 32        // cache positions a tile
#define MLA_STAGES 2     // tiles in the ring
#define MLA_SIMT_MAX_R 512
#define MLA_SIMT_MAX_DQ 1024

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f * kLog2e;  // a masked score, log2 units

constexpr int kBoxCols = 64;                       // 128 bytes of 16 bits
constexpr int kBoxes = (MLA_R + MLA_ROPE) / kBoxCols;  // 9
constexpr int kKSteps = (MLA_R + MLA_ROPE) / 16;       // 36 k16 slices
constexpr int kQBox = MLA_HEADS * 128;             // a Q box: 64 rows x 128 B
constexpr int kQBytes = kBoxes * kQBox;            // one term of Q: 73728
constexpr int kKVBox = MLA_BK * 128;               // a tile box: 32 rows x 128 B
constexpr int kStageBytes = kBoxes * kKVBox;       // one tile: 36864
constexpr int kPBytes = MLA_HEADS * MLA_BK * 2;    // one term of P: 4096
constexpr int kConsumers = 3 * 128;  // scores; o's two halves
constexpr int kThreads = kConsumers;
// shared memory: Q hi, Q lo, the ring, P hi, P lo, then the small arrays
// (corr, final max and sum, 64 floats each) and the ring's barriers,
// plus slack to align the tiles to the 1024 bytes the swizzle repeats over
constexpr int kOffQlo = kQBytes;
constexpr int kOffKV = 2 * kQBytes;
constexpr int kOffP = kOffKV + MLA_STAGES * kStageBytes;
constexpr int kOffCorr = kOffP + 2 * kPBytes;
constexpr int kOffMax = kOffCorr + MLA_HEADS * 4;
constexpr int kOffSum = kOffMax + MLA_HEADS * 4;
constexpr int kOffBar = kOffSum + MLA_HEADS * 4;
constexpr int kSmem = kOffBar + MLA_STAGES * 8 + 1024;
static_assert(kSmem <= 232448, "one block's shared memory");
// the workspace of one (slot, head group, split): o (64 x 512), max, sum
constexpr int kPartFloats = MLA_HEADS * MLA_R + 2 * MLA_HEADS;

// named barriers of the three consumer warpgroups (0 is __syncthreads)
constexpr int kBarQ = 1;       // Q in shared memory
constexpr int kBarPReady = 2;  // warpgroup 0 wrote tile i's P and corr
constexpr int kBarPFree = 3;   // warpgroups 1 and 2 are done with them
                               // and with their stage of the ring
constexpr int kBarFinal = 4;   // final max and sum written

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}
// shared-memory writes of the threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}
// One TMA box of a 3-D tensor map into shared memory; completes on bar.
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

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), layout type in bits 62-63 (0: no swizzle,
// 1: 128-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions that own those registers.
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

#define MLA_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S(64 x 32, f32) (+)= A(64 x 16, K-major) B(32 x 16, K-major)^T; both
// from shared memory; scale_d 0 overwrites S.
#define MLA_WGMMA_QK(TY)                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                        \
      : MLA_D8(0), MLA_D8(8)                                                 \
      : "l"(da), "l"(db), "r"(scale_d))

// O(64 x 256, f32) += A(64 x 16, K-major) B(16 x 256, N-major); both from
// shared memory.
#define MLA_WGMMA_PV(TY)                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                             \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                             \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                             \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                             \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                             \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                         \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                     \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                     \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "                    \
      "%128, %129, p, 1, 1, 0, 1;\n}\n"                                      \
      : MLA_D8(0), MLA_D8(8), MLA_D8(16), MLA_D8(24),                        \
        MLA_D8(32), MLA_D8(40), MLA_D8(48), MLA_D8(56),                      \
        MLA_D8(64), MLA_D8(72), MLA_D8(80), MLA_D8(88),                      \
        MLA_D8(96), MLA_D8(104), MLA_D8(112), MLA_D8(120)                    \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) MLA_WGMMA_QK("f16");
  else MLA_WGMMA_QK("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) MLA_WGMMA_PV("f16");
  else MLA_WGMMA_PV("bf16");
}
#undef MLA_WGMMA_QK
#undef MLA_WGMMA_PV
#undef MLA_D8

// (x, y) as two 16-bit terms each: hi = rn(x, y), lo = rn((x, y) - hi),
// x in the low half of each word (the lower column)
template <typename T> struct Split;
template <> struct Split<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};
template <> struct Split<__half> {
  static __device__ __forceinline__ void run(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};

// 2^x; results below f32's normal range flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The slot's live length idx[b] + 1, within [1, Skv].
__device__ __forceinline__ int live_length(const void* idx, int idx64, int b,
                                           int Skv) {
  const long long i = idx64 ? static_cast<const long long*>(idx)[b]
                            : static_cast<const int*>(idx)[b];
  return (int)max(1LL, min((long long)Skv, i + 1));
}

// element strides: q_c and q_rope (batch, head), o (batch, head); c_kv
// and k_rope (batch, seq) for the simt path (TMA maps hold the wgmma
// path's)
struct Strides {
  long long qcb, qch, qrb, qrh, ob, oh, cb, cs, kb, ks;
};

// The launch position's (slot, head group, split): splits in descending
// order, so the blocks that hold a long slot's far positions start first.
struct Work {
  int b, hg, split;
};
__device__ __forceinline__ Work work_of(int B, int HG, int n_splits) {
  const int x = blockIdx.x;
  const int hg = x % HG;
  const int b = (x / HG) % B;
  const int split = n_splits - 1 - x / (HG * B);
  return Work{b, hg, split};
}

// o[:, 256 half + ...] += P c_kv of the tile at `tile` (a stage of the
// ring): k16 chunk kc of P (no swizzle: core matrices of 8 rows x 16
// bytes, LBO 128 between the two halves of a k16 slice, SBO 256 between
// 8-row groups) against 16 rows of the tile's c_kv boxes 4 half .. 4 half
// + 3, read N-major (LBO a box, SBO 8 rows); one commit group
template <typename T>
__device__ __forceinline__ void issue_pv(float (&acc)[128], uint32_t tile,
                                         uint32_t phi, uint32_t plo,
                                         int half) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < MLA_BK / 16; ++kc) {
    const uint64_t db =
        gmma_desc(tile + 4 * half * kKVBox + kc * 2048, kKVBox, 1024, 1);
    wgmma_pv<T>(acc, gmma_desc(phi + kc * 2048, 128, 256, 0), db);
    wgmma_pv<T>(acc, gmma_desc(plo + kc * 2048, 128, 256, 0), db);
  }
  wgmma_commit();
}

// S = Q [c_kv | k_rope]^T of the tile at `tile` (a stage of the ring)
// into sc, one commit group: k16 slice kk is 32 bytes into box kk / 4;
// hi and lo into the one accumulator, the first product overwriting it.
// (A descriptor's address field is the byte address over 16, so a slice
// is its base descriptor plus an immediate; the bases pass through an
// opaque move, so that ptxas does not hoist 72 descriptors out of the
// loop over tiles and spill them.)
template <typename T>
__device__ __forceinline__ void issue_qk(float (&sc)[16], uint32_t tile,
                                         uint32_t qhi, uint32_t qlo) {
  uint64_t dh = gmma_desc(qhi, 16, 1024, 1), dl = gmma_desc(qlo, 16, 1024, 1);
  uint64_t dk = gmma_desc(tile, 16, 1024, 1);
  asm volatile("" : "+l"(dh), "+l"(dl), "+l"(dk));
  fence_acc(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const uint32_t qo = ((kk / 4) * kQBox + (kk % 4) * 32) >> 4;
    const uint64_t db = dk + (((kk / 4) * kKVBox + (kk % 4) * 32) >> 4);
    wgmma_qk<T>(sc, dh + qo, db, kk > 0);
    wgmma_qk<T>(sc, dl + qo, db, 1);
  }
  wgmma_commit();
}

// q_c (512) and q_rope (64) of heads h0 .. h0 + 63 of slot b (rows past
// H are zeros), split into hi and lo, each in 9 boxes of 64 rows x 128
// bytes in the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), by the consumer warpgroups' kConsumers threads; then
// made visible to wgmma and waited for by all of them
template <typename T>
__device__ __forceinline__ void load_q(unsigned char* qhi, unsigned char* qlo,
                                       const float* __restrict__ qc,
                                       const float* __restrict__ qr, int b,
                                       int h0, int H, const Strides& st,
                                       int tid) {
#pragma unroll
  for (int c = tid; c < MLA_HEADS * kBoxes * 8; c += kConsumers) {
    const int r = c / (kBoxes * 8), ch = c % (kBoxes * 8);
    const int d0 = ch * 8;
    float x[8];
    if (h0 + r < H) {
      const float* src = d0 < MLA_R
          ? qc + b * st.qcb + (long long)(h0 + r) * st.qch + d0
          : qr + b * st.qrb + (long long)(h0 + r) * st.qrh + (d0 - MLA_R);
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b4 = *reinterpret_cast<const float4*>(src + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b4.x; x[5] = b4.y; x[6] = b4.z; x[7] = b4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    }
    uint4 hi, lo;
    Split<T>::run(x[0], x[1], hi.x, lo.x);
    Split<T>::run(x[2], x[3], hi.y, lo.y);
    Split<T>::run(x[4], x[5], hi.z, lo.z);
    Split<T>::run(x[6], x[7], hi.w, lo.w);
    const int off = (d0 / kBoxCols) * kQBox + r * 128 +
                    ((((d0 % kBoxCols) / 8) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qhi + off) = hi;
    *reinterpret_cast<uint4*>(qlo + off) = lo;
  }
  fence_async_smem();
  bar_sync(kBarQ, kConsumers);
}

// ------------------------------------------------------------ wgmma path
// Warpgroups: 0 computes the scores and the softmax and writes P (its
// thread 0 issues the ring's TMA loads); 1 and 2
// each hold half of o (128 f32 registers a thread) and add P c_kv into
// it.  Three warpgroups, so that ptxas may give each thread 168
// registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap map_ckv,
                 const __grid_constant__ CUtensorMap map_kr,
                 const float* __restrict__ qc, const float* __restrict__ qr,
                 const void* __restrict__ idx, int idx64,
                 float* __restrict__ o, float* __restrict__ ws, int B, int H,
                 int Skv, int split_len, int n_splits, float sl2,
                 Strides st) {
  const int HG = (H + MLA_HEADS - 1) / MLA_HEADS;
  const Work w = work_of(B, HG, n_splits);
  const int L = live_length(idx, idx64, w.b, Skv);
  const int start = w.split * split_len;
  if (start >= L) return;  // the split lies past the slot's live length
  const int end = min(start + split_len, L);
  const int n_tiles = (end - start + MLA_BK - 1) / MLA_BK;
  const bool whole = L <= split_len;  // the slot's only live split
  const int h0 = w.hg * MLA_HEADS;

  extern __shared__ __align__(1024) unsigned char mla_smem[];
  const uint32_t raw = smem_u32(mla_smem);
  unsigned char* smem = mla_smem + ((1024 - (raw & 1023)) & 1023);
  unsigned char* qhi = smem;
  unsigned char* qlo = smem + kOffQlo;
  unsigned char* kv = smem + kOffKV;
  unsigned char* phi = smem + kOffP;
  unsigned char* plo = phi + kPBytes;
  float* corr_s = reinterpret_cast<float*>(smem + kOffCorr);
  float* max_s = reinterpret_cast<float*>(smem + kOffMax);
  float* sum_s = reinterpret_cast<float*>(smem + kOffSum);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);

  const int tid = threadIdx.x;
  // tile i into stage i % 2 (rows past Skv read as zeros; the barrier
  // still counts the whole box's bytes)
  auto load = [&](int i) {
    const int s = i % MLA_STAGES;
    unsigned char* dst = kv + s * kStageBytes;
    const int pos = start + i * MLA_BK;
    mbar_expect_tx(&full[s], kStageBytes);
#pragma unroll
    for (int j = 0; j < MLA_R / kBoxCols; ++j)
      tma_load_3d(dst + j * kKVBox, &map_ckv, &full[s], j * kBoxCols, pos,
                  w.b);
    tma_load_3d(dst + (kBoxes - 1) * kKVBox, &map_kr, &full[s], 0, pos, w.b);
  };
  if (tid == 0) {
    for (int s = 0; s < MLA_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < MLA_STAGES && i < n_tiles; ++i) load(i);
  }
  __syncthreads();
  // read through a shuffle, so that ptxas sees it uniform across each
  // warp and does not serialise the warpgroups' wgmma
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's accumulator rows: rw + 8 rr (rr = 0, 1)
  const int rw = warp * 16 + g;
  const uint32_t kv_u32 = smem_u32(kv);

  if (wg == 0) {
    // ---- scores, softmax, P
    load_q<T>(qhi, qlo, qc, qr, w.b, h0, H, st, tid);
    const uint32_t qhi_u32 = smem_u32(qhi), qlo_u32 = smem_u32(qlo);
    float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.0f, 0.0f};
    // Tile i: its scores issued, then, while they run, once warpgroups 1
    // and 2 are done with tile i - 1 (its P and its stage), tile i + 1
    // loaded into that stage.
    float sc[16];
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % MLA_STAGES;
      mbar_wait(&full[s], (i / MLA_STAGES) & 1);
      issue_qk<T>(sc, kv_u32 + s * kStageBytes, qhi_u32, qlo_u32);
      if (i > 0) {
        bar_sync(kBarPFree, kConsumers);
        if (tid == 0 && i + 1 < n_tiles) load(i + 1);
      }
      wgmma_wait0();
      fence_acc(sc);

      // scale (log2 units), mask the ragged end, online softmax over the
      // row's 4 lanes, into p (only wgmma writes the accumulator, so that
      // ptxas need not serialise the products); register e holds row rw +
      // 8 ((e / 2) % 2), column 8 (e / 4) + 2 t + e % 2
      const int pos0 = start + i * MLA_BK;
      const bool edge = pos0 + MLA_BK > end;
      float p[16], mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        p[e] = sc[e] * sl2;
        if (edge && pos0 + 8 * (e / 4) + 2 * t + (e % 2) >= end)
          p[e] = kMasked;
        mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], p[e]);
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m_run[rr], mx[rr]);
        corr[rr] = ex2(m_run[rr] - m_new);
        m_run[rr] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        p[e] = ex2(p[e] - m_run[(e / 2) % 2]);
        rs[(e / 2) % 2] += p[e];
      }
      l_run[0] = l_run[0] * corr[0] + rs[0];
      l_run[1] = l_run[1] * corr[1] + rs[1];

      // P and corr to shared memory: element (row R, column C) at
      // (C / 16) 2048 + (R / 8) 256 + ((C / 8) % 2) 128 + (R % 8) 16 +
      // (C % 8) 2
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const int j = e / 4, rr = (e / 2) % 2;
        const int off = (j / 2) * 2048 + (2 * warp + rr) * 256 +
                        (j % 2) * 128 + g * 16 + 4 * t;
        uint32_t hi, lo;
        Split<T>::run(p[e], p[e + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(phi + off) = hi;
        *reinterpret_cast<uint32_t*>(plo + off) = lo;
      }
      if (t == 0) {
        corr_s[rw] = corr[0];
        corr_s[rw + 8] = corr[1];
      }
      fence_async_smem();
      bar_arrive(kBarPReady, kConsumers);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
      l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
    }
    bar_sync(kBarPFree, kConsumers);  // balances the last tile's arrivals
    if (t == 0) {
      max_s[rw] = m_run[0];
      max_s[rw + 8] = m_run[1];
      sum_s[rw] = l_run[0];
      sum_s[rw + 8] = l_run[1];
    }
    bar_sync(kBarFinal, kConsumers);
    return;
  }

  // ---- warpgroups 1 and 2: o[:, 256 half + ...] += P c_kv
  load_q<T>(qhi, qlo, qc, qr, w.b, h0, H, st, tid);
  const int half = wg - 1;
  const uint32_t phi_u32 = smem_u32(phi), plo_u32 = smem_u32(plo);
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % MLA_STAGES;
    bar_sync(kBarPReady, kConsumers);
    mbar_wait(&full[s], (i / MLA_STAGES) & 1);  // complete: made visible
    const float c0 = corr_s[rw], c1 = corr_s[rw + 8];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] *= ((e / 2) % 2) ? c1 : c0;
    issue_pv<T>(acc, kv_u32 + s * kStageBytes, phi_u32, plo_u32, half);
    wgmma_wait0();
    fence_acc(acc);
    bar_arrive(kBarPFree, kConsumers);
  }
  bar_sync(kBarFinal, kConsumers);
  const float m_fin[2] = {max_s[rw], max_s[rw + 8]};
  const float l_fin[2] = {sum_s[rw], sum_s[rw + 8]};

  // ---- o: register e holds row rw + 8 ((e / 2) % 2), column 256 half +
  // 8 (e / 4) + 2 t + e % 2.  The slot's only split writes o / sum; any
  // other writes its unnormalised o, max and sum for the combine kernel.
  const int col0 = 256 * half + 2 * t;
  if (whole) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int h = h0 + rw + 8 * rr;
      if (h >= H) continue;
      const float inv = 1.0f / fmaxf(l_fin[rr], 1e-30f);
      float* orow = o + w.b * st.ob + (long long)h * st.oh + col0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * rr] * inv,
                        acc[4 * j + 2 * rr + 1] * inv);
    }
  } else {
    float* part = ws + ((long long)(w.b * HG + w.hg) * n_splits + w.split) *
                           kPartFloats;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rw + 8 * rr;
      float* prow = part + row * MLA_R + col0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(prow + 8 * j) =
            make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      if (half == 0 && t == 0) {
        part[MLA_HEADS * MLA_R + row] = m_fin[rr];
        part[MLA_HEADS * MLA_R + MLA_HEADS + row] = l_fin[rr];
      }
    }
  }
}

// One block a (slot, head): where the slot's live length spans more than
// one split, o = sum_j 2^(m_j - M) o_j / sum_j 2^(m_j - M) l_j over its
// live splits' partials (M the largest m_j), a thread two of o's columns.
// A block a head, not a head group, so that a few slots still fill the
// card: the splits' partials are read by B * H blocks at once.
__global__ void __launch_bounds__(256)
mla_combine_kernel(const void* __restrict__ idx, int idx64,
                   const float* __restrict__ ws, float* __restrict__ o,
                   int B, int H, int Skv, int split_len, int n_splits,
                   long long ob, long long oh) {
  const int HG = (H + MLA_HEADS - 1) / MLA_HEADS;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hg = h / MLA_HEADS, r = h % MLA_HEADS;
  const int L = live_length(idx, idx64, b, Skv);
  if (L <= split_len) return;  // the main kernel wrote o
  const int n = (L + split_len - 1) / split_len;
  const float* part = ws + (long long)(b * HG + hg) * n_splits * kPartFloats;
  const int d = 2 * threadIdx.x;
  float mmax = kMasked;
  for (int j = 0; j < n; ++j)
    mmax = fmaxf(mmax, part[j * kPartFloats + MLA_HEADS * MLA_R + r]);
  float denom = 0.0f, a0 = 0.0f, a1 = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float* pj = part + j * kPartFloats;
    const float c = ex2(pj[MLA_HEADS * MLA_R + r] - mmax);
    denom += c * pj[MLA_HEADS * MLA_R + MLA_HEADS + r];
    const float2 x = *reinterpret_cast<const float2*>(pj + r * MLA_R + d);
    a0 += c * x.x;
    a1 += c * x.y;
  }
  const float inv = 1.0f / fmaxf(denom, 1e-30f);
  *reinterpret_cast<float2*>(o + b * ob + (long long)h * oh + d) =
      make_float2(a0 * inv, a1 * inv);
}

// ------------------------------------------------------------- simt path
constexpr int kSimtWarps = 8;

// One block a (slot, head): warp w runs an online softmax over live
// positions w, w + 8, ...; a position's score is the warp's sum over its
// lanes' columns (lane + 32 k); the warps' (max, sum, o) are merged at
// the end.  f32 throughout; exp2f, not the approximate ex2.
__global__ void __launch_bounds__(kSimtWarps * 32)
mla_simt_kernel(const float* __restrict__ qc, const float* __restrict__ qr,
                const float* __restrict__ ckv, const float* __restrict__ kr,
                const void* __restrict__ idx, int idx64,
                float* __restrict__ o, int H, int Skv, int R, int Dr,
                float sl2, Strides st) {
  constexpr int KO = MLA_SIMT_MAX_R / 32;  // o columns a lane
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int L = live_length(idx, idx64, b, Skv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = R + Dr;
  __shared__ float q_s[MLA_SIMT_MAX_DQ];
  __shared__ float m_s[kSimtWarps], l_s[kSimtWarps];
  __shared__ float o_s[kSimtWarps][MLA_SIMT_MAX_R];
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    q_s[d] = d < R ? qc[b * st.qcb + h * st.qch + d]
                   : qr[b * st.qrb + h * st.qrh + d - R];
  __syncthreads();

  float m = kMasked, l = 0.0f, acc[KO];
#pragma unroll
  for (int k = 0; k < KO; ++k) acc[k] = 0.0f;
  for (int j = warp; j < L; j += kSimtWarps) {
    const float* crow = ckv + b * st.cb + (long long)j * st.cs;
    const float* krow = kr + b * st.kb + (long long)j * st.ks;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(q_s[d], d < R ? crow[d] : krow[d - R], s);
#pragma unroll
    for (int x = 16; x > 0; x /= 2) s += __shfl_xor_sync(0xffffffffu, s, x);
    const float sv = s * sl2;
    const float m_new = fmaxf(m, sv);
    const float c = exp2f(m - m_new), p = exp2f(sv - m_new);
    l = l * c + p;
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int d = lane + 32 * k;
      if (d < R) acc[k] = fmaf(p, crow[d], acc[k] * c);
    }
    m = m_new;
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < KO; ++k) {
    const int d = lane + 32 * k;
    if (d < R) o_s[warp][d] = acc[k];
  }
  __syncthreads();
  float mmax = kMasked;
  for (int x = 0; x < kSimtWarps; ++x) mmax = fmaxf(mmax, m_s[x]);
  float denom = 0.0f;
  for (int x = 0; x < kSimtWarps; ++x) denom += exp2f(m_s[x] - mmax) * l_s[x];
  for (int d = threadIdx.x; d < R; d += blockDim.x) {
    float a = 0.0f;
    for (int x = 0; x < kSimtWarps; ++x)
      a += exp2f(m_s[x] - mmax) * o_s[x][d];
    o[b * st.ob + h * st.oh + d] = a / denom;
  }
}

// ------------------------------------------------------------- dispatch
// cuTensorMapEncodeTiled, found through the runtime (no -lcuda link).
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

// A (width, Skv, B) map of 16-bit elements, rows `ss` and slots `sb`
// elements apart, boxes of 64 x MLA_BK x 1 in the 128-byte swizzle; rows
// past Skv read as zeros.
CUresult make_map(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                  uint64_t width, uint64_t skv, uint64_t b, uint64_t ss,
                  uint64_t sb) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {width, skv, b};
  const cuuint64_t strides[2] = {ss * 2, sb * 2};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {kBoxCols, MLA_BK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T>
int launch_wgmma(const float* qc, const float* qr, const void* ckv,
                 const void* kr, const void* idx, int idx64, float* o,
                 float* ws, int B, int H, int Skv, int split_len,
                 int n_splits, float sl2, const Strides& st,
                 cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mc, mk;
  CUresult r = make_map(&mc, type, ckv, MLA_R, Skv, B, st.cs, st.cb);
  if (r == CUDA_SUCCESS)
    r = make_map(&mk, type, kr, MLA_ROPE, Skv, B, st.ks, st.kb);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;  // 1000 + the CUresult
  auto kern = mla_wgmma_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int HG = (H + MLA_HEADS - 1) / MLA_HEADS;
  const long long blocks = (long long)n_splits * B * HG;
  if (blocks > 0x7fffffff || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      mc, mk, qc, qr, idx, idx64, o, ws, B, H, Skv, split_len, n_splits, sl2,
      st);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  mla_combine_kernel<<<B * H, 256, 0, stream>>>(
      idx, idx64, ws, o, B, H, Skv, split_len, n_splits, st.ob, st.oh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 float32 (simt), 2 float16, 3 bfloat16 (wgmma).  q_c (B, H, R)
// and q_rope (B, H, Dr), f32, and o (B, H, R), f32, through their (batch,
// head) element strides, rows contiguous and 16-byte aligned; c_kv
// (B, Skv, R) and k_rope (B, Skv, Dr) in the cache's dtype through their
// (batch, seq) element strides, rows contiguous; idx (B,) int32 or
// (idx64) int64 on the device, each slot's last live position.  wgmma:
// R = MLA_R, Dr = MLA_ROPE, cache bases and strides whole 16-byte
// chunks (TMA), ws n_splits * B * ceil(H / MLA_HEADS) partials of
// MLA_HEADS * (MLA_R + 2) floats where n_splits > 1, positions split
// into n_splits runs of split_len (a multiple of MLA_BK).  simt: R <=
// MLA_SIMT_MAX_R, R + Dr <= MLA_SIMT_MAX_DQ, no split.  Returns the
// launch's cudaGetLastError() (0 on success), -1 for a dtype or split
// the library does not take, -2 for widths or operands the path cannot
// read, 1000 + a CUresult where a TMA map could not be made.
extern "C" int mla_decode(int dtype, const void* qc, const void* qr,
                          const void* ckv, const void* kr, const void* idx,
                          int idx64, void* o, void* ws, int B, int H,
                          int Skv, int R, int Dr, int split_len,
                          int n_splits, float scale, long long qcb,
                          long long qch, long long qrb, long long qrh,
                          long long ob, long long oh, long long cb,
                          long long cs, long long kb, long long ks,
                          void* stream) {
  if (dtype < 1 || dtype > 3 || B <= 0 || H <= 0 || Skv <= 0) return -1;
  const Strides st{qcb, qch, qrb, qrh, ob, oh, cb, cs, kb, ks};
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (R <= 0 || R > MLA_SIMT_MAX_R || Dr < 0 || R + Dr > MLA_SIMT_MAX_DQ)
      return -2;
    if ((long long)B * H > 0x7fffffff) return -1;
    mla_simt_kernel<<<B * H, kSimtWarps * 32, 0, s>>>(
        static_cast<const float*>(qc), static_cast<const float*>(qr),
        static_cast<const float*>(ckv), static_cast<const float*>(kr), idx,
        idx64, static_cast<float*>(o), H, Skv, R, Dr, sl2, st);
    return (int)cudaGetLastError();
  }
  if (R != MLA_R || Dr != MLA_ROPE) return -2;
  if (n_splits < 1 || split_len <= 0 || split_len % MLA_BK != 0 ||
      (long long)split_len * n_splits < Skv ||
      (n_splits > 1 && ws == nullptr))
    return -1;
  // TMA: 16-byte aligned bases and strides; the f32 rows' 16-byte loads
  const uintptr_t bases = reinterpret_cast<uintptr_t>(ckv) |
                          reinterpret_cast<uintptr_t>(kr) |
                          reinterpret_cast<uintptr_t>(qc) |
                          reinterpret_cast<uintptr_t>(qr) |
                          reinterpret_cast<uintptr_t>(o);
  if (bases % 16 != 0 || cs % 8 || cb % 8 || ks % 8 || kb % 8 || qcb % 4 ||
      qch % 4 || qrb % 4 || qrh % 4 || ob % 2 || oh % 2)
    return -2;
  const float* q1 = static_cast<const float*>(qc);
  const float* q2 = static_cast<const float*>(qr);
  float* out = static_cast<float*>(o);
  float* w = static_cast<float*>(ws);
  return dtype == 2
      ? launch_wgmma<__half>(q1, q2, ckv, kr, idx, idx64, out, w, B, H, Skv,
                             split_len, n_splits, sl2, st, s)
      : launch_wgmma<__nv_bfloat16>(q1, q2, ckv, kr, idx, idx64, out, w, B,
                                    H, Skv, split_len, n_splits, sl2, st, s);
}
