// Batched long-K tile GEMM for Hopper (sm_90a):
//   c[g] = act(sum_s a[g,s] @ b[g,s] + bias).
//
// Replaces the reference's TPU path for full-fill step groups:
//   kernels/matmul.py::_matmul_kernel             (the Pallas tile matmul)
//   kernels/matmul.py::_matmul_bias_kernel        (its bias/activation body)
//   kernels/ops.py::matmul                        (pad-to-block wrapper)
//   backends/pallas_backend.py::_batched_pallas_contract
//                                                 (transpose + reshape to
//                                                  (G, m, s*k) @ (G, s*k, n),
//                                                  vmapped over G)
// On the TPU the s-loop became a long K walked by a sequential grid axis
// with the f32 accumulator parked in VMEM.  Here one block owns one
// BM x BN output tile of one item g and walks the S * ceil(K / BK)
// k-steps of that item itself, reading the stacked tiles a (G,S,M,K) and
// b (G,S,K,N) in place: no transpose, no reshape copy, no pad copy.
//
// What bounds it: at the runtime's shapes (G=4, S=16, 1024^3 tiles) the
// work is 2*G*S*M*K*N flops against (G*S*(MK+KN) + G*MN) elements moved,
// hundreds of flops per byte, so it is compute-bound, and the card's
// compute for these types is in its tensor cores.  Three paths, chosen
// by the storage type and alignment alone in the wrapper
// (kernels/matmul.py::kernel_path) and passed in as `path`:
//
//   wgmma  f16/bf16 with K % 8 == 0, N % 8 == 0 and 16-byte aligned
//          bases (what TMA takes).  128 x BN tiles (BN 128 or 256), two
//          consumer warpgroups of 64 rows, BK = 64.  One thread issues
//          TMA loads into a ring of shared-memory stages, completion on
//          an mbarrier with expect-tx; the warpgroups run wgmma
//          m64nBNk16 on the stage that has arrived and release it on a
//          second mbarrier once wgmma.wait_group shows it read.  The
//          tensor maps are 3-D, (K, M, G*S) and (N, K, G*S), so TMA's
//          zero fill stops at each item's edge.  f32 accumulators.
//   dmma   f64, every shape.  mma.sync m16n8k4 on the FP64 tensor cores
//          (IEEE f64 FMA, so f64 stays f64), 32 x 32 warp tiles, a
//          3-stage cp.async ring of 8-byte copies whose src-size zero-
//          fills the ragged edges (odd K included).
//   simt   f32 (no TF32), and f16/bf16 shapes the TMA path cannot take:
//          the CUDA-core register-blocked loop (256 threads, TM x TN
//          accumulators each, f32 FMA).
//
// The epilogue is the same on every path: mask the store at ragged M/N,
// add the optional bias row (one value per column, handed over in the
// accumulator type, as the reference's bias.astype(f32)), apply the
// activation none/relu/gelu(tanh form)/silu/tanh, then cast — or write
// the accumulator type when out_acc is set.  The activation is a
// runtime int and an out-of-line call, so the instantiation count and
// the build time stay small.  The wrapper passes an epilogue only for
// G == 1, S == 1 (a plain matmul); the runtime's batched groups pass none.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime's cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// path codes (kernels/matmul.py PATH_CODES)
enum Path { kPathSimt = 0, kPathWgmma = 1, kPathDmma = 2 };

// The compiled table of each path, X(BM, BN, BK, STAGES): the wrapper's
// kernels/matmul.py BLOCKS, which holds the stage counts (a CPU test
// holds the two equal).  simt has no ring: one synchronous stage.
#define BLASX_SIMT_BLOCKS(X)                                      \
  X(64, 64, 8, 1) X(64, 64, 16, 1) X(64, 64, 32, 1)               \
  X(64, 128, 8, 1) X(64, 128, 16, 1) X(64, 128, 32, 1)            \
  X(128, 64, 8, 1) X(128, 64, 16, 1) X(128, 64, 32, 1)            \
  X(128, 128, 8, 1) X(128, 128, 16, 1) X(128, 128, 32, 1)
#define BLASX_WGMMA_BLOCKS(X) X(128, 128, 64, 3) X(128, 256, 64, 4)
#define BLASX_DMMA_BLOCKS(X) X(64, 64, 16, 3) X(128, 64, 16, 3)

// activation codes (kernels/matmul.py ACTIVATION_CODES)
enum Act { kActNone = 0, kActRelu = 1, kActGelu = 2, kActSilu = 3,
           kActTanh = 4 };

// gelu is the tanh approximation, jax.nn.gelu's default.  The simt and
// dmma epilogues call it out of line: tanh/exp inlined into each of a
// thread's unrolled outputs, in every instantiation, made the library's
// build ~7x slower (218 s against 20-37 s, nvcc on the H100 machine).
// The wgmma epilogue inlines it into a rolled loop (one copy a kernel).
__device__ __forceinline__ float activate_inline(float x, int act) {
  switch (act) {
    case kActRelu: return fmaxf(x, 0.0f);
    case kActGelu: return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                                   (x + 0.044715f * x * x * x)));
    case kActSilu: return x / (1.0f + expf(-x));
    case kActTanh: return tanhf(x);
    default: return x;
  }
}
__device__ __noinline__ float activate(float x, int act) {
  return activate_inline(x, act);
}
__device__ __noinline__ double activate(double x, int act) {
  switch (act) {
    case kActRelu: return fmax(x, 0.0);
    case kActGelu: return 0.5 * x * (1.0 + tanh(0.7978845608028654 *
                                                (x + 0.044715 * x * x * x)));
    case kActSilu: return x / (1.0 + exp(-x));
    case kActTanh: return tanh(x);
    default: return x;
  }
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(float x) { return __float2half_rn(x); }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// One output element of the epilogue: bias, activation, then the store
// in the storage type T or, with out_acc, in the accumulator type Acc.
template <typename T, typename Acc>
__device__ __forceinline__ void store_out(void* c, int64_t o, Acc r,
                                          const Acc* bias, int gn,
                                          int out_acc, int act) {
  if (bias != nullptr) r += bias[gn];
  if (act != kActNone) r = activate(r, act);
  if constexpr (std::is_same<T, Acc>::value) {
    reinterpret_cast<Acc*>(c)[o] = r;
  } else {
    if (out_acc) reinterpret_cast<Acc*>(c)[o] = r;
    else reinterpret_cast<T*>(c)[o] = Cvt<T>::store(r);
  }
}

// ============================================================== simt path
constexpr int kSimtThreads = 256;  // 16 x 16 threads per block
constexpr int kPad = 4;            // skews the transposed A tile across banks

// One block: the BM x BN tile (blockIdx.y, blockIdx.x) of item blockIdx.z.
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kSimtThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ bias, void* __restrict__ c,
                    int out_acc, int act, int S, int M, int K, int N) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LDA = BM + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [BK][LDA], A transposed
  float* Bs = As + BK * LDA;                       // [BK][BN]

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // thread row: rows tr + 16*i
  const int tc = tid % 16;  // thread col: cols tc + 16*j
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int64_t g = blockIdx.z;
  const int64_t a_step = (int64_t)M * K;
  const int64_t b_step = (int64_t)K * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < S; ++s) {
    const T* as = a + (g * S + s) * a_step;
    const T* bs = b + (g * S + s) * b_step;
    for (int k0 = 0; k0 < K; k0 += BK) {
      // A sub-tile (BM x BK): consecutive threads walk k, the
      // contiguous axis of row-major A; stored transposed.
      for (int idx = tid; idx < BM * BK; idx += kSimtThreads) {
        const int r = idx / BK, kk = idx % BK;
        const int gm = m0 + r, gk = k0 + kk;
        As[kk * LDA + r] = (gm < M && gk < K)
            ? Cvt<T>::load(as[(int64_t)gm * K + gk]) : 0.0f;
      }
      // B sub-tile (BK x BN): consecutive threads walk n.
      for (int idx = tid; idx < BK * BN; idx += kSimtThreads) {
        const int kk = idx / BN, cc = idx % BN;
        const int gk = k0 + kk, gn = n0 + cc;
        Bs[kk * BN + cc] = (gk < K && gn < N)
            ? Cvt<T>::load(bs[(int64_t)gk * N + gn]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ra[TM], rb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = As[kk * LDA + tr + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = Bs[kk * BN + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += ra[i] * rb[j];
      }
      __syncthreads();
    }
  }

  const int64_t c_off = g * (int64_t)M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn >= N) continue;
      store_out<T, float>(c, c_off + (int64_t)gm * N + gn, acc[i][j], bias,
                          gn, out_acc, act);
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch_simt(const void* a, const void* b, const void* bias,
                        void* c, int out_acc, int act, int G, int S, int M,
                        int K, int N, cudaStream_t stream) {
  const size_t smem = (size_t)BK * (BM + kPad + BN) * sizeof(float);
  auto kern = batched_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  kern<<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(bias), c, out_acc, act, S, M, K, N);
  return cudaGetLastError();
}

template <typename T>
int dispatch_simt(int bm, int bn, int bk, int stages, const void* a,
                  const void* b, const void* bias, void* c, int out_acc,
                  int act, int G, int S, int M, int K, int N,
                  cudaStream_t stream) {
#define BLASX_CASE(BM_, BN_, BK_, ST_)                                    \
  if (bm == BM_ && bn == BN_ && bk == BK_ && stages == ST_)               \
    return (int)launch_simt<T, BM_, BN_, BK_>(a, b, bias, c, out_acc, act, \
                                              G, S, M, K, N, stream);
  BLASX_SIMT_BLOCKS(BLASX_CASE)
#undef BLASX_CASE
  return -1;  // block shape outside the compiled table
}

// ============================================================= wgmma path
// Shared-memory and barrier helpers (PTX; sm_90).
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

// wgmma shared-memory descriptor for a tile in the 128-byte swizzle
// that TMA wrote: start address, leading and stride byte offsets (all
// in 16-byte units), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions that own those registers.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define BLASX_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x N, f32) += A(64 x 16, K-major) @ B(16 x N, N-major) from two
// shared-memory descriptors; scale-d = 1, A not transposed, B
// transposed (row-major (K, N) B is N-major).
#define BLASX_WGMMA_N128(TY)                                                 \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "%64, %65, p, 1, 1, 0, 1;\n}\n"                                        \
      : BLASX_D8(0), BLASX_D8(8), BLASX_D8(16), BLASX_D8(24),                \
        BLASX_D8(32), BLASX_D8(40), BLASX_D8(48), BLASX_D8(56)               \
      : "l"(da), "l"(db), "r"(1))

#define BLASX_WGMMA_N256(TY)                                                 \
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
      : BLASX_D8(0), BLASX_D8(8), BLASX_D8(16), BLASX_D8(24),                \
        BLASX_D8(32), BLASX_D8(40), BLASX_D8(48), BLASX_D8(56),              \
        BLASX_D8(64), BLASX_D8(72), BLASX_D8(80), BLASX_D8(88),              \
        BLASX_D8(96), BLASX_D8(104), BLASX_D8(112), BLASX_D8(120)            \
      : "l"(da), "l"(db), "r"(1))
template <typename T, int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t da,
                                             uint64_t db) {
  static_assert(N == 128 || N == 256, "wgmma N");
  if constexpr (N == 128) {
    if constexpr (std::is_same<T, __half>::value) BLASX_WGMMA_N128("f16");
    else BLASX_WGMMA_N128("bf16");
  } else {
    if constexpr (std::is_same<T, __half>::value) BLASX_WGMMA_N256("f16");
    else BLASX_WGMMA_N256("bf16");
  }
}
#undef BLASX_WGMMA_N128
#undef BLASX_WGMMA_N256
#undef BLASX_D8

constexpr int kWgBM = 128;        // two consumer warpgroups of 64 rows
constexpr int kWgBK = 64;         // 128 bytes of a 16-bit row: one swizzle span
constexpr int kWgThreads = 256;
constexpr int kWgBox = 64;        // TMA box width along N (the swizzle span)

// A BM x BN tile with a ring of STAGES stages (BLASX_WGMMA_BLOCKS).
template <int BN, int STAGES> struct WgCfg {
  static constexpr int kABytes = kWgBM * kWgBK * 2;
  static constexpr int kBBytes = kWgBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // tiles, then full[] and empty[] barriers, plus slack to align the
  // tiles to the 1024 bytes the 128-byte swizzle repeats over
  static constexpr int kSmem = STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
  // blocks that fit on one SM (228 KB, 1 KB of it reserved per block)
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
};

template <typename T, int BN, int STAGES>
__global__ void __launch_bounds__(kWgThreads, WgCfg<BN, STAGES>::kMinBlocks)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                  const __grid_constant__ CUtensorMap tmap_b,
                  const float* __restrict__ bias, void* __restrict__ c,
                  int out_acc, int act, int S, int M, int K, int N) {
  using Cfg = WgCfg<BN, STAGES>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  unsigned char* smem = wg_smem + ((1024 - (raw & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::kStageBytes);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * kWgBM;
  const int n0 = blockIdx.x * BN;
  const int g = blockIdx.z;
  const int ksteps = (K + kWgBK - 1) / kWgBK;
  const int steps = S * ksteps;  // the s loop and the k loop, flattened

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);              // the producer's expect-tx
      mbar_init(&empty[i], kWgThreads);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // k-step t -> its stage: A box (k0, m0, item), B boxes (n0 + 64j, k0,
  // item).  Out-of-bounds parts of a box (ragged M/N/K, never another
  // item: the item is the third coordinate) arrive as zeros, and the
  // barrier still counts the whole box's bytes.
  auto produce = [&](int t) {
    const int slot = t % STAGES;
    const int item = g * S + t / ksteps;
    const int k0 = (t % ksteps) * kWgBK;
    unsigned char* sa = smem + slot * Cfg::kStageBytes;
    unsigned char* sb = sa + Cfg::kABytes;
    mbar_expect_tx(&full[slot], Cfg::kStageBytes);
    tma_load_3d(sa, &tmap_a, &full[slot], k0, m0, item);
#pragma unroll
    for (int j = 0; j < BN / kWgBox; ++j)
      tma_load_3d(sb + j * (kWgBK * kWgBox * 2), &tmap_b, &full[slot],
                  n0 + kWgBox * j, k0, item);
  };
  if (tid == 0) {
    for (int t = 0; t < STAGES && t < steps; ++t) produce(t);
  }
  __syncwarp();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int t = 0; t < steps; ++t) {
    const int slot = t % STAGES;
    mbar_wait(&full[slot], (t / STAGES) & 1);
    // A: this warpgroup's 64 rows of 128 bytes; a k16 slice is 32 bytes
    // further along the (swizzled) row.  SBO: 8 rows = 1024 bytes.
    const uint32_t a_base = smem_u32(smem + slot * Cfg::kStageBytes) +
                            wg * (64 * kWgBK * 2);
    // B: BN / 64 boxes of 64 k-rows x 128 bytes.  A k16 slice is 16
    // rows further (2048 bytes); LBO steps to the next 64 columns (the
    // next box, 8192 bytes), SBO to the next 8 k-rows (1024 bytes).
    const uint32_t b_base = smem_u32(smem + slot * Cfg::kStageBytes +
                                     Cfg::kABytes);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t da = gmma_desc(a_base + kk * 32, 16, 1024);
      const uint64_t db = gmma_desc(b_base + kk * 2048, kWgBK * kWgBox * 2,
                                    1024);
      wgmma_m64k16<T, BN>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // step t-1's products have read their stage: release it, and let
    // the producer refill it with step t-1+STAGES
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    if (t > 0) {
      const int prev = t - 1;
      const int ps = prev % STAGES;
      mbar_arrive(&empty[ps]);
      if (tid == 0 && prev + STAGES < steps) {
        mbar_wait(&empty[ps], (prev / STAGES) & 1);
        produce(prev + STAGES);
      }
      __syncwarp();  // warp 0 whole again before the next wgmma
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // The epilogue goes through shared memory, which the ring no longer
  // needs: the fragments land in a BM x BN f32 tile, then each thread
  // walks one column of it down the rows.  The stores coalesce, the
  // column's bias is read once, and the activation is inlined into a
  // rolled loop (an out-of-line call per element, from the unrolled
  // fragment loop or from this one, took longer than the products at
  // the MLP's shape).
  // wgmma's accumulator layout: register i of lane l in warp w of the
  // warpgroup holds row 16w + l/4 + 8*((i/2)%2), column 8*(i/4) +
  // 2*(l%4) + i%2 of the warpgroup's 64 x BN tile.
  constexpr int LDC = BN + 4;
  static_assert(kWgBM * LDC * 4 <= STAGES * Cfg::kStageBytes,
                "the output tile fits in the ring");
  float* ct = reinterpret_cast<float*>(smem);
  __syncthreads();  // both warpgroups' products have read their stages
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int c0 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    ct[(r0 + 8 * ((i / 2) % 2)) * LDC + c0 + 8 * (i / 4) + (i % 2)] = acc[i];
  __syncthreads();
  static_assert(kWgThreads % BN == 0, "each thread keeps one column");
  constexpr int RSTEP = kWgThreads / BN;
  const int cc = tid % BN;
  const int gn = n0 + cc;
  if (gn >= N) return;
  const float bv = bias != nullptr ? bias[gn] : 0.0f;
  const int64_t c_col = (int64_t)g * M * N + gn;
#pragma unroll 4
  for (int r = tid / BN; r < kWgBM && m0 + r < M; r += RSTEP) {
    const float v = activate_inline(ct[r * LDC + cc] + bv, act);
    const int64_t o = c_col + (int64_t)(m0 + r) * N;
    if (out_acc) reinterpret_cast<float*>(c)[o] = v;
    else reinterpret_cast<T*>(c)[o] = Cvt<T>::store(v);
  }
}

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

// A 3-D map of 16-bit elements, innermost first, boxes of box0 x box1 x
// 1 in the 128-byte swizzle; out-of-bounds elements read as zero.
CUresult make_map(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                  uint64_t d0, uint64_t d1, uint64_t d2, uint32_t box0,
                  uint32_t box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int BM, int BN, int BK, int STAGES>
int launch_wgmma(const void* a, const void* b, const void* bias, void* c,
                 int out_acc, int act, int G, int S, int M, int K, int N,
                 cudaStream_t stream) {
  static_assert(BM == kWgBM && BK == kWgBK, "wgmma tiles are 128 x BN x 64");
  const CUtensorMapDataType type = std::is_same<T, __half>::value
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ma, mb;
  // A (G,S,M,K) as (K, M, G*S); B (G,S,K,N) as (N, K, G*S)
  CUresult r = make_map(&ma, type, a, K, M, (uint64_t)G * S, kWgBK, kWgBM);
  if (r == CUDA_SUCCESS)
    r = make_map(&mb, type, b, N, K, (uint64_t)G * S, kWgBox, kWgBK);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;  // 1000 + the CUresult
  auto kern = wgmma_gemm_kernel<T, BN, STAGES>;
  const int smem = WgCfg<BN, STAGES>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + kWgBM - 1) / kWgBM, G);
  kern<<<grid, kWgThreads, smem, stream>>>(
      ma, mb, static_cast<const float*>(bias), c, out_acc, act, S, M, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_wgmma(int bm, int bn, int bk, int stages, const void* a,
                   const void* b, const void* bias, void* c, int out_acc,
                   int act, int G, int S, int M, int K, int N,
                   cudaStream_t stream) {
#define BLASX_CASE(BM_, BN_, BK_, ST_)                                     \
  if (bm == BM_ && bn == BN_ && bk == BK_ && stages == ST_)                \
    return launch_wgmma<T, BM_, BN_, BK_, ST_>(a, b, bias, c, out_acc, act, \
                                               G, S, M, K, N, stream);
  BLASX_WGMMA_BLOCKS(BLASX_CASE)
#undef BLASX_CASE
  return -1;  // block shape outside the compiled table
}

// ============================================================== dmma path
// BK = 16 (4 k4 steps a stage) and 3 stages: 4 stages and BK = 32 both
// measured slower
constexpr int kDmPad = 4;  // rows of 20 / BN+4 doubles: conflict-free fragments

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// D(16 x 8) += A(16 x 4) @ B(4 x 8) in f64 on the tensor cores.  Lane
// l (group q = l/4, t = l%4) holds a = A[q][t], A[q+8][t]; b = B[t][q];
// d = D[q][2t], D[q][2t+1], D[q+8][2t], D[q+8][2t+1].
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// One block: the BM x BN tile of item blockIdx.z; warps tile it 32 x 32
// (2 x 4 m16n8 tiles each).
template <int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__((BM / 32) * (BN / 32) * 32)
dmma_gemm_kernel(const double* __restrict__ a, const double* __restrict__ b,
                 const double* __restrict__ bias, double* __restrict__ c,
                 int act, int S, int M, int K, int N) {
  constexpr int WARPS_N = BN / 32;
  constexpr int THREADS = (BM / 32) * WARPS_N * 32;
  constexpr int LDA = BK + kDmPad;  // A stage [BM][LDA], row-major as in memory
  constexpr int LDB = BN + kDmPad;     // B stage [BK][LDB]
  extern __shared__ __align__(16) unsigned char dm_smem[];
  double* As = reinterpret_cast<double*>(dm_smem);
  double* Bs = As + STAGES * BM * LDA;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 32;
  const int q = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int64_t g = blockIdx.z;
  const int ksteps = (K + BK - 1) / BK;
  const int steps = S * ksteps;

  // k-step t -> its stage; out-of-range elements copy 0 bytes (zeros)
  // from the base pointer.  Each thread copies one column kk of A's
  // rows a_r0 + i * A_RSTEP and one column b_cc of B's rows b_k0 + i *
  // B_KSTEP: its row and column bounds are fixed for the whole walk.
  constexpr int A_RSTEP = THREADS / BK;
  constexpr int B_KSTEP = THREADS / BN;
  const int a_kk = tid % BK, a_r0 = tid / BK;
  const int b_cc = tid % BN, b_k0 = tid / BN;
  const bool b_col_ok = n0 + b_cc < N;
  auto load = [&](int t) {
    const int slot = t % STAGES;
    const int64_t item = g * S + t / ksteps;
    const int k0 = (t % ksteps) * BK;
    double* sa = As + slot * BM * LDA + a_r0 * LDA + a_kk;
    double* sb = Bs + slot * BK * LDB + b_k0 * LDB + b_cc;
    const bool a_k_ok = k0 + a_kk < K;
    const double* as = a + item * M * K + (int64_t)(m0 + a_r0) * K + k0 + a_kk;
#pragma unroll
    for (int i = 0; i < BM / A_RSTEP; ++i) {
      const bool ok = a_k_ok && m0 + a_r0 + i * A_RSTEP < M;
      cp_async8(sa + i * A_RSTEP * LDA, ok ? as + (int64_t)i * A_RSTEP * K : a,
                ok ? 8 : 0);
    }
    const double* bs = b + item * K * N + (int64_t)(k0 + b_k0) * N + n0 + b_cc;
#pragma unroll
    for (int i = 0; i < BK / B_KSTEP; ++i) {
      const bool ok = b_col_ok && k0 + b_k0 + i * B_KSTEP < K;
      cp_async8(sb + i * B_KSTEP * LDB, ok ? bs + (int64_t)i * B_KSTEP * N : b,
                ok ? 8 : 0);
    }
  };

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // step t has landed
    __syncthreads();                 // ... for every thread; t-1 is read
    if (t + STAGES - 1 < steps) load(t + STAGES - 1);
    cp_async_commit();
    const double* sa = As + (t % STAGES) * BM * LDA;
    const double* sb = Bs + (t % STAGES) * BK * LDB;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      double af[2][2], bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        af[i][0] = sa[(wm + 16 * i + q) * LDA + k4 + tq];
        af[i][1] = sa[(wm + 16 * i + q + 8) * LDA + k4 + tq];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bf[j] = sb[(k4 + tq) * LDB + wn + 8 * j + q];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dmma_16x8x4(acc[i][j], af[i][0], af[i][1], bf[j]);
    }
  }
  cp_async_wait<0>();

  const int64_t c_off = g * (int64_t)M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + 16 * i + q + 8 * (r / 2);
        const int gn = n0 + wn + 8 * j + 2 * tq + (r % 2);
        if (gm < M && gn < N)
          store_out<double, double>(c, c_off + (int64_t)gm * N + gn,
                                    acc[i][j][r], bias, gn, 0, act);
      }
}

template <int BM, int BN, int BK, int STAGES>
cudaError_t launch_dmma(const void* a, const void* b, const void* bias,
                        void* c, int act, int G, int S, int M, int K, int N,
                        cudaStream_t stream) {
  constexpr int threads = (BM / 32) * (BN / 32) * 32;
  const size_t smem = (size_t)STAGES *
      (BM * (BK + kDmPad) + BK * (BN + kDmPad)) * sizeof(double);
  auto kern = dmma_gemm_kernel<BM, BN, BK, STAGES>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(bias), static_cast<double*>(c), act, S, M, K,
      N);
  return cudaGetLastError();
}

int dispatch_dmma(int bm, int bn, int bk, int stages, const void* a,
                  const void* b, const void* bias, void* c, int act, int G,
                  int S, int M, int K, int N, cudaStream_t stream) {
#define BLASX_CASE(BM_, BN_, BK_, ST_)                                      \
  if (bm == BM_ && bn == BN_ && bk == BK_ && stages == ST_)                 \
    return (int)launch_dmma<BM_, BN_, BK_, ST_>(a, b, bias, c, act, G, S, M, \
                                                K, N, stream);
  BLASX_DMMA_BLOCKS(BLASX_CASE)
#undef BLASX_CASE
  return -1;  // block shape outside the compiled table
}

// Whether the wgmma path can read the operands through TMA: row strides
// (K * 2 and N * 2 bytes) multiples of 16 and 16-byte aligned bases.
bool tma_readable(const void* a, const void* b, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// path: a Path code, picked by the wrapper.  dtype: 0 float64, 1
// float32, 2 float16, 3 bfloat16.  bias: N values of the accumulator
// type (f64 for f64, else f32), or null; act: an Act code.  (bm, bn, bk,
// stages) must be in the path's compiled table.  Returns the launch's
// cudaGetLastError() (0 on success), 1000 + the CUresult of building the
// tensor maps, -1 for a block shape, dtype or activation the library
// was not built for, or -2 for operands the path cannot take (f64 off
// dmma, another type on it, 16-bit operands TMA cannot read on wgmma).
extern "C" int blasx_batched_gemm(int path, int dtype, int out_acc,
                                  const void* a, const void* b,
                                  const void* bias, int act, void* c, int G,
                                  int S, int M, int K, int N, int bm, int bn,
                                  int bk, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActTanh) return -1;
  if (dtype < 0 || dtype > 3) return -1;
  switch (path) {
    case kPathDmma:
      if (dtype != 0) return -2;
      return dispatch_dmma(bm, bn, bk, stages, a, b, bias, c, act, G, S, M,
                           K, N, st);
    case kPathWgmma:
      if (dtype < 2 || !tma_readable(a, b, K, N)) return -2;
      return dtype == 2
          ? dispatch_wgmma<__half>(bm, bn, bk, stages, a, b, bias, c,
                                   out_acc, act, G, S, M, K, N, st)
          : dispatch_wgmma<__nv_bfloat16>(bm, bn, bk, stages, a, b, bias, c,
                                          out_acc, act, G, S, M, K, N, st);
    case kPathSimt:
      break;
    default:
      return -1;
  }
#define BLASX_DISPATCH(T_)                                                 \
  dispatch_simt<T_>(bm, bn, bk, stages, a, b, bias, c, out_acc, act, G, S, \
                    M, K, N, st)
  switch (dtype) {
    case 1: return BLASX_DISPATCH(float);
    case 2: return BLASX_DISPATCH(__half);
    case 3: return BLASX_DISPATCH(__nv_bfloat16);
    default: return -2;  // f64 takes dmma
  }
#undef BLASX_DISPATCH
}
