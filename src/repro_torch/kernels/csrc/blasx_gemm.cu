// Batched long-K tile GEMM for Hopper (sm_90a): c[g] = sum_s a[g,s] @ b[g,s].
//
// Replaces the reference's TPU path for full-fill step groups:
//   kernels/matmul.py::_matmul_kernel             (the Pallas tile matmul)
//   kernels/ops.py::matmul                        (pad-to-block wrapper)
//   backends/pallas_backend.py::_batched_pallas_contract
//                                                 (transpose + reshape to
//                                                  (G, m, s*k) @ (G, s*k, n),
//                                                  vmapped over G)
// On the TPU the s-loop became a long K walked by a sequential grid axis
// with the f32 accumulator parked in VMEM.  Here one block owns one
// BM x BN output tile of one item g and loops over s and over K in BK
// steps itself, reading the stacked tiles a (G,S,M,K) and b (G,S,K,N)
// in place: no transpose, no reshape copy, no pad copy (ragged M/N/K
// edges are masked loads that fill zeros).
//
// What bounds it: at the runtime's shapes (G=4, S=16, 1024^3 tiles)
// the work is 2*G*S*M*K*N flops against (G*S*(MK+KN) + G*MN) elements
// moved, hundreds of flops per byte, so it is compute-bound.  The design
// answers with register blocking: 256 threads each keep a TM x TN
// (8 x 8 at 128 x 128 blocks) accumulator in registers and read
// TM + TN shared-memory values per TM*TN FMAs.  It runs on the CUDA
// cores (FMA in the accumulator type: f64 for f64, f32 for f32 — no
// TF32 — and f32 for f16/bf16), not on the tensor cores; wgmma/TMA and
// a multi-stage pipeline are later work.
//
// The epilogue also replaces kernels/matmul.py::_matmul_bias_kernel and
// the ACTIVATIONS table (matmul.py:27): an optional bias row (one value
// per column, handed over in the accumulator type, as the reference's
// bias.astype(f32), and added to the sums),
// then the activation none/relu/gelu(tanh form)/silu/tanh, then the cast.
// The activation is a runtime int, not a template parameter, and an
// out-of-line call, so the instantiation count and the build time stay
// what they were; it runs once per output element, after the K loop.  The wrapper passes an
// epilogue only for G == 1, S == 1 (a plain matmul); the runtime's
// batched groups call with none.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads per block
constexpr int kPad = 4;        // skews the transposed A tile across banks

template <typename T> struct Cvt;
template <> struct Cvt<double> {
  using Acc = double;
  static __device__ __forceinline__ double load(double x) { return x; }
  static __device__ __forceinline__ double store(double x) { return x; }
};
template <> struct Cvt<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <> struct Cvt<__half> {
  using Acc = float;
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(float x) { return __float2half_rn(x); }
};
template <> struct Cvt<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// activation codes (kernels/matmul.py ACTIVATION_CODES)
enum Act { kActNone = 0, kActRelu = 1, kActGelu = 2, kActSilu = 3,
           kActTanh = 4 };

// gelu is the tanh approximation, jax.nn.gelu's default.  Not inlined:
// tanh/exp inlined into each of a thread's TM x TN unrolled outputs, in
// all 48 instantiations, made the library's build ~7x slower (218 s
// against 20-37 s without the epilogue, nvcc on the H100 machine); one
// call per output element is nothing next to the K loop.
__device__ __noinline__ float activate(float x, int act) {
  switch (act) {
    case kActRelu: return fmaxf(x, 0.0f);
    case kActGelu: return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                                   (x + 0.044715f * x * x * x)));
    case kActSilu: return x / (1.0f + expf(-x));
    case kActTanh: return tanhf(x);
    default: return x;
  }
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

// One block: the BM x BN tile (blockIdx.y, blockIdx.x) of item blockIdx.z.
// out_acc != 0 writes the accumulator type instead of T (a half-precision
// matmul asked for an f32 result gets the unrounded sums).  bias (N
// values of the accumulator type, may be null) and act form the epilogue.
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const typename Cvt<T>::Acc* __restrict__ bias,
                    void* __restrict__ c,
                    int out_acc, int act, int S, int M, int K, int N) {
  using Acc = typename Cvt<T>::Acc;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LDA = BM + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* As = reinterpret_cast<Acc*>(smem_raw);  // [BK][LDA], A transposed
  Acc* Bs = As + BK * LDA;                     // [BK][BN]

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // thread row: rows tr + 16*i
  const int tc = tid % 16;  // thread col: cols tc + 16*j
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int64_t g = blockIdx.z;
  const int64_t a_step = (int64_t)M * K;
  const int64_t b_step = (int64_t)K * N;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int s = 0; s < S; ++s) {
    const T* as = a + (g * S + s) * a_step;
    const T* bs = b + (g * S + s) * b_step;
    for (int k0 = 0; k0 < K; k0 += BK) {
      // A sub-tile (BM x BK): consecutive threads walk k, the
      // contiguous axis of row-major A; stored transposed.
      for (int idx = tid; idx < BM * BK; idx += kThreads) {
        const int r = idx / BK, kk = idx % BK;
        const int gm = m0 + r, gk = k0 + kk;
        As[kk * LDA + r] = (gm < M && gk < K)
            ? Cvt<T>::load(as[(int64_t)gm * K + gk]) : Acc(0);
      }
      // B sub-tile (BK x BN): consecutive threads walk n.
      for (int idx = tid; idx < BK * BN; idx += kThreads) {
        const int kk = idx / BN, cc = idx % BN;
        const int gk = k0 + kk, gn = n0 + cc;
        Bs[kk * BN + cc] = (gk < K && gn < N)
            ? Cvt<T>::load(bs[(int64_t)gk * N + gn]) : Acc(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Acc ra[TM], rb[TN];
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
      const int64_t o = c_off + (int64_t)gm * N + gn;
      Acc r = acc[i][j];
      if (bias != nullptr) r += bias[gn];
      if (act != kActNone) r = activate(r, act);
      if (out_acc) {
        reinterpret_cast<Acc*>(c)[o] = r;
      } else {
        reinterpret_cast<T*>(c)[o] = Cvt<T>::store(r);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const void* a, const void* b, const void* bias, void* c,
                   int out_acc, int act, int G, int S, int M, int K, int N,
                   cudaStream_t stream) {
  using Acc = typename Cvt<T>::Acc;
  const size_t smem = (size_t)BK * (BM + kPad + BN) * sizeof(Acc);
  auto kern = batched_gemm_kernel<T, BM, BN, BK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const Acc*>(bias), c, out_acc, act, S, M, K, N);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int bm, int bn, int bk, const void* a, const void* b,
             const void* bias, void* c, int out_acc, int act, int G, int S,
             int M, int K, int N, cudaStream_t stream) {
#define BLASX_CASE(BM_, BN_, BK_)                                         \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                \
    return (int)launch<T, BM_, BN_, BK_>(a, b, bias, c, out_acc, act, G, S, \
                                         M, K, N, stream);
#define BLASX_CASES_K(BM_, BN_) \
  BLASX_CASE(BM_, BN_, 8) BLASX_CASE(BM_, BN_, 16) BLASX_CASE(BM_, BN_, 32)
  BLASX_CASES_K(64, 64)
  BLASX_CASES_K(64, 128)
  BLASX_CASES_K(128, 64)
  BLASX_CASES_K(128, 128)
#undef BLASX_CASES_K
#undef BLASX_CASE
  return -1;  // block shape outside the compiled table
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 float16, 3 bfloat16.  bias: N values of
// the accumulator type (f64 for f64, else f32), or null; act: an Act code.  Returns the launch's
// cudaGetLastError() (0 on success), or -1 for a block shape, dtype or
// activation the library was not built for.
extern "C" int blasx_batched_gemm(int dtype, int out_acc, const void* a,
                                  const void* b, const void* bias, int act,
                                  void* c, int G, int S, int M, int K, int N,
                                  int bm, int bn, int bk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActTanh) return -1;
#define BLASX_DISPATCH(T_) \
  dispatch<T_>(bm, bn, bk, a, b, bias, c, out_acc, act, G, S, M, K, N, st)
  switch (dtype) {
    case 0: return BLASX_DISPATCH(double);
    case 1: return BLASX_DISPATCH(float);
    case 2: return BLASX_DISPATCH(__half);
    case 3: return BLASX_DISPATCH(__nv_bfloat16);
    default: return -1;
  }
#undef BLASX_DISPATCH
}
