// Flash-attention forward for Hopper (sm_90a): causal GQA attention with
// an online softmax, o = softmax(q k^T * scale + mask) v.
//
// Replaces the reference's TPU kernel
//   kernels/flash_attention.py::_flash_kernel      (the Pallas body)
//   kernels/flash_attention.py::flash_attention_bhsd (grid, pad copies)
//   kernels/flash_attention.py::flash_attention    (the (B,S,H,D) layout
//                                                    wrapper's transposes)
// and computes what _flash_kernel computes: f32 scores, a finite -1e30
// for masked scores (causal kpos <= qpos, top-left aligned even when
// Sq != Sk, and padding kpos < Sk), an f32 running max, denominator and
// accumulator, whole k-blocks above the diagonal skipped, the
// denominator clamped at 1e-30 and the output written in q's type.
//
// On the TPU the grid's k axis runs in order and carries m/l/acc in VMEM
// from one step to the next.  Blocks on Hopper run in parallel, so here
// one block owns one (batch*head, q-block) and walks the k-blocks itself:
// m and l live in registers, the BQ x D accumulator is spread over the
// 256 threads' registers (each thread holds TM rows x D/16 columns), and
// the q tile, the current K/V tiles and the probability tile are staged
// in shared memory (f32; 113 KB at D = 128, BQ = BK = 64, within the
// 227 KB a block may use).  q, k, v and o are read and written in place
// through their strides (any (B, S, H, D) layout with a contiguous last
// axis): no transpose and no pad copy, ragged rows are masked loads.
// GQA maps head h to kv head h / (H / Hkv).
//
// What bounds it: at the serving path's prefill (B*H = 16, S = 1024,
// D = 128, causal) the work is ~4.3 GFLOP against ~16 MB moved, so it is
// bound by operations.  This first version computes both products with
// FMAs on the CUDA cores in f32 (f32 inputs never take TF32), with a
// TM x TN register tile per thread so each shared-memory read feeds
// several FMAs; the tensor cores (mma.sync / wgmma for bf16/f16) and a
// TMA pipeline are later work, so bf16 runs far below its bound.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads per block
constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // k rows per step
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF

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

// element strides of q, k, v, o viewed as (B, S, H, D), D contiguous
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <int D, int BK = kBK, int BQ = kBQ>
constexpr size_t smem_floats() {
  return (size_t)D * (BQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)BK * (BQ + 1);
}

// One block: q rows [blockIdx.x * BQ, +BQ) of (batch, head) blockIdx.y.
// Thread (tr, tc) = (tid / 16, tid % 16) owns q rows tr + 16 i (i < TM):
// score columns tc + 16 j (j < TN) and output columns tc + 16 t (t < TD,
// those below D: at D = 8 half the threads hold no output column), so a
// row's max and sum reduce over the 16 lanes of one half-warp.
template <typename T, int D, int BK = kBK, int BQ = kBQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int group, int Sq, int Sk, float scale, int causal,
                 Strides st) {
  constexpr int TM = BQ / 16;
  constexpr int TN = BK / 16;
  constexpr int TD = (D + 15) / 16;
  constexpr int LDQ = BQ + 1;  // +1 skews the transposed tiles over banks
  constexpr int LDK = BK + 1;
  constexpr int LDP = BQ + 1;
  extern __shared__ float smem[];
  float* Qt = smem;          // [D][LDQ]  q tile, transposed
  float* Kt = Qt + D * LDQ;  // [D][LDK]  k tile, transposed
  float* Vs = Kt + D * LDK;  // [BK][D]   v tile
  float* Ps = Vs + BK * D;   // [BK][LDP] probabilities, transposed

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  // q tile: consecutive threads walk d, the contiguous axis
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qt[d * LDQ + r] = (q0 + r < Sq)
        ? Cvt<T>::load(qp[(int64_t)(q0 + r) * st.qs + d]) : 0.0f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.0f;
  }

  // causal: k-blocks wholly above the last valid q row are skipped
  int n_kb = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    n_kb = min(n_kb, q_last / BK + 1);
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step is done with Kt, Vs and Ps
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool ok = k0 + r < Sk;
      Kt[d * LDK + r] = ok ? Cvt<T>::load(kp[(int64_t)(k0 + r) * st.ks + d])
                           : 0.0f;
      Vs[r * D + d] = ok ? Cvt<T>::load(vp[(int64_t)(k0 + r) * st.vs + d])
                         : 0.0f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[TM], kr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qa[i] = Qt[d * LDQ + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) kr[j] = Kt[d * LDK + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qa[i], kr[j], s[i][j]);
    }

    // online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool valid = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= corr;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Ps[(tc + 16 * j) * LDP + tr + 16 * i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float p[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = Ps[kk * LDP + tr + 16 * i];
#pragma unroll
      for (int t = 0; t < TD; ++t)
        vv[t] = (tc + 16 * t < D) ? Vs[kk * D + tc + 16 * t] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TD; ++t) acc[i][t] = fmaf(p[i], vv[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < TD; ++t)
      if (tc + 16 * t < D)
        op[(int64_t)row * st.os + tc + 16 * t] =
            Cvt<T>::store(acc[i][t] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, float scale,
                   int causal, const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, Sq, Sk, scale,
      causal, st);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k,
               const void* v, void* o, int B, int H, int Hkv, int Sq, int Sk,
               float scale, int causal, const Strides& st,
               cudaStream_t stream) {
  switch (d) {
    case 8: return (int)launch<T, 8>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, stream);
    case 16: return (int)launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, stream);
    case 32: return (int)launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, stream);
    case 64: return (int)launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, stream);
    case 128: return (int)launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, stream);
    default: return -1;  // head dim outside the compiled table
  }
}

}  // namespace

// dtype: 1 float32, 2 float16, 3 bfloat16; 64 q rows per block and 64
// k rows per step.  q, o: (B, Sq, H, D) and
// k, v: (B, Sk, Hkv, D) through the given element strides (batch, seq,
// head), D contiguous.  Returns the launch's cudaGetLastError() (0 on
// success), or -1 for a dtype or head dim the library was not built
// for.
extern "C" int flash_attention_fwd(
    int dtype, int d, const void* q, const void* k,
    const void* v, void* o, int B, int H, int Hkv, int Sq, int Sk,
    float scale, int causal, long long qb, long long qs, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, long long ob, long long os, long long oh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  switch (dtype) {
    case 1: return dispatch_d<float>(d, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, s);
    case 2: return dispatch_d<__half>(d, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, s);
    case 3: return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, st, s);
    default: return -1;
  }
}
