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
// one block owns one (batch*head, q-block) and walks the k-blocks itself,
// with m, l and the accumulator in registers.  q, k, v and o are read and
// written in place through their strides (any (B, S, H, D) layout with a
// contiguous last axis): no transpose and no pad copy; ragged rows read
// as zeros and are masked.  GQA maps head h to kv head h / (H / Hkv).
//
// What bounds it: at the serving path's prefill (B*H = 16, S = 1024,
// D = 128, causal) the work is ~4.3 GFLOP against ~16 MB moved, so it is
// bound by operations, and for bf16/f16 the card's operations are in its
// tensor cores.  The wrapper picks one of two paths by dtype and
// alignment alone and passes it here (Path):
//
// * mma  - f16/bf16 with 16-byte aligned bases and batch/seq/head strides
//   that are multiples of 8 elements (what 16-byte cp.async reads).  Each
//   warp owns 16 q rows; both products are mma.sync.m16n8k16 with f32
//   accumulators, fed by ldmatrix from shared-memory tiles kept in the
//   input type (q once, K and V through a two-stage cp.async ring of
//   zero-filling copies).  The score accumulator fragment is the A
//   fragment of the PV product, so P never goes to shared memory.
//   P is carried as two terms of the input type, p_hi (bf16: p with its
//   low 16 bits cut; f16: rn(p)) and p_lo = rn(p - p_hi), and PV is two
//   MMAs on the same V fragment: rounding P once to bf16 (the FA-2/3
//   practice) reads ~2e-3 normwise at the prefill shape, above the 1e-3
//   check this port holds bf16 to; the two terms keep ~16 bits of P
//   (~1e-4) for 1.5x the tensor work of the function's 4*D flops per
//   (q, k) pair.  exp2 with scale*log2(e)
//   folded in; the masked value stays finite (-1e30 * log2(e)).  Blocks
//   take the heaviest causal q-blocks first, and in a grid of one wave
//   an SM's second block is a light one (heavy/light pairs).
// * simt - f32 (never TF32: the reference holds f32 to 2e-5) and 16-bit
//   operands the mma path cannot read: both products as FMAs on the CUDA
//   cores, a TM x TN register tile per thread, tiles staged in f32.
//
// Left for later: wgmma with TMA, warp specialisation and a persistent
// grid for the mma path; the simt path stays the f32 path.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// the paths (kernels/flash_attention.py PATH_CODES)
enum Path { kPathSimt = 0, kPathMma = 1 };

// what the library compiles: head dims, and the (BQ, BK) block of each
// path (kernels/flash_attention.py HEAD_DIMS and BLOCKS).  mma: 4 warps
// of 16 q rows; 8 warps (BQ 128) were no faster on an H100 (PERF.md)
#define FLASH_HEAD_DIMS(X) X(8) X(16) X(32) X(64) X(128)
#define FLASH_SIMT_BLOCKS(X) X(64, 64)
#define FLASH_MMA_BLOCKS(X) X(64, 64)

namespace {

constexpr int kThreads = 256;      // simt: 16 x 16 threads per block
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

template <int D, int BK, int BQ>
constexpr size_t smem_floats() {
  return (size_t)D * (BQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)BK * (BQ + 1);
}

// One block: q rows [blockIdx.x * BQ, +BQ) of (batch, head) blockIdx.y.
// Thread (tr, tc) = (tid / 16, tid % 16) owns q rows tr + 16 i (i < TM):
// score columns tc + 16 j (j < TN) and output columns tc + 16 t (t < TD,
// those below D: at D = 8 half the threads hold no output column), so a
// row's max and sum reduce over the 16 lanes of one half-warp.
template <typename T, int D, int BK, int BQ>
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

// ------------------------------------------------------------- mma path
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// the input type's m16n8k16 (f32 accumulators), packing and P split
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (x, y) -> one word, x in the low half (the lower column)
  static __device__ __forceinline__ uint32_t pack(float x, float y,
                                                  float2* back) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    if (back) *back = __bfloat1622float2(h);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y,
                                                  float2* back) {
    __half2 h = __floats2half2_rn(x, y);
    if (back) *back = __half22float2(h);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// (x, y) -> hi = rn(x, y), lo = rn((x, y) - hi) in the input type
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  float2 h;
  hi = Mma<T>::pack(x, y, &h);
  lo = Mma<T>::pack(x - h.x, y - h.y, nullptr);
}
// bf16: hi is p with its low 16 bits cut (one byte permute, not a
// convert); lo = rn(p - hi) then carries the next 8 bits, so p keeps ~16
template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x, float y,
                                                      uint32_t& hi,
                                                      uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = Mma<__nv_bfloat16>::pack(x - __uint_as_float(xb & 0xffff0000u),
                                y - __uint_as_float(yb & 0xffff0000u),
                                nullptr);
}

// 2^x; results below f32's normal range flush to 0 (such a p adds
// nothing to a row that holds its max's p = 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one mma block, in the input type: the q tile and two
// stages each of K and V, rows of max(D, 16) elements skewed by 8 (16 B,
// so the 8 rows one ldmatrix reads fall on distinct banks).
template <int D, int BQ, int BK>
constexpr size_t mma_smem_bytes() {
  return (size_t)(BQ + 4 * BK) * ((D < 16 ? 16 : D) + 8) * 2;
}

// One block: q rows [q0, q0 + BQ) of one (batch, head), the tile its
// launch position maps to (below).  Warp w owns rows q0 + 16 w .. +15;
// lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of them,
// columns 2t, 2t + 1 of each n8 tile (the m16n8 accumulator layout).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ * 2)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int group, int Sq, int Sk, float scale, int causal,
                 Strides st, int pair) {
  constexpr int NT = BQ * 2;            // BQ / 16 warps
  constexpr int DP = D < 16 ? 16 : D;   // q k^T depth, padded to a k16
  constexpr int LD = DP + 8;            // staged row, elements
  constexpr int CH = DP / 8;            // 16-byte chunks per staged row
  constexpr int KD = DP / 16;           // k16 steps of q k^T
  constexpr int NS = BK / 8;            // n8 tiles of scores
  constexpr int ND = D / 8;             // n8 tiles of output
  static_assert(BK % 16 == 0 && BQ % 16 == 0 && D % 8 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // launch position -> rank in heaviest-first order (q-block major,
  // descending, heads inner).  pair > 0: the first `pair` positions take
  // the heaviest ranks and the rest the lightest upwards, so the second
  // block an SM takes in a one-wave grid is a light one
  const long long n_tiles = (long long)gridDim.x * gridDim.y;
  const long long pos = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  const long long rank =
      (pair > 0 && pos >= pair) ? n_tiles - 1 - (pos - pair) : pos;
  const int bh = (int)(rank % gridDim.y);
  const int q0 = (int)(gridDim.x - 1 - rank / gridDim.y) * BQ;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  // q tile; columns D..DP (D = 8) and rows past Sq read as zeros
  for (int c = tid; c < BQ * CH; c += NT) {
    const int r = c / CH, cc = c % CH;
    const bool ok = q0 + r < Sq && cc * 8 < D;
    cp_async16(Qs + r * LD + cc * 8,
               ok ? qp + (int64_t)(q0 + r) * st.qs + cc * 8 : qp, ok);
  }
  auto load_kv = [&](int stage, int kb) {
    T* kd = Ks + stage * BK * LD;
    T* vd = Vs + stage * BK * LD;
    const int k0 = kb * BK;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, cc = c % CH;
      const bool ok = k0 + r < Sk && cc * 8 < D;
      cp_async16(kd + r * LD + cc * 8,
                 ok ? kp + (int64_t)(k0 + r) * st.ks + cc * 8 : kp, ok);
      cp_async16(vd + r * LD + cc * 8,
                 ok ? vp + (int64_t)(k0 + r) * st.vs + cc * 8 : vp, ok);
    }
  };

  // causal: k-blocks wholly above the last valid q row are skipped
  int n_kb = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    n_kb = min(n_kb, q_last / BK + 1);
  }
  load_kv(0, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const float masked = kNegInf * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {masked, masked}, l[2] = {0.0f, 0.0f};

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the stage refilled next
    if (kb + 1 < n_kb) {
      load_kv((kb + 1) & 1, kb + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage kb & 1 (and at kb = 0 the q tile) landed
    if (kb == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);
    }
    const T* Kt = Ks + (kb & 1) * BK * LD;
    const T* Vt = Vs + (kb & 1) * BK * LD;

    // s = q k^T: 16 rows x BK keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];  // k fragments of key tiles j and j + 1
        ldsm_x4(bk, Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        Mma<T>::run(s[j], qf[kd], bk[0], bk[1]);
        Mma<T>::run(s[j + 1], qf[kd], bk[2], bk[3]);
      }

    // scale (log2 units), mask, online softmax over the row's 4 lanes
    const bool edge = k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q0 + warp * 16);
    float mx[2] = {masked, masked};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= Sk || (causal && kpos > qpos)) x = masked;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    // l sums the f32 p of this lane's columns; the 4 lanes of a row are
    // summed once, at the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v, p = p_hi + p_lo: score tiles 2c, 2c + 1 are the A
    // fragment of key chunk c
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t ph[4], pl[4];
      split2<T>(s[2 * c][0], s[2 * c][1], ph[0], pl[0]);
      split2<T>(s[2 * c][2], s[2 * c][3], ph[1], pl[1]);
      split2<T>(s[2 * c + 1][0], s[2 * c + 1][1], ph[2], pl[2]);
      split2<T>(s[2 * c + 1][2], s[2 * c + 1][3], ph[3], pl[3]);
      const T* vrow = Vt + (c * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n + 1 < ND; n += 2) {
        uint32_t bv[4];  // v fragments of output tiles n and n + 1
        ldsm_x4_t(bv, vrow + n * 8 + (lane >> 4) * 8);
        Mma<T>::run(acc[n], ph, bv[0], bv[1]);
        Mma<T>::run(acc[n], pl, bv[0], bv[1]);
        Mma<T>::run(acc[n + 1], ph, bv[2], bv[3]);
        Mma<T>::run(acc[n + 1], pl, bv[2], bv[3]);
      }
      if constexpr (ND % 2 == 1) {  // D = 8: one output tile
        uint32_t bv[2];
        ldsm_x2_t(bv, vrow + (ND - 1) * 8);
        Mma<T>::run(acc[ND - 1], ph, bv[0], bv[1]);
        Mma<T>::run(acc[ND - 1], pl, bv[0], bv[1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    T* orow = op + (int64_t)row * st.os + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = Mma<T>::pack(
          acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r], nullptr);
  }
}

// ------------------------------------------------------------- dispatch
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  float scale;
  int causal;
  Strides st;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_simt(const Args& a) {
  const size_t smem = smem_floats<D, BK, BQ>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D, BK, BQ>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.scale, a.causal, a.st);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<D, BQ, BK>();
  auto kern = flash_mma_kernel<T, D, BQ, BK>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // SMs and the blocks of this kernel one SM holds (read once; the cards
  // of one process are taken to be alike)
  static const int2 card = [&] {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BQ * 2,
                                                  smem);
    return make_int2(nsm, per_sm);
  }();
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  // a causal grid of one wave that gives some SMs a second block: the
  // kernel pairs the heaviest tiles with the lightest
  const long long n_tiles = (long long)grid.x * grid.y;
  const int pair = (a.causal &&
                    n_tiles <= (long long)card.x * card.y &&
                    n_tiles > card.x) ? card.x : 0;
  kern<<<grid, BQ * 2, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.scale, a.causal, a.st, pair);
  return cudaGetLastError();
}

template <typename T, int D>
int dispatch_blocks(int path, int bq, int bk, const Args& a) {
#define FLASH_SIMT_CASE(BQ_, BK_)                         \
  if (path == kPathSimt && bq == BQ_ && bk == BK_)        \
    return (int)launch_simt<T, D, BQ_, BK_>(a);
  FLASH_SIMT_BLOCKS(FLASH_SIMT_CASE)
#undef FLASH_SIMT_CASE
  if constexpr (!std::is_same<T, float>::value) {
#define FLASH_MMA_CASE(BQ_, BK_)                          \
  if (path == kPathMma && bq == BQ_ && bk == BK_)         \
    return (int)launch_mma<T, D, BQ_, BK_>(a);
    FLASH_MMA_BLOCKS(FLASH_MMA_CASE)
#undef FLASH_MMA_CASE
  }
  return -1;  // a block outside the path's compiled table
}

template <typename T>
int dispatch_d(int path, int d, int bq, int bk, const Args& a) {
#define FLASH_D_CASE(D_) \
  if (d == D_) return dispatch_blocks<T, D_>(path, bq, bk, a);
  FLASH_HEAD_DIMS(FLASH_D_CASE)
#undef FLASH_D_CASE
  return -1;  // head dim outside the compiled table
}

// what the mma path's 16-byte copies read: 16-byte aligned bases and
// strides of whole 8-element chunks (a size-1 axis's stride comes as 0)
bool mma_readable(const Args& a) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) |
                          reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) |
                          reinterpret_cast<uintptr_t>(a.o);
  const Strides& s = a.st;
  const long long strides[] = {s.qb, s.qs, s.qh, s.kb, s.ks, s.kh,
                               s.vb, s.vs, s.vh, s.ob, s.os, s.oh};
  if (bases % 16 != 0) return false;
  for (long long x : strides)
    if (x % 8 != 0) return false;
  return true;
}

}  // namespace

// path: Path (the wrapper's choice, kernels/flash_attention.py
// flash_path); dtype: 1 float32, 2 float16, 3 bfloat16; (bq, bk) the
// path's compiled block.  q, o: (B, Sq, H, D) and k, v:
// (B, Sk, Hkv, D) through the given element strides (batch, seq, head),
// D contiguous.  Returns the launch's cudaGetLastError() (0 on success),
// -1 for a dtype, head dim or block the library was not built for, or
// -2 for operands the path cannot read (f32 on mma, or mma operands off
// its 16-byte alignment).
extern "C" int flash_attention_fwd(
    int path, int dtype, int d, int bq, int bk, const void* q,
    const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
    int Sk, float scale, int causal, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  if (path != kPathSimt && path != kPathMma) return -1;
  const Args a{q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
               Strides{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh},
               static_cast<cudaStream_t>(stream)};
  if (path == kPathMma && (dtype == 1 || !mma_readable(a))) return -2;
  switch (dtype) {
    case 1: return dispatch_d<float>(path, d, bq, bk, a);
    case 2: return dispatch_d<__half>(path, d, bq, bk, a);
    case 3: return dispatch_d<__nv_bfloat16>(path, d, bq, bk, a);
    default: return -1;
  }
}
