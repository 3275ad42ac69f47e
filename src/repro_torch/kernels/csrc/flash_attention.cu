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
// written in place through their strides (any (B, S, H, D) layout whose
// last axis is contiguous, whose bases are 16-byte aligned and whose
// batch, seq and head strides are whole 16-byte chunks: the wrapper
// stages any other operand into a contiguous copy first); ragged rows
// read as zeros and are masked.  GQA maps head h to kv head
// h / (H / Hkv).  Both paths load through 16-byte zero-filling cp.async
// copies and balance the causal work (a q-block near the end of the
// sequence needs every key, one near the start almost none).  Scores are
// kept in log2 units (scale * log2(e) folded in) and exponentiated with
// exp2; the masked value stays finite (-1e30 * log2(e)).
//
// What bounds it: at the serving path's prefill (B*H = 16, S = 1024,
// D = 128, causal) the work is ~4.3 GFLOP against ~16 MB moved, so it is
// bound by operations: the tensor cores' for bf16/f16, the CUDA cores'
// FP32 FMAs for f32.  The wrapper picks the path by dtype alone and
// passes it here (Path):
//
// * mma  - f16/bf16.  Each warp owns 16 q rows; both products are
//   mma.sync.m16n8k16 with f32 accumulators, fed by ldmatrix from
//   shared-memory tiles kept in the input type (q once, K and V through
//   a two-stage cp.async ring).  The score accumulator fragment is the A
//   fragment of the PV product, so P never goes to shared memory.
//   P is carried as two terms of the input type, p_hi (bf16: p with its
//   low 16 bits cut; f16: rn(p)) and p_lo = rn(p - p_hi), and PV is two
//   MMAs on the same V fragment: rounding P once to bf16 (the FA-2/3
//   practice) reads ~2e-3 normwise at the prefill shape, above the 1e-3
//   check this port holds bf16 to; the two terms keep ~16 bits of P
//   (~1e-4) for 1.5x the tensor work of the function's 4*D flops per
//   (q, k) pair.  exp2 is ex2.approx.ftz.  Blocks take the heaviest
//   causal q-blocks first, and in a grid of one wave an SM's second
//   block is a light one (heavy/light pairs).
// * simt - f32 alone (never TF32 or 3xTF32: the reference holds f32 to
//   2e-5), both products as IEEE FP32 FMAs on the CUDA cores.  An SM
//   issues 128 FMAs a clock and its shared memory delivers 128 B a clock
//   to the lanes (whether or not they read the same word), so each
//   thread keeps register tiles of both products, 4 x 4 scores and 8 x 8
//   outputs at D = 128, and reads q, k, p and v as 16-byte LDS.128: half
//   a float a FMA in q k^T, a quarter in p v.  q loads once; K and V
//   come through a two-stage cp.async ring with one barrier a k-step.
//   Two 64 x 32 blocks of 4 warps fit an SM (110,592 B each at D = 128).
//   Blocks take the heaviest causal q-tiles first; a causal grid too
//   small to balance that way (the prefill's 256 tiles against 264
//   slots) splits each tile's keys over two blocks, combined by the
//   second to finish, so that no block is left walking a q-tile's whole
//   key range alone at the end (the time of a k-step hardly falls when
//   an SM holds fewer warps: it is the chain of k-steps that sets the
//   end).
//
// Left for later: wgmma with TMA, warp specialisation and a persistent
// grid for the mma path.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see kernels/build.py); bound by ctypes.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

// the paths (kernels/flash_attention.py PATH_CODES)
enum Path { kPathSimt = 0, kPathMma = 1 };

// what the library compiles: head dims (80 is Zamba2's shared attention
// block: 5 k16 steps of q k^T and 10 n8 output tiles on mma, rows of
// whole 16-byte chunks in both paths), and the (BQ, BK) block of each
// path (kernels/flash_attention.py HEAD_DIMS and BLOCKS).  simt: f32
// only, kSimtThreads threads; mma: 16-bit only, 4 warps of 16 q rows
// (8 warps, BQ 128, were no faster on an H100: PERF.md)
#define FLASH_HEAD_DIMS(X) X(8) X(16) X(32) X(64) X(80) X(128)
#define FLASH_SIMT_BLOCKS(X) X(64, 32)
#define FLASH_MMA_BLOCKS(X) X(64, 64)

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemPerSm = 233472;  // shared memory of one SM (228 KB)
constexpr int kSmemPerBlock = 1024;  // of which the system takes per block

// element strides of q, k, v, o viewed as (B, S, H, D), D contiguous
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

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

// ------------------------------------------------------------ simt path
constexpr int kSimtThreads = 128;  // 4 warps of BQ / 4 q rows

// Shared memory of one simt block, in floats: the q tile and two stages
// of K, rows skewed by 4 floats (16 B, so the 4 or 8 rows one LDS.128
// reads fall on distinct banks), two stages of V, and the probability
// tile, rows skewed by 8 floats (a warp's scalar stores of 4 rows x 8
// columns fall on distinct banks).
template <int D, int BQ, int BK>
constexpr size_t simt_smem_floats() {
  return (size_t)(BQ + 2 * BK) * (D + 4) + (size_t)2 * BK * D +
         (size_t)BQ * (BK + 8);
}
// two blocks an SM where their shared memory allows
template <int D, int BQ, int BK>
constexpr int simt_blocks_per_sm() {
  return 2 * (simt_smem_floats<D, BQ, BK>() * 4 + kSmemPerBlock) <= kSmemPerSm
             ? 2 : 1;
}

// 4 floats of shared or global memory as one 16-byte access
__device__ __forceinline__ void ld4(float* r, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}
__device__ __forceinline__ void st4(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// One block: one unit of work, launch position blockIdx.x.  A unit is
// the q-tile of BQ rows (batch*head bh, q-block qb) over a range of its
// k-blocks; units run heaviest first (q-block major, descending, heads
// inner).  Without a workspace a unit is a whole tile.  With one (causal
// grids too small to balance by order alone) every tile is two adjacent
// units, each over half of the tile's k-blocks, so no unit is a serial
// chain much longer than the average (a q-tile near the end of a causal
// sequence needs every key, one near the start almost none; three or
// four parts were slower on an H100: PERF.md).  Each writes its
// unnormalised rows and their max and sum to ws[unit]; the second to
// finish (counts[tile]) combines the two and writes o.
// Warp w owns rows w * RW .. +RW-1 of the tile, so a row's max and sum
// never leave the warp and P goes to shared memory only to be read back
// by the warp that wrote it.  In q k^T and the softmax lane (ty, tx) =
// (lane / 8, lane % 8) owns rows ty + 4 i (i < TM) of those and score
// columns tx + 8 j (j < TN): 4 x 4 scores, the 8 lanes of a row reading
// one q float4 and the 4 lanes of a column one k float4.  In p v lane
// (py, px) = (lane / LC, lane % LC) owns rows py + LR i (i < TP) and
// output columns 4 px + 4 LC g + e (g < GP, e < 4): 8 x 8 sums at
// D = 128, whose rows' rescale factors, maxima and sums come through Cs,
// Ms and Ls.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kSimtThreads,
                                  simt_blocks_per_sm<D, BQ, BK>())
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int BH, int H, int group, int Sq, int Sk, float scale,
                  int causal, Strides st, float* __restrict__ ws,
                  int* __restrict__ counts) {
  constexpr int NW = kSimtThreads / 32;
  constexpr int RW = BQ / NW;               // q rows a warp owns
  constexpr int TM = RW / 4;                // q rows a thread owns
  constexpr int TN = BK / 8;                // score columns a thread owns
  // p v: lanes across columns, the most (up to 16) that split the row's
  // D / 4 float4s evenly: 16 at D = 64 and 128, 4 at D = 80 (20 float4s)
  constexpr int LC = (D / 4) % 16 == 0 ? 16 : (D / 4) % 8 == 0 ? 8
                     : (D / 4) % 4 == 0 ? 4 : 2;
  constexpr int LR = 32 / LC;               // p v: lanes across rows
  constexpr int TP = RW / LR;               // p v: rows a thread owns
  constexpr int GP = D / (4 * LC);          // p v: its float4s of columns
  constexpr int LDQ = D + 4;                // q and k rows, skewed
  constexpr int LDP = BK + 8;               // p rows, skewed
  constexpr int CH = D / 4;                 // 16-byte chunks of a row
  static_assert(RW % 4 == 0 && BK % 8 == 0 && D % 8 == 0 &&
                    D % (4 * LC) == 0 && RW % LR == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;                       // [2][BK][LDQ]
  float* Vs = Ks + 2 * BK * LDQ;                   // [2][BK][D]
  float* Ps = Vs + 2 * BK * D;                     // [BQ][LDP]
  __shared__ float Cs[BQ], Ls[BQ], Ms[BQ];  // rows' rescale, sum, max
  __shared__ int last;  // whether this unit combines its tile's two

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int py = lane / LC, px = lane % LC;
  const int split = ws != nullptr;
  const int unit = blockIdx.x;
  const int tile = unit >> split;  // heaviest first
  const int bh = tile % BH;
  const int q0 = ((Sq + BQ - 1) / BQ - 1 - tile / BH) * BQ;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;
  float* op = o + b * st.ob + h * st.oh;
  const int r0 = warp * RW + ty;  // this thread's rows: r0 + 4 i
  const int p0 = warp * RW + py;  // ... and in p v: p0 + LR i

  // causal: k-blocks wholly above the last valid q row are skipped; a
  // split tile's first unit takes the first half of the rest
  int kb_end = (Sk + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (min(q0 + BQ, Sq) - 1) / BK + 1);
  int kb_begin = 0;
  if (split) {
    const int mid = (kb_end + 1) / 2;
    if (unit & 1) kb_begin = mid; else kb_end = mid;
  }

  for (int c = tid; c < BQ * CH; c += kSimtThreads) {
    const int r = c / CH, cc = c % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(Qs + r * LDQ + cc * 4,
               ok ? qp + (int64_t)(q0 + r) * st.qs + cc * 4 : qp, ok);
  }
  auto load_kv = [&](int stage, int kb) {
    float* kd = Ks + stage * BK * LDQ;
    float* vd = Vs + stage * BK * D;
    const int k0 = kb * BK;
    for (int c = tid; c < BK * CH; c += kSimtThreads) {
      const int r = c / CH, cc = c % CH;
      const bool ok = k0 + r < Sk;
      cp_async16(kd + r * LDQ + cc * 4,
                 ok ? kp + (int64_t)(k0 + r) * st.ks + cc * 4 : kp, ok);
      cp_async16(vd + r * D + cc * 4,
                 ok ? vp + (int64_t)(k0 + r) * st.vs + cc * 4 : vp, ok);
    }
  };
  if (kb_begin < kb_end) load_kv(0, kb_begin);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const float masked = kNegInf * kLog2e;
  float acc[TP][4 * GP];
  float m[TM], l[TM];  // l: this lane's share of the row's sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = masked;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int c = 0; c < 4 * GP; ++c) acc[i][c] = 0.0f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int stage = (kb - kb_begin) & 1;
    const int k0 = kb * BK;
    cp_async_wait<0>();  // this thread's copies of stage kb (and q) landed
    __syncthreads();     // ... every thread's; every warp is done with kb - 1
    if (kb + 1 < kb_end) load_kv(stage ^ 1, kb + 1);
    cp_async_commit();
    const float* Kt = Ks + stage * BK * LDQ;
    const float* Vt = Vs + stage * BK * D;

    // s = q k^T over d, 4 at a time
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float qa[TM][4], kr[TN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld4(qa[i], Qs + (r0 + 4 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < TN; ++j) ld4(kr[j], Kt + (tx + 8 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qa[i][e], kr[j][e], s[i][j]);
    }

    // scale (log2 units), mask, online softmax over the row's 8 lanes;
    // p goes to this warp's rows of Ps
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + r0 + 4 * i;
      float mx = masked;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool keep = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = keep ? s[i][j] * sl2 : masked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.0f;
      float* prow = Ps + (r0 + 4 * i) * LDP + tx;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rs += p;
        prow[8 * j] = p;
      }
      l[i] = l[i] * corr + rs;
      if (tx == 0) Cs[r0 + 4 * i] = corr;
    }
    __syncwarp();  // the warp's p rows and rescale factors are written

    // acc = acc * corr + p v, keys 4 at a time
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const float corr = Cs[p0 + LR * i];
#pragma unroll
      for (int c = 0; c < 4 * GP; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK; j += 4) {
      float p[TP][4];
#pragma unroll
      for (int i = 0; i < TP; ++i) ld4(p[i], Ps + (p0 + LR * i) * LDP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[4 * GP];
#pragma unroll
        for (int g = 0; g < GP; ++g)
          ld4(vv + 4 * g, Vt + (j + e) * D + 4 * px + 4 * LC * g);
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int c = 0; c < 4 * GP; ++c)
            acc[i][c] = fmaf(p[i][e], vv[c], acc[i][c]);
      }
    }
  }

  // each row's max and sum, into p v's layout
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    if (tx == 0) {
      Ms[r0 + 4 * i] = m[i];
      Ls[r0 + 4 * i] = l[i];
    }
  }
  __syncwarp();
  float mp[TP], lp[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    mp[i] = Ms[p0 + LR * i];
    lp[i] = Ls[p0 + LR * i];
  }

  if (split) {
    // this unit's rows: acc [BQ][D], then m [BQ] and l [BQ]
    constexpr int UNIT = BQ * (D + 2);
    float* mine = ws + (int64_t)unit * UNIT;
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const int r = p0 + LR * i;
#pragma unroll
      for (int g = 0; g < GP; ++g)
        st4(mine + r * D + 4 * px + 4 * LC * g, acc[i] + 4 * g);
      if (px == 0) {
        mine[BQ * D + r] = mp[i];
        mine[BQ * D + BQ + r] = lp[i];
      }
    }
    __threadfence();  // these writes before the count
    __syncthreads();
    if (tid == 0) last = atomicAdd(counts + tile, 1);
    __syncthreads();
    if (!last) return;  // the other unit combines
    if (tid == 0) counts[tile] = 0;  // ready for the next launch
    __threadfence();
    // rescale both to their joint max and add the other's (read from L2)
    const float* other = ws + (int64_t)(unit ^ 1) * UNIT;
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const int r = p0 + LR * i;
      const float m2 = __ldcg(other + BQ * D + r);
      const float l2 = __ldcg(other + BQ * D + BQ + r);
      const float m_new = fmaxf(mp[i], m2);
      const float c1 = exp2f(mp[i] - m_new), c2 = exp2f(m2 - m_new);
      lp[i] = lp[i] * c1 + l2 * c2;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            other + r * D + 4 * px + 4 * LC * g));
        float* a = acc[i] + 4 * g;
        a[0] = a[0] * c1 + x.x * c2;
        a[1] = a[1] * c1 + x.y * c2;
        a[2] = a[2] * c1 + x.z * c2;
        a[3] = a[3] * c1 + x.w * c2;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int row = q0 + p0 + LR * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(lp[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 4 * GP; ++c) acc[i][c] /= denom;
    float* orow = op + (int64_t)row * st.os + 4 * px;
#pragma unroll
    for (int g = 0; g < GP; ++g) st4(orow + 4 * LC * g, acc[i] + 4 * g);
  }
}

// ------------------------------------------------------------- mma path
// The (batch*head, first q row) of this block's tile.  Launch positions
// map to ranks in heaviest-first order (q-block major, descending, heads
// inner).  pair > 0: the first `pair` positions take the heaviest ranks
// and the rest the lightest upwards, so the second block an SM takes in
// a one-wave grid is a light one.
__device__ __forceinline__ int2 causal_tile(int pair, int bq) {
  const long long n_tiles = (long long)gridDim.x * gridDim.y;
  const long long pos = blockIdx.x + (long long)blockIdx.y * gridDim.x;
  const long long rank =
      (pair > 0 && pos >= pair) ? n_tiles - 1 - (pos - pair) : pos;
  return make_int2((int)(rank % gridDim.y),
                   (int)(gridDim.x - 1 - rank / gridDim.y) * bq);
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

// One block: q rows [q0, q0 + BQ) of one (batch, head), the tile
// causal_tile names.  Warp w owns rows q0 + 16 w .. +15;
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
  const int2 tile = causal_tile(pair, BQ);
  const int bh = tile.x, q0 = tile.y;
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
  float* ws;    // simt split: per-unit partials, or null (no split)
  int* counts;  // simt split: per-tile finish counts, zeroed
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

// SMs, and the blocks of `kern` one SM holds (the cards of one process
// are taken to be alike)
template <typename Kern>
int2 card_of(Kern kern, int threads, size_t smem) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                smem);
  return make_int2(nsm, per_sm);
}

// causal_tile's pair: a causal grid of one wave that gives some SMs a
// second block pairs the heaviest tiles with the lightest
int pair_of(int2 card, dim3 grid, int causal) {
  const long long n_tiles = (long long)grid.x * grid.y;
  return (causal && n_tiles <= (long long)card.x * card.y &&
          n_tiles > card.x) ? card.x : 0;
}

template <int D, int BQ, int BK>
cudaError_t launch_simt(const Args& a) {
  constexpr size_t smem = simt_smem_floats<D, BQ, BK>() * sizeof(float);
  auto kern = flash_simt_kernel<D, BQ, BK>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // one block a unit: a tile, or half of one where split
  const long long units = (long long)a.B * a.H * ((a.Sq + BQ - 1) / BQ)
                          << (a.ws != nullptr);
  if (units > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)units, kSimtThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.B * a.H,
      a.H, a.H / a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.st, a.ws,
      a.counts);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<D, BQ, BK>();
  auto kern = flash_mma_kernel<T, D, BQ, BK>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  static const int2 card = card_of(kern, BQ * 2, smem);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, BQ * 2, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.scale, a.causal, a.st, pair_of(card, grid, a.causal));
  return cudaGetLastError();
}

template <int D>
int dispatch_simt(int bq, int bk, const Args& a) {
#define FLASH_SIMT_CASE(BQ_, BK_) \
  if (bq == BQ_ && bk == BK_) return (int)launch_simt<D, BQ_, BK_>(a);
  FLASH_SIMT_BLOCKS(FLASH_SIMT_CASE)
#undef FLASH_SIMT_CASE
  return -1;  // a block outside the path's compiled table
}

template <typename T, int D>
int dispatch_mma(int bq, int bk, const Args& a) {
#define FLASH_MMA_CASE(BQ_, BK_) \
  if (bq == BQ_ && bk == BK_) return (int)launch_mma<T, D, BQ_, BK_>(a);
  FLASH_MMA_BLOCKS(FLASH_MMA_CASE)
#undef FLASH_MMA_CASE
  return -1;  // a block outside the path's compiled table
}

// dtype: 1 float32 (simt), 2 float16, 3 bfloat16 (mma)
template <int D>
int dispatch_blocks(int dtype, int bq, int bk, const Args& a) {
  switch (dtype) {
    case 1: return dispatch_simt<D>(bq, bk, a);
    case 2: return dispatch_mma<__half, D>(bq, bk, a);
    default: return dispatch_mma<__nv_bfloat16, D>(bq, bk, a);
  }
}

int dispatch_d(int dtype, int d, int bq, int bk, const Args& a) {
#define FLASH_D_CASE(D_) \
  if (d == D_) return dispatch_blocks<D_>(dtype, bq, bk, a);
  FLASH_HEAD_DIMS(FLASH_D_CASE)
#undef FLASH_D_CASE
  return -1;  // head dim outside the compiled table
}

// what both paths' 16-byte copies read: 16-byte aligned bases and
// strides of whole 16-byte chunks, `chunk` elements (a size-1 axis's
// stride comes as 0)
bool readable(const Args& a, int chunk) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) |
                          reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) |
                          reinterpret_cast<uintptr_t>(a.o);
  const Strides& s = a.st;
  const long long strides[] = {s.qb, s.qs, s.qh, s.kb, s.ks, s.kh,
                               s.vb, s.vs, s.vh, s.ob, s.os, s.oh};
  if (bases % 16 != 0) return false;
  for (long long x : strides)
    if (x % chunk != 0) return false;
  return true;
}

}  // namespace

// path: Path (the wrapper's choice, kernels/flash_attention.py
// flash_path); dtype: 1 float32, 2 float16, 3 bfloat16; (bq, bk) the
// path's compiled block.  q, o: (B, Sq, H, D) and k, v:
// (B, Sk, Hkv, D) through the given element strides (batch, seq, head),
// D contiguous.  ws, counts: null, or (causal simt only: the wrapper's
// simt_split) 2 * B * H * ceil(Sq / bq) units of bq * (d + 2) floats and
// B * H * ceil(Sq / bq) zeroed ints, and each q-tile's keys are split
// over two blocks.  Returns the launch's cudaGetLastError() (0 on success),
// -1 for a dtype, head dim or block the library was not built for, or
// -2 for operands the path cannot read (16-bit on simt, f32 on mma, or
// operands off the 16-byte copies' alignment, which the wrapper stages).
extern "C" int flash_attention_fwd(
    int path, int dtype, int d, int bq, int bk, const void* q,
    const void* k, const void* v, void* o, void* ws, void* counts, int B,
    int H, int Hkv, int Sq,
    int Sk, float scale, int causal, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return -1;
  if (path != kPathSimt && path != kPathMma) return -1;
  if (dtype < 1 || dtype > 3) return -1;
  if ((ws == nullptr) != (counts == nullptr) ||
      (ws != nullptr && (path != kPathSimt || !causal)))
    return -1;
  const Args a{q, k, v, o, static_cast<float*>(ws),
               static_cast<int*>(counts), B, H, Hkv, Sq, Sk, scale, causal,
               Strides{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh},
               static_cast<cudaStream_t>(stream)};
  const bool f32 = dtype == 1;
  if ((path == kPathSimt) != f32 || !readable(a, f32 ? 4 : 8)) return -2;
  return dispatch_d(dtype, d, bq, bk, a);
}
