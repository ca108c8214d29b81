// Fused online-softmax attention on Hopper (sm_90a): f32 math on the CUDA
// cores, f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_flash_kernel (flash_attention)
// which computes, for q (BH, Sq, D) and k, v (BH, Sk, D),
//
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j] / sqrt(D)) v[b, j]
//
// with keys j > q_offset + i masked (score -1e30) when causal, and the
// softmax taken online over key tiles:
//
//   m_new = max(m, rowmax(s));  alpha = exp(m - m_new)
//   l     = alpha * l + rowsum(exp(s - m_new))
//   acc   = alpha * acc + exp(s - m_new) @ v
//   out   = acc / max(l, 1e-30)
//
// Index space.  The TPU grid (BH, Sq/bq, Sk/bk) runs the kv axis in order
// on one core and keeps m, l and acc in VMEM scratch across it.  Here one
// block owns one (bh, q tile) of ROWS = 64 or 128 rows (2*ROWS threads;
// kernels/flash_attention.py::flash_launch_dims picks ROWS from the block
// count and the card's SMs), and a loop over 64-key tiles stands in for
// the kv axis; m, l and acc stay in registers.  The q tiles run last to
// first (blockIdx.y counts down), so under the causal mask the longest
// blocks start first and the last wave is made of short ones.
//
// What bounds it.  4*Sq*Sk*D FLOP per head (about half that causal)
// against 4*Sq*D*4 bytes of q, k, v and out: at the path's shapes
// (stablelm-1.6b causal, BH 128, S 512; whisper-base, BH 32, S 1024;
// D 64) some 128 to 256 FLOP per byte, so the f32 rate of the CUDA cores
// bounds it, not the memory.  What the design does about it:
//
// * Both products are register-tiled.  A thread owns 4 query rows (rows
//   rg + RG*i of the tile, RG = ROWS/4 row groups) by 8 keys of a tile
//   (keys l + 8j, l its lane in the row group's 8 lanes) of scores, and
//   the same 4 rows by D/8 output columns (4-wide strips 4l + 32s).  q,
//   k and v are staged d-contiguous with a 4-float pad (row stride D + 4:
//   rows 4 apart in bank groups, 16-byte aligned), so each operand is
//   read with 16-byte shared loads: per 4 depth steps of q.k a thread
//   issues 4 + 8 LDS.128 for 128 FMAs, and per 4 keys of p.v 4 + 4*D/32
//   for 4*D/2 FMAs.  Eight lanes share a row: they read one q row
//   (broadcast) and 8 consecutive k rows (8 distinct bank groups).
// * The row max is reduced across the row's 8 lanes with 3 shuffles; the
//   row sum is kept per lane and reduced once, in the epilogue (alpha is
//   the same on the 8 lanes).  Probabilities go to a shared tile that
//   only the row's own warp reads (one __syncwarp): lane l writes its 8
//   probabilities as two float4 at positions 8l..8l+7 (key l + 8j at
//   8l + j), and the p.v loop reads them back as float4, 4 keys at a
//   time, with each key's v row at a constant offset.
// * k and v tiles are staged with cp.async into a ring of two slots, one
//   __syncthreads a tile: tile t + 1 is copied while tile t is computed.
//   16-byte copies where a row of d values is a multiple of 16 bytes and
//   every base is 16-byte aligned (the host's choice,
//   flash_attention.vector_staging), 4-byte copies otherwise.  bf16 is
//   loaded (8 values a 16-byte load where the rows allow it) and widened
//   to f32 as it is staged, without cp.async: its copies do not overlap.
// * D is a template constant (32, 64 or 128; a smaller d runs on the next
//   instance with zero columns), so staging and both loops divide by
//   constants only.
// * Scores are taken in the base-2 domain (scale * log2 e folded into one
//   multiply, exp2f), and the causal and ragged masks are applied only on
//   tiles that need them: the ragged last tile and the tiles that cross
//   the block's diagonal.  Tiles wholly above the diagonal are skipped.
//
// Ragged tiles.  Any Sq and Sk run (the TPU kernel's rule that they tile
// by min(128, S) is not kept): rows past Sq are computed from zeros and
// not stored, and keys past Sk score -1e30 like masked ones.  Every row
// sees key 0 in the first tile (q_offset >= 0), so its running max is a
// real score from then on and a -1e30 score adds exp2(-1e30 - m) = 0
// exactly; a skipped tile would add exactly zero the same way.
//
// Numerics: f32 FMAs, f32 softmax state; bf16 results are rounded to
// nearest once, from the f32 result.  Tensor cores (3xTF32 or bf16
// wgmma) are later work: they change what the 1e-5 f32 gate compares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BKV = 64;               // keys per tile
constexpr int TR = 4;                 // query rows per thread
constexpr int TPR = 8;                // lanes per query row
constexpr int KPT = BKV / TPR;        // keys per thread: l + 8j
constexpr int PLD = BKV + 4;          // row stride of the probability tile
constexpr int kMaxThreads = 256;      // 128 rows
constexpr int kSmemLimit = 232448;    // 227 KB, what a block may use
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

static_assert(KPT == TPR, "lane l's keys l + 8j sit at 8l + j");

struct FlashArgs {
  int sq, sk, d;
  int causal, q_offset;
  float scale2;                       // 1/sqrt(D) * log2(e)
};

// Floats of shared memory of a block of `rows` rows at head dim DP: the
// q tile, a ring of two (k, v) tile pairs, the probability tile.
__host__ __device__ constexpr int smem_floats(int rows, int dp) {
  return (rows + 4 * BKV) * (dp + 4) + rows * PLD;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (4) bytes, of which the first `bytes` are read and the rest zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float group_max(float v) {   // the row's 8 lanes
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Stage rows [r0, r0 + n) of a (total, d) row-major matrix into an n x
// (DP + 4) f32 tile; rows past `total` and columns past d are zero.  With
// VEC (rows of 16-byte multiples, 16-byte aligned): f32 one 16-byte
// cp.async per 4 floats, bf16 one 16-byte load per 8 values, widened and
// stored as two float4.  Else f32 one 4-byte cp.async per float, bf16 one
// load per value.  bf16 staging is synchronous: its copies of tile t + 1
// do not overlap tile t.
template <typename T, bool VEC, int DP>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int r0,
                                      int n, int total, int d) {
  constexpr int LD = DP + 4;
  constexpr bool F32 = std::is_same<T, float>::value;
  const unsigned tid = threadIdx.x, nt = blockDim.x;
  if constexpr (VEC && !F32) {
    constexpr unsigned C8 = DP / 8;
#pragma unroll 4
    for (unsigned e = tid; e < (unsigned)n * C8; e += nt) {
      const int r = (int)(e / C8), c = (int)(e % C8) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (r0 + r < total && c < d) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + (size_t)(r0 + r) * d + c);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 f0 = __bfloat1622float2(h[0]);
        const float2 f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]);
        const float2 f3 = __bfloat1622float2(h[3]);
        lo = make_float4(f0.x, f0.y, f1.x, f1.y);
        hi = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
      float4* out4 = reinterpret_cast<float4*>(dst + r * LD + c);
      out4[0] = lo;
      out4[1] = hi;
    }
  } else if constexpr (VEC) {
    constexpr unsigned C4 = DP / 4;
    for (unsigned e = tid; e < (unsigned)n * C4; e += nt) {
      const int r = (int)(e / C4), c = (int)(e % C4) * 4;
      const bool ok = r0 + r < total && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (unsigned e = tid; e < (unsigned)n * DP; e += nt) {
      const int r = (int)(e / DP), c = (int)(e % DP);
      const bool ok = r0 + r < total && c < d;
      if constexpr (F32) {
        cp_async4(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                  ok ? 4 : 0);
      } else {
        dst[r * LD + c] =
            ok ? __bfloat162float(src[(size_t)(r0 + r) * d + c]) : 0.f;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16(v);             // round to nearest even
}

template <typename T, bool VEC, int DP>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       FlashArgs a) {
  constexpr int LD = DP + 4;
  constexpr int NS = DP / 32;                  // 4-column strips a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int rows = blockDim.x / 2;
  const int rg_n = rows / TR;                  // row groups
  float* ring = qs + rows * LD;                // [2][k, v][BKV][LD]
  float* ps = ring + 4 * BKV * LD;             // [rows][PLD]

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * rows;
  q += bh * a.sq * a.d;
  k += bh * a.sk * a.d;
  v += bh * a.sk * a.d;
  out += bh * a.sq * a.d;

  const int lane = threadIdx.x & 31, l = lane & 7;
  const int rg = (threadIdx.x >> 5) * 4 + (lane >> 3);
  int qoff[TR], poff[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    qoff[i] = (rg + rg_n * i) * LD;
    poff[i] = (rg + rg_n * i) * PLD;
  }

  int n_tiles = (a.sk + BKV - 1) / BKV;
  if (a.causal) {                              // skip tiles above the diagonal
    const int last_q = a.q_offset + min(q0 + rows, a.sq) - 1;
    n_tiles = min(n_tiles, last_q / BKV + 1);
  }

  stage<T, VEC, DP>(qs, q, q0, rows, a.sq, a.d);
  stage<T, VEC, DP>(ring, k, 0, BKV, a.sk, a.d);
  stage<T, VEC, DP>(ring + BKV * LD, v, 0, BKV, a.sk, a.d);
  cp_async_commit();

  float m[TR], lsum[TR], o[TR][4 * NS];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NS; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();                       // tile t has landed
    __syncthreads();                           // ... for every thread, and
                                               // tile t - 1 is done with
    if (t + 1 < n_tiles) {
      float* nxt = ring + ((t + 1) & 1) * 2 * BKV * LD;
      stage<T, VEC, DP>(nxt, k, (t + 1) * BKV, BKV, a.sk, a.d);
      stage<T, VEC, DP>(nxt + BKV * LD, v, (t + 1) * BKV, BKV, a.sk, a.d);
      cp_async_commit();
    }
    const float* ks = ring + (t & 1) * 2 * BKV * LD;
    const float* vs = ks + BKV * LD;
    const int k0 = t * BKV;

    // scores s[i][j] = q[row i] . k[key l + 8j]
    float s[TR][KPT];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 qv[TR], kv[KPT];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + qoff[i] + c);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (l + TPR * j) * LD + c);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] *= a.scale2;
    // masks, on the ragged tile and the tiles crossing the diagonal only
    if (k0 + BKV > a.sk ||
        (a.causal && k0 + BKV - 1 > a.q_offset + q0)) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int pos = a.q_offset + q0 + rg + rg_n * i;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int key = k0 + l + TPR * j;
          if (key >= a.sk || (a.causal && key > pos)) s[i][j] = kNegInf;
        }
      }
    }

    // online softmax; probabilities to the shared tile, key l + 8j at 8l + j
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        psum += s[i][j];
      }
      lsum[i] = alpha * lsum[i] + psum;
#pragma unroll
      for (int c = 0; c < 4 * NS; ++c) o[i][c] *= alpha;
      float4* pr = reinterpret_cast<float4*>(ps + poff[i] + TPR * l);
      pr[0] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      pr[1] = make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncwarp();                              // the row's lanes wrote ps

    // o[i][4s + c] += sum over keys p[i][key] * v[key][4l + 32s + c]
#pragma unroll
    for (int src = 0; src < TPR; ++src) {      // lane src's keys
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // keys src + 8(4h + u)
        float4 pv[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + poff[i] + TPR * src
                                                   + 4 * h);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = vs + (src + TPR * (4 * h + u)) * LD + 4 * l;
          float4 vv[NS];
#pragma unroll
          for (int sn = 0; sn < NS; ++sn)
            vv[sn] = *reinterpret_cast<const float4*>(vr + 32 * sn);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = lane_of(pv[i], u);
#pragma unroll
            for (int sn = 0; sn < NS; ++sn) {
              o[i][4 * sn + 0] = fmaf(p, vv[sn].x, o[i][4 * sn + 0]);
              o[i][4 * sn + 1] = fmaf(p, vv[sn].y, o[i][4 * sn + 1]);
              o[i][4 * sn + 2] = fmaf(p, vv[sn].z, o[i][4 * sn + 2]);
              o[i][4 * sn + 3] = fmaf(p, vv[sn].w, o[i][4 * sn + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const float l_row = group_sum(lsum[i]);
    const int row = q0 + rg + rg_n * i;
    if (row >= a.sq) continue;
    const float inv = 1.f / fmaxf(l_row, 1e-30f);
    T* orow = out + (size_t)row * a.d;
#pragma unroll
    for (int sn = 0; sn < NS; ++sn) {
      const int c0 = 4 * l + 32 * sn;
      if constexpr (VEC) {                     // d % 4 == 0: all 4 or none
        if (c0 >= a.d) continue;
        const float y0 = o[i][4 * sn] * inv, y1 = o[i][4 * sn + 1] * inv;
        const float y2 = o[i][4 * sn + 2] * inv, y3 = o[i][4 * sn + 3] * inv;
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float4*>(orow + c0) = make_float4(y0, y1, y2, y3);
        } else {                               // round to nearest even
          const __nv_bfloat162 lo = __floats2bfloat162_rn(y0, y1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(y2, y3);
          uint2 u;
          u.x = *reinterpret_cast<const unsigned*>(&lo);
          u.y = *reinterpret_cast<const unsigned*>(&hi);
          *reinterpret_cast<uint2*>(orow + c0) = u;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < a.d) orow[c0 + c] = from_f32<T>(o[i][4 * sn + c] * inv);
      }
    }
  }
}

template <typename T, bool VEC, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int rows, const FlashArgs& a, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats(rows, DP);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, VEC, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, (a.sq + rows - 1) / rows);
  flash_attention_kernel<T, VEC, DP><<<grid, 2 * rows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int rows, const FlashArgs& a, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, VEC, 32>(q, k, v, out, bh, rows, a, stream);
  if (a.d <= 64) return launch<T, VEC, 64>(q, k, v, out, bh, rows, a, stream);
  return launch<T, VEC, 128>(q, k, v, out, bh, rows, a, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  q, out (bh, sq, d), k, v (bh, sk, d),
// contiguous, all f32 (bf16 = 0) or all bf16 (bf16 = 1); 1 <= d <= 128,
// q_offset >= 0, rows 64 or 128.  vec = 1 takes the 16-byte staging
// instance (rows of d values a multiple of 16 bytes, 16-byte aligned
// bases).  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take: a refused launch never runs, and only this
// return value reports it.
// ---------------------------------------------------------------------------
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bh, int sq,
                                   int sk, int d, int causal, int q_offset,
                                   float scale, int rows, int bf16, int vec,
                                   void* stream) {
  if (d < 1 || d > 128 || bh < 1 || sq < 1 || sk < 1 || q_offset < 0 ||
      (rows != 64 && rows != 128) || (sq + rows - 1) / rows > 65535 ||
      (vec && d % (bf16 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{sq, sk, d, causal, q_offset, scale * kLog2e};
  const cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (bf16)
    return vec ? launch_d<bf, true>(q, k, v, out, bh, rows, a, s)
               : launch_d<bf, false>(q, k, v, out, bh, rows, a, s);
  return vec ? launch_d<float, true>(q, k, v, out, bh, rows, a, s)
             : launch_d<float, false>(q, k, v, out, bh, rows, a, s);
}
