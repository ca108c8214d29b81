// SSD intra-chunk kernel on Hopper (sm_90a): the Mamba-2 prefill hot spot.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk.py::_ssd_kernel (ssd_chunk)
// which computes, for each (batch, chunk) of L tokens and each head h,
// with cs the cumulative sum of dt * A over the chunk (A = -exp(a_log)):
//
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]
//   S[p, n] = sum_j B_j[n] exp(cs_{L-1} - cs_j) dt_j x[j, p]
//
// the chunk's masked-decay product and its final state; the host runs the
// O(n_chunks) recurrence between chunks (models/ssm.py).  B and C are
// read as (B, S, G, N) and head h reads group h / (H / G): G == H is the
// TPU kernel's pre-repeated input, G < H is read in place.  Every operand
// has a unit last stride; the other strides are passed, so the model's
// views of its projection are read in place.
//
// What bounds it.  Two facts of the function set the design of the bf16
// instance, the one that serves:
//
// * C_i . B_j does not depend on the head.  Per (chunk, group) the score
//   matrix is L^2 N / 2 multiply-adds (the causal half); per head the
//   y product is L^2 P / 2 and the state L P N.  At mamba2-130m's prefill
//   (B 4, S 2048, H 24, G 1, P 64, N 128, L 256) that is some 6.7 GFLOP
//   with C . B^T once per group, against 12.9 when every head recomputes
//   it, and about 80 MB of operands: on the bf16 tensor cores (989
//   TFLOP/s dense) the 0.024 ms the bytes take bound it, not the math.
// * One operand of every product is an exact bf16 input: C and B in the
//   scores, x in y (with dt_j moved to the other side), B in the state.
//   So every product runs on the tensor cores (mma.sync m16n8k16 bf16,
//   f32 accumulators) with no loss but the other operand's, which is f32
//   (w_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j, and x_j dt_j exp(cs_end -
//   cs_j)): it is split into hi = bf16(v) and lo = bf16(v - hi), two
//   products, hi + lo within 2^-18 of v (for the states a third term, see
//   below).  The output's own bf16 rounding (2^-9) stays the largest
//   error of y; the states are f32.
//
// Index space of the bf16 instance (256 threads, eight warps; one launch,
// a one-dimensional grid, heaviest blocks first):
//
// * A y block owns (batch * chunk, group, 128-row query tile, a slice of
//   `heads` of the group's heads; kernels/ssd_chunk.py::ssd_launch_dims
//   picks the width).  Warp w owns query rows 16w..16w+15.  Per 64-key
//   tile, for each 16-key step that holds a key <= one of its rows, it
//   computes its 16 x 16 scores C . B^T once (two n8 accumulator tiles,
//   the even and odd state steps summed apart) and applies every head of
//   the slice to them: exp(cs_i - cs_j) dt_j = exp2(c2_i + e2_j), with c2
//   = cs log2(e) and e2 = log2(dt) - c2 formed once a block, is applied
//   in f32 in the accumulator layout, which is the layout of the next
//   product's A operand; the weights are split into hi and lo and
//   multiplied by the head's x tile (ldmatrix.trans) into the head's y
//   accumulators.  The mask is a select taken after the exponential and
//   before any use of it, and only where a key can pass a row: for j > i
//   the exponent is positive and exp2 may overflow, and inf * 0 would be
//   NaN.  The decay is never factored into exp(cs_i) exp(-cs_j), which
//   overflows over a 256-token chunk.
// * A state block owns (batch * chunk, head): S = (x dt decay)^T B over
//   the chunk, in passes of 64 p rows x 128 state columns, warp w the p
//   rows 16 (w % 4) and columns 64 (w / 4); x^T comes by ldmatrix.trans,
//   is scaled per key in f32 (dt_j exp(cs_end - cs_j), expf) and split
//   in three, hi + mid + lo within 2^-27, and B (exact) is the other
//   operand.  A two-term split would put the states' error (2^-18 of
//   the sum of |terms|) at 5e-6 to 7e-6 of max|S| at the path's shape,
//   too near the 1e-5 gate; the third product costs the state blocks
//   half as many products again.
// * Blocks are ordered by their work: y blocks of the last query tile
//   first, the state blocks where their work falls among the query-tile
//   levels (`state_level`), the first query tile last.
// * B, C and x tiles are staged with cp.async (16 bytes where the host
//   found every row 16-byte aligned, else element by element): a y block
//   through a ring of two slots, one __syncthreads a tile (tile t + 1 is
//   copied while tile t computes), and so does a state block.
//   Rows are padded by 16 bytes so ldmatrix reads hit eight different
//   bank groups; every ragged edge (L not a multiple of 64, P or N not a
//   multiple of 16) is zero-filled in shared memory, never in device
//   memory.
// * The instruction is mma.sync m16n8k16 (bf16 in, f32 accumulators),
//   fed by ldmatrix: the products are small (16-row warp tiles, 16-key
//   steps cut at the causal edge) and their A operands are formed in
//   registers, which is the shape mma.sync takes as it is.  On an H100
//   the launch runs at some 7x its bound: the time goes to the staging
//   and its waits and to the chains from ldmatrix through the split to
//   the products more than to the tensor cores (PERF.md).
//
// The f32 instance (used by the f32 checks and the f32-compute prefill
// check, not by serving) keeps the first port's CUDA-core body below
// (namespace f32core), under the 1e-5 gates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors SsdArgs in kernels/ssd_chunk.py field for field.
struct SsdArgs {
  int batch, seq, heads, head_dim, groups, d_state, chunk;
  long long x_b, x_s, x_h;            // strides of x over (b, s, h)
  long long dt_b, dt_s;               // strides of dt over (b, s)
  long long b_b, b_s, b_g;            // strides of B over (b, s, g)
  long long c_b, c_s, c_g;            // strides of C over (b, s, g)
};

namespace f32core {

// The f32 instance: the first port's CUDA-core body, kept for the f32
// checks (1e-5 of max|y| and max|S|) and the f32-compute prefill check.
// One block per (query tile, head, batch * chunk), one more per (head,
// batch * chunk) for the state; every product an f32 FMA.

constexpr int T = 64;                 // query rows and keys per tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int LD = T + 1;             // row of a transposed tile; +1 spreads banks
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// PK = columns of y a thread holds, >= ceil(P / 16).
template <int PK>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ states, SsdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, N = a.d_state, P = a.head_dim, H = a.heads;
  const int nc = a.seq / L;
  const int n_qt = (L + T - 1) / T;
  const int h = blockIdx.y;
  const int bb = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int g = h / (H / a.groups);
  const long long s0 = (long long)ci * L;          // the chunk's first token

  const float* xp = x + bb * a.x_b + s0 * a.x_s + h * a.x_h;
  const float* dtp = dt + bb * a.dt_b + s0 * a.dt_s + h;
  const float* bp = bm + bb * a.b_b + s0 * a.b_s + g * a.b_g;
  const float* cp = cm + bb * a.c_b + s0 * a.c_s + g * a.c_g;

  float* cs = smem;                    // L: cumulative sum of dt * A
  float* dts = cs + L;                 // L: dt
  float* work = dts + L;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32;

  if (tid < 32) {                      // warp 0: inclusive scan, 32 at a time
    const float A = -expf(a_log[h]);
    float carry = 0.f;
    for (int base = 0; base < L; base += 32) {
      const int j = base + lane;
      const float d = j < L ? f32(dtp[j * a.dt_s]) : 0.f;
      float v = d * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      v += carry;
      if (j < L) {
        cs[j] = v;
        dts[j] = d;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  if (blockIdx.x == n_qt) {
    // ---- the chunk's final state S (P x N), 64 x 64 at a time ----------
    float* xd = work;                  // T x 64: dt x exp(cs_end - cs_j)
    float* bs = xd + T * 64;           // T x 64: B
    const float cs_end = cs[L - 1];
    float* sp = states + (((long long)bb * nc + ci) * H + h) * P * N;
    for (int p0 = 0; p0 < P; p0 += 64) {
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < L; k0 += T) {
          __syncthreads();
          for (int e = tid; e < T * 64; e += kThreads) {
            const int j = e / 64, q = e % 64, kj = k0 + j;
            xd[e] = (kj < L && p0 + q < P)
                        ? f32(xp[kj * a.x_s + p0 + q]) * dts[kj] *
                              expf(cs_end - cs[kj])
                        : 0.f;
            bs[e] = (kj < L && n0 + q < N) ? f32(bp[kj * a.b_s + n0 + q])
                                           : 0.f;
          }
          __syncthreads();
          for (int j = 0; j < T; ++j) {
            float xv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) xv[r] = xd[j * 64 + ty + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = bs[j * 64 + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + tx + 16 * c;
            if (p < P && n < N) sp[(long long)p * N + n] = acc[r][c];
          }
        }
      }
    }
    return;
  }

  // ---- y for query rows q0 .. q0 + 63 ----------------------------------
  const int q0 = blockIdx.x * T;
  float* ct = work;                    // N x LD: C of the query tile, transposed
  float* bt = ct + N * LD;             // N x LD: B of a key tile, transposed
  float* xs = bt + N * LD;             // T x P: dt * x of a key tile
  float* ss = xs + T * P;              // T x LD: masked, decayed scores

  for (int e = tid; e < T * N; e += kThreads) {
    const int i = e / N, n = e % N;
    ct[n * LD + i] = q0 + i < L ? f32(cp[(q0 + i) * a.c_s + n]) : 0.f;
  }

  float acc[4][PK] = {};
  for (int k0 = 0; k0 <= q0; k0 += T) {          // key tiles j <= i only
    __syncthreads();                   // the previous tile's reads are done
    for (int e = tid; e < T * N; e += kThreads) {
      const int j = e / N, n = e % N;
      bt[n * LD + j] = k0 + j < L ? f32(bp[(k0 + j) * a.b_s + n]) : 0.f;
    }
    for (int e = tid; e < T * P; e += kThreads) {
      const int j = e / P, p = e % P;
      xs[e] = k0 + j < L ? f32(xp[(k0 + j) * a.x_s + p]) * dts[k0 + j] : 0.f;
    }
    __syncthreads();

    float sc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ct[n * LD + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bt[n * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      const float cs_i = cs[min(i, L - 1)];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        // select, never multiply by a 0/1 mask: for j > i the exponent
        // is positive, exp may be inf, and inf * 0 is NaN
        ss[(ty + 16 * r) * LD + tx + 16 * c] =
            (j <= i && i < L) ? sc[r][c] * expf(cs_i - cs[j]) : 0.f;
      }
    }
    __syncthreads();

    for (int j = 0; j < T; ++j) {
      float sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ss[(ty + 16 * r) * LD + j];
#pragma unroll
      for (int k = 0; k < PK; ++k) {
        const int p = tx + 16 * k;
        if (p < P) {
          const float xv = xs[j * P + p];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(sv[r], xv, acc[r][k]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= L) continue;
    float* yr = y + (((long long)bb * a.seq + s0 + i) * H + h) * P;
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const int p = tx + 16 * k;
      if (p < P) put(yr + p, acc[r][k]);
    }
  }
}

template <int PK>
int launch(const void* x, const void* dt, const float* a_log, const void* b,
           const void* c, void* y, float* states, const SsdArgs& a,
           int* blocks, void* stream) {
  const int L = a.chunk, N = a.d_state, P = a.head_dim;
  const long long intra = 2LL * N * LD + (long long)T * P + (long long)T * LD;
  const long long state = 2LL * T * 64;
  const long long smem =
      (long long)sizeof(float) * (2LL * L + (intra > state ? intra : state));
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = ssd_chunk_kernel<PK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + T - 1) / T + 1, a.heads, a.batch * (a.seq / L));
  kern<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, a_log, (const float*)b,
      (const float*)c, (float*)y, states, a);
  *blocks = (int)(grid.x * grid.y * grid.z);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* dt, const float* a_log, const void* b,
             const void* c, void* y, float* states, const SsdArgs& a,
             int* blocks, void* stream) {
  const int pk = (a.head_dim + 15) / 16;
  if (pk <= 1) return launch<1>(x, dt, a_log, b, c, y, states, a, blocks,
                               stream);
  if (pk <= 2) return launch<2>(x, dt, a_log, b, c, y, states, a, blocks,
                               stream);
  if (pk <= 4) return launch<4>(x, dt, a_log, b, c, y, states, a, blocks,
                               stream);
  return launch<8>(x, dt, a_log, b, c, y, states, a, blocks, stream);
}

}  // namespace f32core


// ===========================================================================
// The bf16 instance, on the tensor cores.
// ===========================================================================
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int T = 64;            // keys of a key tile, p rows of a state pass
constexpr int TQ = 128;          // query rows of a y block
constexpr int kThreads = 256;    // eight warps
constexpr int PAD = 8;           // bf16 a staged row is padded by (16 bytes)
constexpr int NB = 128;          // state columns of one state pass
constexpr int SD = 2;            // slots of a state block's ring
constexpr int kSmemLimit = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

// Mirrors SsdLaunch in kernels/ssd_chunk.py (heads, state_level) and its
// vector_staging.
struct Layout {
  int heads;        // heads a y block applies its scores to
  int state_level;  // query-tile levels (heaviest first) before the states
  int vec;          // 16-byte cp.async staging, else element by element
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// The chunk padded to whole query tiles: the length of the per-token
// arrays in shared memory.
__host__ __device__ constexpr int padded(int chunk) {
  return (chunk + TQ - 1) / TQ * TQ;
}

// Shared-memory bytes of a block: the larger of the two roles.  A y block:
// two per-token arrays of each head, the C tile (TQ rows), a ring of two
// (B tile, `heads` x tiles).  A state block: two per-token arrays, a ring
// of SD (x tile, B tile) of one pass.
__host__ __device__ inline long long smem_bytes(int heads, int chunk, int p,
                                                int n) {
  const long long lp = padded(chunk);
  const long long np = round16(n) + PAD, pp = round16(p) + PAD;
  const long long yb = 8 * heads * lp + 2LL * TQ * np
                       + 4LL * T * (np + heads * pp);
  const long long xw = imin(round16(p), T) + PAD;
  const long long bw = imin(round16(n), NB) + PAD;
  const long long sb = 8 * lp + 2LL * SD * T * (xw + bw);
  return yb > sb ? yb : sb;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes, of which the first `bytes` are read and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (u, v) as two bf16 pairs, hi = bf16(.) and lo = bf16(. - hi): hi + lo
// is within 2^-18 of each value.  u takes the low half (the lower column).
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(u - hf.x, v - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (u, v) in three bf16 pairs, hi + mid + lo within 2^-27 of each value.
__device__ __forceinline__ void split3(float u, float v, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  const float ru = u - hf.x, rv = v - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ru, rv);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ru - mf.x, rv - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 widen(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// Rows [0, R) of a bf16 matrix (row stride ld) into shared memory at row
// pitch `pitch`, `width` columns (a multiple of 8); rows >= `rows` and
// columns >= `cols` are zero.  16-byte cp.async where `vec` (then cols %
// 8 == 0 and every row is 16-byte aligned), else element by element.
template <int R>
__device__ __forceinline__ void stage(bf16* dst, int pitch, const bf16* src,
                                      long long ld, int rows, int cols,
                                      int width, bool vec) {
  const int chunks = width / 8;
  for (int e = threadIdx.x; e < R * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    bf16* d = dst + r * pitch + c;
    const bf16* s = src + r * ld + c;
    if (vec) {
      const bool in = r < rows && c < cols;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        d[q] = (r < rows && c + q < cols) ? s[q] : __float2bfloat16(0.f);
    }
  }
}

// dt of `nh` heads (h, h + 1, ...) over the chunk into d[hh * pitch + j],
// 0 for L <= j < lp; all threads, one load each in flight.
__device__ __forceinline__ void load_dt(float* d, int pitch, const bf16* dtp,
                                        long long dt_s, int nh, int L,
                                        int lp) {
  for (int e = threadIdx.x; e < nh * lp; e += kThreads) {
    const int hh = e / lp, j = e - hh * lp;
    d[hh * pitch + j] = j < L ? __bfloat162float(dtp[j * dt_s + hh]) : 0.f;
  }
}

// One warp: cs[j] = sum_{k <= j} d_k A over the lp (a multiple of 32)
// values of d; lane l writes cs[l + 32 k].
__device__ __forceinline__ void scan(float* cs, const float* d, float A,
                                     int lp, int lane) {
  float carry = 0.f;
  for (int j = lane; j < lp; j += 32) {
    float v = d[j] * A;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    v += carry;
    cs[j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// y rows q0 .. q0 + 127 of heads h0 .. h0 + nh - 1 (nh <= HS) of one
// (batch, chunk, group).  Warp w owns rows 16w .. 16w + 15 of the tile.
// PK: n8 tiles of y a warp holds per head (>= round16(P) / 8, even).
template <int PK, int HS>
__device__ __forceinline__ void y_block(
    const bf16* __restrict__ x, const bf16* __restrict__ dt,
    const float* __restrict__ a_log, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, bf16* __restrict__ y, const SsdArgs& a,
    const Layout& lay, int bb, int ci, int g, int qt, int h0, int nh,
    char* smem) {
  const int L = a.chunk, N = a.d_state, P = a.head_dim, H = a.heads;
  const long long s0 = (long long)ci * L;
  const int lp = padded(L);
  const int NP = round16(N), PP = round16(P);
  const int np = NP + PAD, pp = PP + PAD;
  const int q0 = qt * TQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const bool vec = lay.vec;

  // per head: c2 = cs log2(e) (rows), then e2 = log2(dt) - c2 (keys; -inf
  // past L), so exp(cs_i - cs_j) dt_j = exp2(c2_i + e2_j)
  float* csd = reinterpret_cast<float*>(smem);
  bf16* ct = reinterpret_cast<bf16*>(csd + 2 * lay.heads * lp);  // TQ x np
  bf16* ring = ct + TQ * np;                    // two slots
  const int slot = T * np + lay.heads * T * pp;

  const bf16* bp = bm + bb * a.b_b + s0 * a.b_s + g * a.b_g;
  const bf16* cp = cm + bb * a.c_b + s0 * a.c_s + g * a.c_g;
  const bf16* xp = x + bb * a.x_b + s0 * a.x_s + h0 * a.x_h;

  // key tile kt: its B tile, then one x tile per head
  auto issue = [&](int kt, bf16* s) {
    const int rows = imin(T, L - kt * T);
    stage<T>(s, np, bp + kt * T * a.b_s, a.b_s, rows, N, NP, vec);
    for (int hh = 0; hh < nh; ++hh)
      stage<T>(s + T * np + hh * T * pp, pp,
               xp + hh * a.x_h + kt * T * a.x_s, a.x_s, rows, P, PP, vec);
    cp_async_commit();
  };
  stage<TQ>(ct, np, cp + q0 * a.c_s, a.c_s, imin(TQ, L - q0), N, NP, vec);
  issue(0, ring);                               // one group with C
  load_dt(csd + lp, 2 * lp, dt + bb * a.dt_b + s0 * a.dt_s + h0, a.dt_s, nh,
          L, lp);                               // dt into each e2
  __syncthreads();
  if (warp < nh) {
    float* c2 = csd + 2 * warp * lp;
    float* e2 = c2 + lp;
    scan(c2, e2, -expf(a_log[h0 + warp]), lp, lane);
    for (int j = lane; j < lp; j += 32) {       // the lane's own scan values
      const float v = c2[j] * kLog2e;
      c2[j] = v;
      e2[j] = j < L ? log2f(e2[j]) - v : -INFINITY;
    }
  }

  const int r0 = q0 + 16 * warp;                // the warp's first row
  const int i0 = r0 + gr, i1 = i0 + 8;          // this lane's two rows
  const int last = (imin(q0 + TQ, L) - 1) / T;  // the block's last key tile
  const bf16* crow = ct + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * np
                     + (lane >> 4) * 8;
  float acc[HS][PK][4] = {};

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait_all();
    __syncthreads();        // tile kt landed; tile kt - 1's reads are done
    if (kt < last) issue(kt + 1, ring + ((kt + 1) & 1) * slot);
    const int top = r0 + 15 - kt * T;          // the warp's last row, in keys
    if (r0 >= L || top < 0) continue;
    // key steps of 16 that hold a key <= one of the warp's rows; the mask
    // only where a key passes the warp's first row or a row passes L
    const int steps = imin(4, top / 16 + 1);
    const bool masked = kt * T + T - 1 > r0 || r0 + 15 >= L;
    const bf16* bt = ring + (kt & 1) * slot;
    const bf16* xt = bt + T * np;

    for (int ks = 0; ks < steps; ++ks) {
      // scores of the warp's 16 rows x keys 16 ks .. 16 ks + 15: two n8
      // tiles, the even and odd state steps summed apart
      float cb[2][4] = {}, cc[2][4] = {};
      const bf16* brow = bt + (16 * ks + (lane & 7) + (lane >> 4) * 8) * np
                         + ((lane >> 3) & 1) * 8;
      int k0 = 0;
      for (; k0 + 16 < NP; k0 += 32) {
        uint32_t af[4], b[4], af2[4], b2[4];
        ldsm_x4(af, crow + k0);
        ldsm_x4(b, brow + k0);
        ldsm_x4(af2, crow + k0 + 16);
        ldsm_x4(b2, brow + k0 + 16);
        mma(cb[0], af, b[0], b[1]);
        mma(cb[1], af, b[2], b[3]);
        mma(cc[0], af2, b2[0], b2[1]);
        mma(cc[1], af2, b2[2], b2[3]);
      }
      if (k0 < NP) {
        uint32_t af[4], b[4];
        ldsm_x4(af, crow + k0);
        ldsm_x4(b, brow + k0);
        mma(cb[0], af, b[0], b[1]);
        mma(cb[1], af, b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) cb[u][r] += cc[u][r];

#pragma unroll
      for (int hh = 0; hh < HS; ++hh) {
        if (hh >= nh) break;
        const float* c2 = csd + 2 * hh * lp;
        const float* e2 = c2 + lp;
        const float c2i0 = c2[i0], c2i1 = c2[i1];
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = kt * T + 16 * ks + 8 * u + 2 * tg;
          const float2 ej = *reinterpret_cast<const float2*>(e2 + j);
          float w0 = cb[u][0] * exp2f(c2i0 + ej.x);
          float w1 = cb[u][1] * exp2f(c2i0 + ej.y);
          float w2 = cb[u][2] * exp2f(c2i1 + ej.x);
          float w3 = cb[u][3] * exp2f(c2i1 + ej.y);
          if (masked) {     // a select: for j > i exp2 may overflow to inf
            w0 = j <= i0 && i0 < L ? w0 : 0.f;
            w1 = j + 1 <= i0 && i0 < L ? w1 : 0.f;
            w2 = j <= i1 && i1 < L ? w2 : 0.f;
            w3 = j + 1 <= i1 && i1 < L ? w3 : 0.f;
          }
          split2(w0, w1, hi[2 * u], lo[2 * u]);          // row gr
          split2(w2, w3, hi[2 * u + 1], lo[2 * u + 1]);  // row gr + 8
        }
        const bf16* xrow = xt + hh * T * pp
            + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * pp
            + (lane >> 4) * 8;
#pragma unroll
        for (int q = 0; q < PK / 2; ++q) {
          if (16 * q < PP) {
            uint32_t b[4];
            ldsm_x4_t(b, xrow + 16 * q);
            mma(acc[hh][2 * q], hi, b[0], b[1]);
            mma(acc[hh][2 * q], lo, b[0], b[1]);
            mma(acc[hh][2 * q + 1], hi, b[2], b[3]);
            mma(acc[hh][2 * q + 1], lo, b[2], b[3]);
          }
        }
      }
    }
  }

  if (r0 >= L) return;
#pragma unroll
  for (int hh = 0; hh < HS; ++hh) {
    if (hh >= nh) break;
#pragma unroll
    for (int nt = 0; nt < PK; ++nt) {
      const int p = 8 * nt + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        if (i >= L || p >= P) continue;
        bf16* yr = y + (((long long)bb * a.seq + s0 + i) * H + h0 + hh) * P
                   + p;
        const float v0 = acc[hh][nt][2 * half], v1 = acc[hh][nt][2 * half + 1];
        if (p + 1 < P && P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(v0,
                                                                         v1);
        } else {
          yr[0] = __float2bfloat16(v0);
          if (p + 1 < P) yr[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// The chunk-final state of head h of one (batch, chunk), P x N f32, in
// passes of 64 p rows x 128 state columns: warp w owns p rows 16 (w % 4)
// and state columns 64 (w / 4) .. + 63 of a pass.  Its ring has SD slots:
// SD - 1 key tiles are in flight while one computes (a ring of four did
// not shorten the launch on an H100).
__device__ __forceinline__ void state_block(
    const bf16* __restrict__ x, const bf16* __restrict__ dt,
    const float* __restrict__ a_log, const bf16* __restrict__ bm,
    float* __restrict__ states, const SsdArgs& a, const Layout& lay, int bb,
    int ci, int h, char* smem) {
  const int L = a.chunk, N = a.d_state, P = a.head_dim, H = a.heads;
  const int nc = a.seq / L;
  const long long s0 = (long long)ci * L;
  const int lp = padded(L);
  const int NP = round16(N), PP = round16(P);
  const int xw = imin(PP, T) + PAD, bw = imin(NP, NB) + PAD;
  const int g = h / (H / a.groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int wp = 16 * (warp & 3), wn = 64 * (warp >> 2);
  const bool vec = lay.vec;

  float* cs = reinterpret_cast<float*>(smem);   // lp
  float* scale = cs + lp;             // lp: dt, then dt_j exp(cs_end - cs_j)
  bf16* ring = reinterpret_cast<bf16*>(scale + lp);
  const int slot = T * (xw + bw);               // the x tile, then B
  const bf16* xp = x + bb * a.x_b + s0 * a.x_s + h * a.x_h;
  const bf16* bp = bm + bb * a.b_b + s0 * a.b_s + g * a.b_g;

  const int n_kt = (L + T - 1) / T;
  // key tile kt of pass (p0, n0) into its slot; past the last tile an
  // empty group, so that group counts stay in step
  auto issue = [&](int p0, int n0, int kt) {
    if (kt < n_kt) {
      bf16* s = ring + (kt % SD) * slot;
      const int rows = imin(T, L - kt * T);
      stage<T>(s, xw, xp + kt * T * a.x_s + p0, a.x_s, rows, P - p0,
               imin(T, PP - p0), vec);
      stage<T>(s + T * xw, bw, bp + kt * T * a.b_s + n0, a.b_s, rows,
               N - n0, imin(NB, NP - n0), vec);
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < SD - 1; ++kt)
    issue(0, 0, kt);          // the first tiles land while the decay forms
  load_dt(scale, lp, dt + bb * a.dt_b + s0 * a.dt_s + h, a.dt_s, 1, L, lp);
  __syncthreads();
  if (warp == 0) scan(cs, scale, -expf(a_log[h]), lp, lane);
  __syncthreads();
  const float cs_end = cs[L - 1];
  for (int j = threadIdx.x; j < lp; j += kThreads)
    scale[j] = j < L ? scale[j] * expf(cs_end - cs[j]) : 0.f;

  float* sp = states + (((long long)bb * nc + ci) * H + h) * P * N;
  for (int p0 = 0; p0 < PP; p0 += T) {
    for (int n0 = 0; n0 < NP; n0 += NB) {
      const int pw = imin(T, PP - p0), nw = imin(NB, NP - n0);
      if (p0 + n0 > 0) {
        __syncthreads();    // the last pass's reads of the ring are done
        for (int kt = 0; kt < SD - 1; ++kt) issue(p0, n0, kt);
      }
      const bool live = wp < pw && wn < nw;
      float acc[8][4] = {};
      for (int kt = 0; kt < n_kt; ++kt) {
        cp_async_wait<SD - 2>();            // tile kt has landed
        __syncthreads();    // (the first time: also the decay is written)
        issue(p0, n0, kt + SD - 1);         // into the slot of tile kt - 1
        if (!live) continue;
        const bf16* xt = ring + (kt % SD) * slot;
        const bf16* bt = xt + T * xw;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t r[4], hi[4], mid[4], lo[4];
          // x^T: rows p (16 of them), keys 16 ks ..: r0 (p gr, keys 2tg),
          // r1 (p gr + 8), r2 (keys + 8), r3 (both)
          ldsm_x4_t(r, xt + (16 * ks + (lane & 7) + (lane >> 4) * 8) * xw
                           + wp + ((lane >> 3) & 1) * 8);
          const int j = kt * T + 16 * ks + 2 * tg;
          const float2 s01 = *reinterpret_cast<const float2*>(scale + j);
          const float2 s89 = *reinterpret_cast<const float2*>(scale + j + 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = widen(r[q]);
            const float2 s = q < 2 ? s01 : s89;
            split3(v.x * s.x, v.y * s.y, hi[q], mid[q], lo[q]);
          }
          const bf16* brow = bt
              + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * bw + wn
              + (lane >> 4) * 8;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (wn + 16 * q < nw) {
              uint32_t b[4];
              ldsm_x4_t(b, brow + 16 * q);
              mma(acc[2 * q], lo, b[0], b[1]);
              mma(acc[2 * q], mid, b[0], b[1]);
              mma(acc[2 * q], hi, b[0], b[1]);
              mma(acc[2 * q + 1], lo, b[2], b[3]);
              mma(acc[2 * q + 1], mid, b[2], b[3]);
              mma(acc[2 * q + 1], hi, b[2], b[3]);
            }
          }
        }
      }
      if (!live) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn + 8 * nt + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + wp + gr + 8 * half;
          if (p >= P || n >= N) continue;
          float* o = sp + (long long)p * N + n;
          const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
          if (n + 1 < N && N % 2 == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (n + 1 < N) o[1] = v1;
          }
        }
      }
    }
  }
}

// One launch writes both outputs.  Block b, in launch order: the y blocks
// of the query tiles n_qt - 1 .. n_qt - state_level, then the state
// blocks (one per (batch * chunk, head)), then the y blocks of the other
// query tiles; within a query tile, (batch * chunk, group, head slice).
template <int PK, int HS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    bf16* __restrict__ y, float* __restrict__ states,
                    SsdArgs a, Layout lay) {
  extern __shared__ __align__(16) char smem[];
  const int nc = a.seq / a.chunk, n_qt = (a.chunk + TQ - 1) / TQ;
  const int rep = a.heads / a.groups;
  const int slices = (rep + lay.heads - 1) / lay.heads;
  const int per_level = a.batch * nc * a.groups * slices;
  const int n_state = a.batch * nc * a.heads;
  const int first = lay.state_level * per_level;
  int b = blockIdx.x;
  if (b >= first && b < first + n_state) {
    const int bc = (b - first) / a.heads, h = (b - first) % a.heads;
    state_block(x, dt, a_log, bm, states, a, lay, bc / nc, bc % nc, h, smem);
    return;
  }
  if (b >= first) b -= n_state;
  const int qt = n_qt - 1 - b / per_level;
  b %= per_level;
  const int sl = b % slices, g = (b / slices) % a.groups;
  const int bc = b / (slices * a.groups);
  const int h0 = g * rep + sl * lay.heads;
  y_block<PK, HS>(x, dt, a_log, bm, cm, y, a, lay, bc / nc, bc % nc, g, qt,
                  h0, imin(lay.heads, rep - sl * lay.heads), smem);
}

template <int PK, int HS>
int launch(const void* x, const void* dt, const float* a_log, const void* b,
           const void* c, void* y, float* states, const SsdArgs& a,
           const Layout& lay, int* blocks, void* stream) {
  const long long smem = smem_bytes(lay.heads, a.chunk, a.head_dim,
                                    a.d_state);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = ssd_chunk_tc_kernel<PK, HS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nc = a.seq / a.chunk, n_qt = (a.chunk + TQ - 1) / TQ;
  const int slices = (a.heads / a.groups + lay.heads - 1) / lay.heads;
  const long long n = (long long)a.batch * nc
                      * ((long long)a.groups * slices * n_qt + a.heads);
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)n, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dt, a_log, (const bf16*)b,
      (const bf16*)c, (bf16*)y, states, a, lay);
  *blocks = (int)n;
  return (int)cudaGetLastError();
}

// Instances: PK (n8 tiles of y a warp holds a head) 2, 4, 8 or 16 by
// round16(P); heads 1, 2 or 4, at most 16 / PK (<= 64 accumulators).
int dispatch(const void* x, const void* dt, const float* a_log, const void* b,
             const void* c, void* y, float* states, const SsdArgs& a,
             const Layout& lay, int* blocks, void* stream) {
  const int pk = round16(a.head_dim) / 8;
  const int hs = lay.heads;
  if (lay.state_level < 0 || lay.state_level > (a.chunk + TQ - 1) / TQ)
    return (int)cudaErrorInvalidValue;
#define SSD_TC(PK_, HS_)                                                    \
  if (pk <= PK_ && hs == HS_)                                              \
    return launch<PK_, HS_>(x, dt, a_log, b, c, y, states, a, lay, blocks, \
                            stream);
  SSD_TC(2, 1) SSD_TC(2, 2) SSD_TC(2, 4)      // the first that fits
  SSD_TC(4, 1) SSD_TC(4, 2) SSD_TC(4, 4)
  SSD_TC(8, 1) SSD_TC(8, 2)
  SSD_TC(16, 1)
#undef SSD_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  x (batch, seq, heads, head_dim), dt
// (batch, seq, heads), B and C (batch, seq, groups, d_state), all of one
// type (bf16 when `bf16` is 1, else f32) with unit last stride and the
// strides in `a`; a_log (heads,) f32.  Writes y (batch, seq, heads,
// head_dim) contiguous in the input type and states (batch, seq / chunk,
// heads, head_dim, d_state) contiguous f32.  seq % chunk == 0, heads %
// groups == 0, head_dim <= 128.  The bf16 instance takes the layout of
// kernels/ssd_chunk.py::ssd_launch_dims (`heads` a y block, the states
// after `state_level` query-tile levels) and `vec`, 16-byte staging (every
// B, C and x row 16-byte aligned, d_state and head_dim % 8 == 0); the f32
// instance ignores the three.  Reports the blocks it launched in `blocks`,
// launches on `stream` and returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const float* a_log,
                             const void* b, const void* c, void* y,
                             float* states, const SsdArgs* a, int bf16,
                             int heads, int state_level, int vec, int* blocks,
                             void* stream) {
  if (a->chunk < 1 || a->seq % a->chunk || a->groups < 1 ||
      a->heads % a->groups || a->head_dim < 1 || a->head_dim > 128 ||
      a->d_state < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    const tc::Layout lay{heads, state_level, vec};
    return tc::dispatch(x, dt, a_log, b, c, y, states, *a, lay, blocks,
                        stream);
  }
  return f32core::dispatch(x, dt, a_log, b, c, y, states, *a, blocks, stream);
}
