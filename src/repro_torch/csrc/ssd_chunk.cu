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
// O(n_chunks) recurrence between chunks (models/ssm.py).
//
// Index space.  The TPU kernel gives one grid step a whole (batch, chunk)
// and holds the (L, L, H) decay tensor in VMEM: 6.3 MB at mamba2-130m's
// L = 256, H = 24, far past a Hopper block's 227 KB.  Here one block owns
// one (batch * chunk, head) and a 64-row tile of queries, like the flash
// attention kernel: blockIdx = (query tile, head, batch * chunk).  A loop
// over the key tiles j <= i stands in for the (L, L) matrix.  Each block
// first computes the chunk's cumulative sum cs (one warp, a shuffle scan)
// and dt into shared memory; exp(cs_i - cs_j) is recomputed from them per
// (query, key) pair and never stored.  One more block per (chunk, head),
// blockIdx.x == the number of query tiles, computes the state S, P x N,
// in 64 x 64 output tiles; so one launch writes both outputs.
//
// Per key tile the block stages B (transposed) and dt * x in shared
// memory, computes the 64 x 64 scores C_i . B_j as 4 x 4 register tiles
// per thread, masks and decays them into shared memory, then adds the
// scores times dt * x into its y accumulators (4 rows x P/16 columns a
// thread).  The mask is a select taken before the exponential: for j > i,
// cs_i - cs_j is positive and exp can overflow, and inf * 0 would be NaN.
//
// Groups.  B and C are read as (B, S, G, N) and head h reads group
// h / (H / G), which is exactly the TPU kernel's pre-repeated (B, S, H, N)
// input (G == H is that signature) without writing the repeat.
//
// Types.  x, dt, B and C are f32 or bf16 (the serving path passes bf16),
// a_log is f32; the math is f32; y is written in x's type and the states
// in f32.  Every operand has a unit last stride; the others are passed,
// so the model's views of its projection are read in place.
//
// What bounds it.  Per (chunk, head), L^2 (N + P) useful FLOPs over the
// lower triangle plus 2 L P N for the state: at mamba2-130m's prefill
// (B 4, S 2048, H 24, P 64, N 128, L 256) some 12.9 GFLOP against 80 MB
// of operands, so the f32 rate of the CUDA cores bounds it, not memory.
// Tensor cores (wgmma, bf16 products) and TMA staging are later work.

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

namespace {

constexpr int T = 64;                 // query rows and keys per tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int LD = T + 1;             // row of a transposed tile; +1 spreads banks
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// PK = columns of y a thread holds, >= ceil(P / 16).
template <typename Tin, int PK>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ dt,
                 const float* __restrict__ a_log, const Tin* __restrict__ bm,
                 const Tin* __restrict__ cm, Tin* __restrict__ y,
                 float* __restrict__ states, SsdArgs a) {
  extern __shared__ float smem[];
  const int L = a.chunk, N = a.d_state, P = a.head_dim, H = a.heads;
  const int nc = a.seq / L;
  const int n_qt = (L + T - 1) / T;
  const int h = blockIdx.y;
  const int bb = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int g = h / (H / a.groups);
  const long long s0 = (long long)ci * L;          // the chunk's first token

  const Tin* xp = x + bb * a.x_b + s0 * a.x_s + h * a.x_h;
  const Tin* dtp = dt + bb * a.dt_b + s0 * a.dt_s + h;
  const Tin* bp = bm + bb * a.b_b + s0 * a.b_s + g * a.b_g;
  const Tin* cp = cm + bb * a.c_b + s0 * a.c_s + g * a.c_g;

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
    Tin* yr = y + (((long long)bb * a.seq + s0 + i) * H + h) * P;
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const int p = tx + 16 * k;
      if (p < P) put(yr + p, acc[r][k]);
    }
  }
}

template <typename Tin, int PK>
int launch(const void* x, const void* dt, const float* a_log, const void* b,
           const void* c, void* y, float* states, const SsdArgs& a,
           void* stream) {
  const int L = a.chunk, N = a.d_state, P = a.head_dim;
  const long long intra = 2LL * N * LD + (long long)T * P + (long long)T * LD;
  const long long state = 2LL * T * 64;
  const long long smem =
      (long long)sizeof(float) * (2LL * L + (intra > state ? intra : state));
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = ssd_chunk_kernel<Tin, PK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + T - 1) / T + 1, a.heads, a.batch * (a.seq / L));
  kern<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const Tin*)x, (const Tin*)dt, a_log, (const Tin*)b, (const Tin*)c,
      (Tin*)y, states, a);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch(const void* x, const void* dt, const float* a_log, const void* b,
             const void* c, void* y, float* states, const SsdArgs& a,
             void* stream) {
  const int pk = (a.head_dim + 15) / 16;
  if (pk <= 1) return launch<Tin, 1>(x, dt, a_log, b, c, y, states, a, stream);
  if (pk <= 2) return launch<Tin, 2>(x, dt, a_log, b, c, y, states, a, stream);
  if (pk <= 4) return launch<Tin, 4>(x, dt, a_log, b, c, y, states, a, stream);
  return launch<Tin, 8>(x, dt, a_log, b, c, y, states, a, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  x (batch, seq, heads, head_dim), dt
// (batch, seq, heads), B and C (batch, seq, groups, d_state), all of one
// type (bf16 when `bf16` is 1, else f32) with unit last stride and the
// strides in `a`; a_log (heads,) f32.  Writes y (batch, seq, heads,
// head_dim) contiguous in the input type and states (batch, seq / chunk,
// heads, head_dim, d_state) contiguous f32.  seq % chunk == 0, heads %
// groups == 0, head_dim <= 128.  Launches on `stream` and returns
// cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const float* a_log,
                             const void* b, const void* c, void* y,
                             float* states, const SsdArgs* a, int bf16,
                             void* stream) {
  if (a->chunk < 1 || a->seq % a->chunk || a->groups < 1 ||
      a->heads % a->groups || a->head_dim < 1 || a->head_dim > 128 ||
      a->d_state < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(x, dt, a_log, b, c, y, states, *a, stream);
  return dispatch<float>(x, dt, a_log, b, c, y, states, *a, stream);
}
