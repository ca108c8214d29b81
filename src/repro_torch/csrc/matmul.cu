// Tiled f32 matrix products on Hopper (sm_90a): the "matmul" executor.
//
// Replaces two Pallas TPU kernels:
//
//   tetris_matmul  <- src/repro/kernels/tetris_matmul.py::_mm_kernel
//                     (tetris_matmul: x (M, K) @ w (K, N), G = 1)
//   grouped_matmul <- src/repro/kernels/grouped_matmul.py::_gmm_kernel
//                     (grouped_matmul: x (G, M, D) @ w (G, D, F), the
//                     block-diagonal product, one group per blockIdx.z)
//
// Both entry points run one body, gemm_f32_kernel.  The TPU grid
// (⌈M/bm⌉, ⌈N/bn⌉, K/bk) carries its f32 accumulator in VMEM scratch
// across the sequential K axis; here the K axis is the loop inside the
// block and the accumulator lives in registers.  The TPU kernel clamps
// its M/N edge blocks (overlapping recompute) and shrinks bk until it
// divides K; here the ragged M, N and K edges are masked: out-of-range
// copies zero-fill shared memory and out-of-range stores are skipped.
//
// What bounds it.  At the path's shapes (whisper-base M = 4096 with
// K, N in {512, 1536, 2048}; stablelm-1.6b G = 4, M = 2048, D, F in
// {512, 1408, 1536}) a block's four products do 25.8 GFLOP (whisper) and
// 40.8 GFLOP (stablelm) against 10 to 50 MB of operands a launch: far
// above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP per
// byte), so the bound is the f32 FMA rate of the CUDA cores, and the
// design has to keep the FMA pipe fed from shared memory and hide the
// copies from device memory.
//
// What the design does about it:
//
// * A block of 256 threads computes a 128 x BN tile (BN = 128 or 64,
//   chosen per launch by the host's gemm_launch_dims so the busiest SM
//   gets the least work); each thread holds an 8 x (BN/16) tile of sums,
//   as 4-wide strips 64 rows (columns) apart, so every shared read is
//   one 16-byte LDS.128 and the threads of a warp hit distinct banks or
//   share a broadcast.  Per k step a thread does 8 x BN/16 FMAs for
//   2 + BN/64 shared loads.
// * Registers are not capped for a second resident block: the 128 x 128
//   instances take 167 and run one block an SM, as the launch rule
//   assumes (one block of 8 warps keeps an SM's FMA pipes nearly full),
//   1.9 % faster on the whisper block than capped at the 128 that two
//   blocks would need; the 128 x 64 instances take 109 and 113 and run
//   two.
// * x is staged K-contiguous, [128][BK + 4]: cp.async cannot transpose,
//   so a row's 4 k values come in one LDS.128; the 4-float pad keeps rows
//   16-byte aligned and puts rows 4 apart (two ty of one warp) on
//   different banks.  w is staged as it lies, [BK][BN].
// * Staging is asynchronous: STAGES slabs of BK along K in a ring of
//   dynamic shared memory, filled by cp.async, with one __syncthreads per
//   slab; slab k + STAGES - 1 is in flight while slab k is multiplied.
//   Two slabs of 32 (68 KB a block at 128 x 128; two blocks' rings fit an
//   SM) beat rings of 3 or 4 slabs of 32 or 16 and two of 64 on the card
//   (python -m repro_torch.kernels.gemm_variants): one slab's FMAs hide
//   the next one's copy, and a deeper slab halves the barriers.
// * Each thread's staging rows and columns are shifts and masks of
//   threadIdx.x fixed before the loop; a slab only advances pointers, so
//   no loop divides at run time.
// * Two instances of the body: VEC stages 16-byte copies (bases 16-byte
//   aligned, row and group strides multiples of 4 floats: the host checks
//   this, and every path shape meets it); the other stages 4-byte copies
//   and takes any f32 view with unit column stride.  Both zero-fill the
//   ragged edges through cp.async's source size.
//
// Numerics: f32 FMAs on the CUDA cores; each output is one thread's sum
// in ascending k, no split K and no atomics, so the result matches the
// plain f32 version to reassociation (1e-5 of max|y|).  Tensor cores
// (TF32 or 3xTF32) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BK = 32;          // contraction depth of one slab
constexpr int STAGES = 2;       // slabs in the shared-memory ring
constexpr int XLD = BK + 4;     // x slab row stride (floats)
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kSmemLimit = 232448;

struct GemmArgs {
  int m, n, k;
  long long ldx, ldw, ldo;    // row strides (elements)
  long long sx, sw, so;       // group strides (elements)
};

template <int BN>
struct Tile {
  static constexpr int NS = BN / 64;                  // column strips
  static constexpr int X_FLOATS = BM * XLD;
  static constexpr int STAGE_FLOATS = X_FLOATS + BK * BN;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// one float, read when `bytes` is 4 and zero-filled when it is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int clamp_bytes(int floats) {
  return floats >= 4 ? 16 : floats > 0 ? 4 * floats : 0;
}

// Stages one slab (BK deep) of x and w per call, the slabs in order of
// k.  A row of x takes XCOLS copies (16 bytes each when VEC, else 4) and
// a row of w WCOLS; thread t copies x rows t / XCOLS + XSTEP r at copy
// t mod XCOLS, and w rows t / WCOLS + WSTEP r at copy t mod WCOLS.  All
// four are powers of two: shifts and masks, fixed before the loop.
template <int BN, bool VEC>
struct Stager {
  static constexpr int XCOLS = VEC ? BK / 4 : BK;      // copies per x row
  static constexpr int WCOLS = VEC ? BN / 4 : BN;      // copies per w row
  static constexpr int XSTEP = kThreads / XCOLS;       // x rows per pass
  static constexpr int WSTEP = kThreads / WCOLS;       // w rows per pass
  static constexpr int XR = BM / XSTEP;                // passes over x
  static constexpr int WR = BK / WSTEP;                // passes over w
  static_assert(XR >= 1 && WR >= 1 && XR <= 32, "every thread copies");

  const float* xp;            // this thread's first x source, at slab k0
  const float* wp;            // this thread's first w source, at slab k0
  const float* x0;            // valid addresses for zero-filled copies
  const float* w0;
  long long xstep, wstep;     // between a thread's rows (elements)
  long long wslab;            // BK rows of w (elements)
  int xoff, woff;             // shared offsets of the first copies
  int xcol, wrow;             // this thread's k offset in x, w
  int k, k0;
  unsigned xrows;             // bit r: x row r in range
  int wbytes;                 // bytes of this thread's w columns in range

  __device__ Stager(const float* x, const float* w, const GemmArgs& a,
                    int m0, int n0, unsigned t)
      : x0(x), w0(w), k(a.k), k0(0) {
    const int xr = (int)(t / XCOLS);
    xcol = (int)(t % XCOLS) * (VEC ? 4 : 1);
    const int wc = (int)(t % WCOLS) * (VEC ? 4 : 1);
    wrow = (int)(t / WCOLS);
    xoff = xr * XLD + xcol;
    woff = wrow * BN + wc;
    xstep = (long long)XSTEP * a.ldx;
    wstep = (long long)WSTEP * a.ldw;
    wslab = (long long)BK * a.ldw;
    xrows = 0;
#pragma unroll
    for (int r = 0; r < XR; ++r)
      if (m0 + xr + XSTEP * r < a.m) xrows |= 1u << r;
    const int left = a.n - (n0 + wc);
    wbytes = VEC ? clamp_bytes(left) : (left > 0 ? 4 : 0);
    xp = x + (long long)(m0 + xr) * a.ldx + xcol;
    wp = w + (long long)wrow * a.ldw + n0 + wc;
  }

  // stage the next slab into xs [BM][XLD] and ws [BK][BN]
  __device__ __forceinline__ void load(float* xs, float* ws) {
    const int kleft = k - (k0 + xcol);
    const int xb = VEC ? clamp_bytes(kleft) : (kleft > 0 ? 4 : 0);
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int bytes = (xrows >> r & 1u) ? xb : 0;
      const float* src = bytes ? xp + r * xstep : x0;
      if (VEC)
        cp_async16(xs + xoff + r * XSTEP * XLD, src, bytes);
      else
        cp_async4(xs + xoff + r * XSTEP * XLD, src, bytes);
    }
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int bytes = k0 + wrow + r * WSTEP < k ? wbytes : 0;
      const float* src = bytes ? wp + r * wstep : w0;
      if (VEC)
        cp_async16(ws + woff + r * WSTEP * BN, src, bytes);
      else
        cp_async4(ws + woff + r * WSTEP * BN, src, bytes);
    }
    xp += BK;
    wp += wslab;
    k0 += BK;
  }
};

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// out[g] (m x n) = x[g] (m x k) @ w[g] (k x n), g = blockIdx.z.  Thread
// (ty, tx) = (t >> 4, t & 15) owns rows 64 i + 4 ty + {0..3} and columns
// 64 j + 4 tx + {0..3} of the block tile.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, GemmArgs a) {
  using T = Tile<BN>;
  constexpr int NS = T::NS;
  extern __shared__ __align__(16) float smem[];

  const int g = blockIdx.z;
  x += (long long)g * a.sx;
  w += (long long)g * a.sw;
  out += (long long)g * a.so;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const unsigned t = threadIdx.x;
  const int tx = (int)(t & 15), ty = (int)(t >> 4);

  Stager<BN, VEC> st(x, w, a, m0, n0, t);
  const int slabs = (a.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs)
      st.load(smem + s * T::STAGE_FLOATS,
              smem + s * T::STAGE_FLOATS + T::X_FLOATS);
    cp_async_commit();
  }

  float acc[8][4 * NS];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NS; ++j) acc[i][j] = 0.f;

  int read = 0, write = STAGES - 1;
  for (int kt = 0; kt < slabs; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of slab kt landed
    __syncthreads();               // everyone's; slab kt - 1 is read
    if (kt + STAGES - 1 < slabs)
      st.load(smem + write * T::STAGE_FLOATS,
              smem + write * T::STAGE_FLOATS + T::X_FLOATS);
    cp_async_commit();             // an empty group keeps the count

    const float* xs = smem + read * T::STAGE_FLOATS + (4 * ty) * XLD;
    const float* ws = smem + read * T::STAGE_FLOATS + T::X_FLOATS + 4 * tx;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 xa[8];                // rows 64 (i >> 2) + 4 ty + (i & 3)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xa[i] = *reinterpret_cast<const float4*>(
            xs + ((i >> 2) * 64 + (i & 3)) * XLD + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 wb[NS];
#pragma unroll
        for (int c = 0; c < NS; ++c)
          wb[c] = *reinterpret_cast<const float4*>(ws + (kq + kk) * BN
                                                   + 64 * c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = lane(xa[i], kk);
#pragma unroll
          for (int c = 0; c < NS; ++c) {
            acc[i][4 * c + 0] = fmaf(xv, wb[c].x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(xv, wb[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(xv, wb[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(xv, wb[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    read = read + 1 == STAGES ? 0 : read + 1;
    write = write + 1 == STAGES ? 0 : write + 1;
  }
  cp_async_wait<0>();              // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
    if (gm >= a.m) continue;
    float* row = out + (long long)gm * a.ldo;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int gn = n0 + 64 * c + 4 * tx;
      if (VEC && gn + 3 < a.n) {
        *reinterpret_cast<float4*>(row + gn) = make_float4(
            acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
            acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < a.n) row[gn + j] = acc[i][4 * c + j];
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int BN, bool VEC>
cudaError_t launch_tile(const float* x, const float* w, float* out,
                        int groups, const GemmArgs& a, cudaStream_t stream,
                        int* blocks) {
  static_assert(2 * Tile<BN>::SMEM <= kSmemLimit, "two rings fit an SM");
  auto kern = gemm_f32_kernel<BN, VEC>;
  // the ring is above the 48 KB default: allowed once per device (bit d)
  static std::atomic<unsigned long long> ring_allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(ring_allowed.load() >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
    if (err != cudaSuccess) return err;
    ring_allowed.fetch_or(1ull << dev);
  }
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, groups);
  kern<<<grid, kThreads, Tile<BN>::SMEM, stream>>>(x, w, out, a);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) *blocks = (int)(grid.x * grid.y * grid.z);
  return launched;
}

// Launch the (bn, vec) instance; refuse a tile that is not compiled, a
// grid the card cannot take and a vector launch on operands that are not
// 16-byte aligned with row and group strides in multiples of 4 floats.
int launch(const float* x, const float* w, float* out, int groups,
           const GemmArgs& a, int bn, int vec, int* blocks, void* stream) {
  *blocks = 0;
  if (groups < 1 || groups > 65535 || a.m < 0 || a.n < 0 || a.k < 0 ||
      (bn != 64 && bn != 128) || (a.m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned16(x) && aligned16(w) && aligned16(out) &&
               a.ldx % 4 == 0 && a.ldw % 4 == 0 && a.ldo % 4 == 0 &&
               a.sx % 4 == 0 && a.sw % 4 == 0 && a.so % 4 == 0))
    return (int)cudaErrorInvalidValue;
  if (a.m == 0 || a.n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bn == 128)
    err = vec ? launch_tile<128, true>(x, w, out, groups, a, s, blocks)
              : launch_tile<128, false>(x, w, out, groups, a, s, blocks);
  else
    err = vec ? launch_tile<64, true>(x, w, out, groups, a, s, blocks)
              : launch_tile<64, false>(x, w, out, groups, a, s, blocks);
  return (int)err;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  Each launches on `stream` the
// block tile 128 x bn (bn 128 or 64, the host's gemm_launch_dims) with
// 16-byte staging when vec is 1 and 4-byte staging when it is 0, writes
// the blocks it launched to *blocks and returns cudaGetLastError(): a
// refused launch never runs, and only this return value reports it
// (cudaErrorInvalidValue for arguments the kernel does not take).
// ---------------------------------------------------------------------------

// out (m, n) = x (m, k) @ w (k, n); row strides ldx, ldw, ldo.
extern "C" int tetris_matmul_f32(const float* x, const float* w, float* out,
                                 int m, int n, int k, long long ldx,
                                 long long ldw, long long ldo, int bn,
                                 int vec, int* blocks, void* stream) {
  const GemmArgs a{m, n, k, ldx, ldw, ldo, 0, 0, 0};
  return launch(x, w, out, 1, a, bn, vec, blocks, stream);
}

// out[g] (m, f) = x[g] (m, d) @ w[g] (d, f) for g < groups; row strides
// ld*, group strides s*.
extern "C" int grouped_matmul_f32(const float* x, const float* w, float* out,
                                  int groups, int m, int f, int d,
                                  long long ldx, long long ldw, long long ldo,
                                  long long sx, long long sw, long long so,
                                  int bn, int vec, int* blocks,
                                  void* stream) {
  const GemmArgs a{m, f, d, ldx, ldw, ldo, sx, sw, so};
  return launch(x, w, out, groups, a, bn, vec, blocks, stream);
}
