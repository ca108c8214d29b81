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
// Both entry points run one body.  A block computes a BM x BN tile of
// one group's output; it walks the contraction in BK-deep slabs, staging
// the x slab (BM x BK, stored transposed) and the w slab (BK x BN) in
// shared memory, and each of its 256 threads keeps a TM x TN register
// tile of outputs: TM*TN independent accumulators per thread, each
// shared-memory value loaded once per slab and used TN (or TM) times.
//
// The TPU grid (⌈M/bm⌉, ⌈N/bn⌉, K/bk) carries its f32 accumulator in
// VMEM scratch across the sequential K axis; here the K axis is the loop
// inside the block and the accumulator lives in registers.  The TPU
// kernel clamps its M/N edge blocks (overlapping recompute) and shrinks
// bk until it divides K; here the ragged M, N and K edges are masked
// instead: out-of-range loads read 0 and out-of-range stores are
// skipped.  Hopper blocks run in no order, so a clamped overlapping block
// buys nothing.
//
// Operands are f32 with unit column stride; each carries its row stride
// (ld*) and group stride (s*), so the executor's group-major view of the
// weights, w[g, d, f] = kernel[d, g*F + f], is read in place.
//
// What bounds it.  At the path's shapes (whisper-base M = 4096 with
// K, N in {512, 1536, 2048}; stablelm-1.6b G = 4, M = 2048, D, F in
// {512, 1408, 1536}) the products do 2.1 to 12.9 GFLOP per launch
// against 10 to 50 MB of operands: far above the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte), so the bound is the
// f32 FMA rate of the CUDA cores.  Tensor cores are not used: TF32 keeps
// about three decimal digits and the kernel must match the plain f32
// version to 1e-5 of max|y|.  wgmma, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // contraction depth of one shared slab
constexpr int TM = 4;         // output rows per thread
constexpr int TN = 4;         // output columns per thread
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256

struct GemmArgs {
  int m, n, k;
  long long ldx, ldw, ldo;    // row strides (elements)
  long long sx, sw, so;       // group strides (elements)
};

// out[g] (m x n) = x[g] (m x k) @ w[g] (k x n), g = blockIdx.z.
// Thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j of the tile:
// the 16 threads of a half-warp read 16 consecutive w values and store 16
// consecutive outputs, and read one broadcast x value.
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, GemmArgs a) {
  __shared__ float xs[BK][BM + 1];   // x slab, transposed; +1 spreads banks
  __shared__ float ws[BK][BN];

  const int g = blockIdx.z;
  x += (long long)g * a.sx;
  w += (long long)g * a.sw;
  out += (long long)g * a.so;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.k; k0 += BK) {
    // x slab: BM rows x BK columns, BK consecutive threads on one row
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < a.m && gk < a.k) ? x[gm * a.ldx + gk] : 0.f;
    }
    // w slab: BK rows x BN columns, BN consecutive threads on one row
#pragma unroll
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < a.k && gn < a.n) ? w[gk * a.ldw + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xa[TM], wb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xa[i] = xs[kk][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wb[j] = ws[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
    __syncthreads();              // every read of this slab is done
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + (BM / TM) * i;
    if (gm >= a.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + (BN / TN) * j;
      if (gn < a.n) out[gm * a.ldo + gn] = acc[i][j];
    }
  }
}

int launch(const float* x, const float* w, float* out, int groups,
           const GemmArgs& a, void* stream) {
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, groups);
  gemm_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, w, out, a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and only this
// return value reports it.
// ---------------------------------------------------------------------------

// out (m, n) = x (m, k) @ w (k, n); row strides ldx, ldw, ldo.
extern "C" int tetris_matmul_f32(const float* x, const float* w, float* out,
                                 int m, int n, int k, long long ldx,
                                 long long ldw, long long ldo, void* stream) {
  const GemmArgs a{m, n, k, ldx, ldw, ldo, 0, 0, 0};
  return launch(x, w, out, 1, a, stream);
}

// out[g] (m, f) = x[g] (m, d) @ w[g] (d, f) for g < groups; row strides
// ld*, group strides s*.
extern "C" int grouped_matmul_f32(const float* x, const float* w, float* out,
                                  int groups, int m, int f, int d,
                                  long long ldx, long long ldw, long long ldo,
                                  long long sx, long long sw, long long so,
                                  void* stream) {
  const GemmArgs a{m, f, d, ldx, ldw, ldo, sx, sw, so};
  return launch(x, w, out, groups, a, stream);
}
