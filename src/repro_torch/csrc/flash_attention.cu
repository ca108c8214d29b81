// Fused online-softmax attention on Hopper (sm_90a), f32.
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
// block owns one (bh, 64-row q tile); a loop over 64-key tiles stands in
// for the kv axis, staging each k and v tile in shared memory, and m, l
// and acc stay in registers.  Thread t owns query row t / 4 of the tile:
// its four threads (one quad of a warp) split that row's 64 scores and
// D output columns, and reduce the row's max and sum with quad shuffles,
// so every thread holds the row's m and l itself.
//
// Ragged tiles.  Any Sq and Sk run (the TPU kernel's rule that they tile
// by min(128, S) is not kept): rows past Sq are computed from zeros and
// not stored, and keys past Sk score -1e30 like masked ones.  Every row sees key 0 in the first tile (q_offset >= 0),
// so its running max is a real score from then on and a -1e30 score adds
// exp(-1e30 - m) = 0 exactly.
//
// Causal tile skip.  A key tile whose first key lies after the last
// query position of the block (q_offset + the tile's last row) is masked
// for every row.  Such a tile adds exactly zero (p = 0, alpha = 1, since
// row 0 always sees key 0 when q_offset >= 0), so the loop stops before
// it.
//
// What bounds it.  4*Sq*Sk*D FLOP per head (2*Sq*Sk*D causal) against
// 4*Sq*D*4 bytes of q, k, v and out: at the path's shapes (stablelm-1.6b
// causal S = 512, whisper-base S = 1024, D = 64) some 128 to 256 FLOP per
// byte, so the f32 rate of the CUDA cores bounds it, not the memory.
// Scores, probabilities and the accumulator never leave the block, which
// is the kernel's whole point: memory traffic O(S*D), not O(S^2).  Tensor
// cores and bf16 are later work; f32 must match the plain version to 1e-5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int BKV = 64;               // keys per tile
constexpr int kThreads = 4 * BQ;      // a quad of threads per query row
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value

struct FlashArgs {
  int sq, sk, d;
  int causal, q_offset;
  float scale;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows [r0, r0 + 64) of a (rows, d) matrix into a 64 x (d + 1)
// shared tile; rows past `rows` read 0.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int r0, int rows, int d) {
  const int ld = d + 1;
  for (int e = threadIdx.x; e < 64 * d; e += kThreads) {
    const int r = e / d, c = e % d;
    dst[r * ld + c] = (r0 + r < rows) ? src[(size_t)(r0 + r) * d + c] : 0.f;
  }
}

// DMAX bounds D (the accumulator is DMAX / 4 registers a thread).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, FlashArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* qs = smem;                    // BQ x (d + 1)
  float* ks = qs + BQ * ld;            // BKV x (d + 1)
  float* vs = ks + BKV * ld;           // BKV x (d + 1)
  float* ps = vs + BKV * ld;           // BQ x (BKV + 1) probabilities

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  q += bh * a.sq * d;
  k += bh * a.sk * d;
  v += bh * a.sk * d;
  out += bh * a.sq * d;

  const int row = threadIdx.x / 4;     // query row of the tile
  const int lane = threadIdx.x % 4;    // its quarter of keys and columns
  const int pos_q = a.q_offset + q0 + row;

  stage(qs, q, q0, a.sq, d);

  float m = kNegInf, l = 0.f;
  float acc[DMAX / 4];
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;

  int n_tiles = (a.sk + BKV - 1) / BKV;
  if (a.causal) {                      // skip tiles above the diagonal
    const int last_q = a.q_offset + min(q0 + BQ, a.sq) - 1;
    n_tiles = min(n_tiles, last_q / BKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();                   // previous tile's reads are done
    stage(ks, k, k0, a.sk, d);
    stage(vs, v, k0, a.sk, d);
    __syncthreads();

    // scores of keys lane + 4*j, j < 16
    float s[BKV / 4];
    const float* qr = qs + row * ld;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) s[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j)
        s[j] = fmaf(qv, ks[(lane + 4 * j) * ld + c], s[j]);
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int key = k0 + lane + 4 * j;
      const bool keep = key < a.sk && (!a.causal || key <= pos_q);
      s[j] = keep ? s[j] * a.scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* pr = ps + row * (BKV + 1);
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      pr[lane + 4 * j] = p;
    }
    l = alpha * l + quad_sum(psum);
    m = m_new;
    __syncwarp();                      // the row's quad wrote pr

    // acc[i] holds output column lane + 4*i; columns past d stay 0
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * ld + lane;
#pragma unroll
      for (int i = 0; i < DMAX / 4; ++i)
        if (lane + 4 * i < d) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }

  if (q0 + row < a.sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o = out + (size_t)(q0 + row) * d;
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const int c = lane + 4 * i;
      if (c < d) o[c] = acc[i] * inv;
    }
  }
}

template <int DMAX>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, const FlashArgs& a, void* stream) {
  const int smem = (int)sizeof(float) *
                   (BQ * (a.d + 1) + 2 * BKV * (a.d + 1) + BQ * (BKV + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, bh);
  flash_attention_kernel<DMAX><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, out, a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  q, out (bh, sq, d), k, v (bh, sk, d),
// contiguous f32, 1 <= d <= 128.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this return
// value reports it.
// ---------------------------------------------------------------------------
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int bh, int sq,
                                   int sk, int d, int causal, int q_offset,
                                   float scale, void* stream) {
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  const FlashArgs a{sq, sk, d, causal, q_offset, scale};
  if (d <= 32) return launch<32>(q, k, v, out, bh, a, stream);
  if (d <= 64) return launch<64>(q, k, v, out, bh, a, stream);
  return launch<128>(q, k, v, out, bh, a, stream);
}
