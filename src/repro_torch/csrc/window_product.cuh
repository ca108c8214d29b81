// The window product shared by the two convolution kernels of the port
// (im2win_conv.cu and sdk_conv.cu's window kernel), f32 on the CUDA cores.
//
// One parallel-window load of a TPU kernel computes, for every output
// position of the window, the k_h*k_w shifted products of the staged
// input patch with the staged kernel block:
//
//   out[m, o] = sum_{dy, dx, c} patch[row(m) + dy*row_stride + dx*pix + c]
//                             * ws[((dy*k_w + dx)*cp + c)*obs + o]
//
// Staged layouts (both kernels stage into these, each from its own source:
// an NHWC map shared across a thread-block cluster, or an NCHW map copied
// with cp.async):
//
//   patch  [image][pixel][pix]: pix (the pixel stride) is cp rounded so
//          that pix/4 is odd: eight neighbouring pixels read as float4 fall
//          in eight distinct bank groups;
//   ws     [k_h*k_w][cp][obs]: cp input channels (a multiple of 4, zero
//          past the real ones) by obs output channels (a multiple of 4,
//          zero past the real ones).
//
// M rows (positions, or image x position pairs) by N = obs output channels
// are cut into thread tiles of RP rows x RO channels held in registers:
// per four input channels a thread issues 4 float4 loads of weights and
// RP float4 loads of patch for RP*RO*4 = 128 FMAs.  Tile t is (tp, to) =
// (t / toc, t % toc): it takes rows tp + ntp*r (r < RP) and channels
// 4*to .. 4*to+3.  Channel groups vary fastest, so a warp spans a few
// neighbouring rows by several channel groups: its patch loads hit a few
// neighbouring pixels and its weight loads a few neighbouring float4s,
// about one shared-memory wavefront each.  When a block has fewer tiles than
// threads, ks groups of threads split the K sum (k_h*k_w*cp/4 steps) into
// contiguous ranges, and the block adds each output's partial sums in
// group order: every output is the same function of its inputs, whichever
// block or thread computes it, so overlapping clamped windows store equal
// bits.

#pragma once

#include <cuda_runtime.h>

namespace wp {

constexpr int kThreads = 256;
constexpr int RP = 8;                  // rows of a thread tile
constexpr int RO = 4;                  // output channels of a thread tile
constexpr int kSmemLimit = 227 * 1024; // shared memory a block may use

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Division by a divisor fixed at launch, as a multiply and a shift
// (Granlund-Montgomery; exact for 0 <= n < 2^31).  Built on the host: a
// hardware-less integer division costs a chain of some twenty dependent
// instructions, and the staging and store loops would otherwise pay
// several per element, one warp's chain after another.
struct FastDiv {
  int d;
  unsigned mul, shift;
  __host__ __device__ FastDiv() : d(1), mul(0), shift(0) {}
  __host__ explicit FastDiv(int divisor) : d(divisor), mul(0), shift(0) {
    if (d > 1) {
      unsigned l = 0;                             // ceil(log2 d)
      while ((1u << l) < (unsigned)d) ++l;
      const unsigned p = 31 + l;
      mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
      shift = p - 32;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shift);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// Pixel stride of a staged patch whose pixels hold cp (a multiple of 4)
// channels: cp itself when cp/4 is odd, else cp + 4.
__host__ __device__ inline int pixel_stride(int cp) {
  return (cp / 4) % 2 ? cp : cp + 4;
}

// How a block's threads cover its rows x obs tile: ntp row groups by toc
// channel groups (nt tiles); ks thread groups split K when nt < kThreads,
// else each thread walks `passes` tiles one after another.
struct Split {
  int ntp, toc, nt, ks, passes;
};

__host__ __device__ inline Split make_split(int rows, int obs, int ks) {
  Split s;
  s.ntp = (rows + RP - 1) / RP;
  s.toc = obs / RO;
  s.nt = s.ntp * s.toc;
  s.ks = ks;
  s.passes = ks > 1 ? 1 : (s.nt + kThreads - 1) / kThreads;
  return s;
}

// Floats of the reduction scratch: every group parks its partials.
__host__ __device__ inline long long scratch_floats(const Split& s) {
  return s.ks > 1 ? (long long)s.ks * s.nt * RP * RO : 0;
}

// False when `ks` does not fit the tile: more threads than a block has.
__host__ __device__ inline bool split_ok(const Split& s) {
  return s.ks >= 1 && s.toc >= 1 && (s.ks == 1 || s.nt * s.ks <= kThreads);
}

// acc += the product over K steps [j0, j1) of one thread tile.  A K step
// is (kk, c4): kernel tap kk = dy*k_w + dx and input channels 4*c4 ..
// 4*c4 + 3, with cp4 steps per tap.  base[r] is row r's first patch float,
// wo points at the tile's first channel of ws.
__device__ __forceinline__ void product(const float* __restrict__ patch,
                                        const float* __restrict__ wo,
                                        const int (&base)[RP], int cp4,
                                        int cp, int obs, int k_w,
                                        int row_stride, int pix, int j0,
                                        int j1, float (&acc)[RP][RO]) {
  if (j0 >= j1) return;
  int kk = j0 / cp4;                  // the first tap; later ones counted
  int c4 = j0 - kk * cp4;
  int dy = kk / k_w, dx = kk - dy * k_w;
  for (int j = j0; j < j1;) {
    const int end = min(cp4, c4 + (j1 - j));
    j += end - c4;
    const float* pk = patch + dy * row_stride + dx * pix;
    const float* wk = wo + (long long)kk * cp * obs;
#pragma unroll 2
    for (; c4 < end; ++c4) {
      float4 w[4], p[RP];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = *reinterpret_cast<const float4*>(wk + (4 * c4 + u) * obs);
#pragma unroll
      for (int r = 0; r < RP; ++r)
        p[r] = *reinterpret_cast<const float4*>(pk + base[r] + 4 * c4);
      // channel by channel, each over all RP*RO sums: consecutive FMAs
      // update different accumulators, so none waits on the one before
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float pv = u == 0 ? p[r].x : u == 1 ? p[r].y
                         : u == 2 ? p[r].z : p[r].w;
          acc[r][0] = fmaf(pv, w[u].x, acc[r][0]);
          acc[r][1] = fmaf(pv, w[u].y, acc[r][1]);
          acc[r][2] = fmaf(pv, w[u].z, acc[r][2]);
          acc[r][3] = fmaf(pv, w[u].w, acc[r][3]);
        }
      }
    }
    c4 = 0;                           // the next tap
    ++kk;
    if (++dx == k_w) {
      dx = 0;
      ++dy;
    }
  }
}

// Tile t's row group and channel group.
__device__ __forceinline__ void tile_of(int t, const Split& s, int* tp,
                                        int* to) {
  *tp = t / s.toc;
  *to = t - *tp * s.toc;
}

// Asynchronous 4-byte copy from device to shared memory (cp.async): a
// thread issues all of its staging copies before waiting once, so their
// latencies overlap.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem));
}

// The same for 16 bytes: both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// K steps [j0, j1) of group kg among ks over a slice of `total` steps.
__device__ __forceinline__ void k_range(int total, int kg, int ks, int* j0,
                                        int* j1) {
  *j0 = total * kg / ks;               // total * ks stays far below 2^31
  *j1 = total * (kg + 1) / ks;
}

// With ks > 1: every group parks its partial sums in `scratch`
// ([group][r*RO + q][tile]: neighbouring tiles, neighbouring banks), the
// block's threads add each value's partials in group order, and group 0
// reads the sums back into acc.  Called by every thread of the block (it
// synchronises).
__device__ __forceinline__ void reduce_groups(float* scratch, const Split& s,
                                              int tile, int kg, bool active,
                                              float (&acc)[RP][RO]) {
  if (s.ks == 1) return;
  const int nv = s.nt * RP * RO;
  if (active) {
    float* dst = scratch + (long long)kg * nv + tile;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RO; ++q) dst[(r * RO + q) * s.nt] = acc[r][q];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float sum = scratch[v];
    for (int g = 1; g < s.ks; ++g) sum += scratch[(long long)g * nv + v];
    scratch[v] = sum;
  }
  __syncthreads();
  if (active && kg == 0) {
    const float* src = scratch + tile;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RO; ++q) acc[r][q] = src[(r * RO + q) * s.nt];
  }
}

}  // namespace wp
