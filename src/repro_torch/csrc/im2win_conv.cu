// Mapping-free im2win convolution on Hopper (sm_90a), f32: the kernel
// behind kernels/ops.py::conv2d.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/im2win_conv.py::_conv_kernel (im2win_conv)
// which computes a stride-1 VALID convolution of a pre-padded NHWC input
// x (B, H, W, C) with HWIO weights w (kh, kw, C, O):
//
//   out[b, y, x, o] = sum_{dy, dx, c} x[b, y + dy, x + dx, c] w[dy, dx, c, o]
//
// Index space.  The TPU grid is (B, ⌈o_h/th⌉, ⌈o_w/tw⌉) with the window
// (th, tw) from the square-inclined rule (select_window, Alg 3): one grid
// step, one parallel-window load, computes a th x tw tile of outputs
// against the whole kernel as kh*kw shift-matmuls, and border tiles are
// clamped, y0 = min(i*th, o_h - th).  Here one grid step is one
// thread-block cluster: the launch has n_cycles(o_h, o_w, th, tw, B)
// clusters of `cluster` blocks each, the same clamp, and the blocks of a
// cluster split the step's product (th*tw positions x O channels) into
// cp x co parts of pos_b positions x oc_b channels (rank = pi*co + oi).
// The split comes from kernels/im2win_conv.py::cluster_split.  Clamped
// windows overlap and write the same bits to the same outputs (every
// output is summed in one fixed order), a benign race.
//
// Inside a cluster.  Every block stages the window patch (th+kh-1) x
// (tw+kw-1) x cs and its oc_b columns of the weights, kh x kw x cs x oc_b,
// in shared memory; input channels are staged in slices of cs where the
// two do not fit 227 KB.  Device memory sees each patch once per step, as
// a CIM cycle reads it once: the cluster's other blocks find it in L2.
// (Sharing one load of the patch through distributed shared memory
// measured slower on an H100; PERF.md keeps both times.)  Staging copies
// are asynchronous (cp.async, 16 bytes where channels come in fours), so
// a thread's loads are in flight together.
// The product is window_product.cuh's: 8 x 4 register tiles, float4
// shared loads; where a block has fewer tiles than threads (small windows:
// CNN8-7 has one position) the threads split the K sum and add the
// partial sums in a fixed order.
//
// What bounds it.  At the paper's layers (batch 8) select_window covers a
// whole image, so a launch has 8 steps.  An H100 holds 15 clusters of 8
// blocks at once but only 7 of 9 to 16 (cudaOccupancyMaxActiveClusters),
// so cluster_split forms at most 8 blocks, the largest portable cluster:
// 8 x 8 blocks in one wave.  The 14 layers total 1.36 GFLOP, so the f32 rate bounds them
// (20 us at 67 TFLOP/s); at these sizes each launch is short enough that
// staging and launch latency weigh as much.  Tensor cores (TF32) would
// not hold 1e-5 of max|y|.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_product.cuh"

namespace cg = cooperative_groups;

namespace {

struct ConvArgs {
  int b, h, w, c, kh, kw, oc, th, tw, oh, ow;
  int cluster, co, pos_b, oc_b, cs, ks;
};

// Divisors the kernel's index arithmetic uses, built on the host.
struct ConvDivs {
  wp::FastDiv tw, pw, cp, oc_b, c4n, ob4;
};

// Shared-memory layout of one block, in floats.
struct Layout {
  int ph, pw, cp, pix, npix;
  long long patch, ws, scratch;   // sizes
  __host__ __device__ long long total() const { return patch + ws + scratch; }
};

__host__ __device__ inline Layout layout(const ConvArgs& a,
                                         const wp::Split& s) {
  Layout l;
  l.ph = a.th + a.kh - 1;
  l.pw = a.tw + a.kw - 1;
  l.cp = wp::round4(a.cs);
  l.pix = wp::pixel_stride(l.cp);
  l.npix = l.ph * l.pw;
  l.patch = (long long)l.npix * l.pix;
  l.ws = (long long)a.kh * a.kw * l.cp * a.oc_b;
  l.scratch = wp::scratch_floats(s);
  return l;
}

__global__ void __launch_bounds__(wp::kThreads)
im2win_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ out, ConvArgs a, ConvDivs dv) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const wp::Split s = wp::make_split(a.pos_b, a.oc_b, a.ks);
  const Layout l = layout(a, s);
  float* patch = smem;
  float* ws = smem + l.patch;
  float* scratch = ws + l.ws;

  // grid step (image, window) and this block's part of its product
  const int step = blockIdx.x / a.cluster;
  const int rank = (int)cluster.block_rank();
  const int nx = (a.ow + a.tw - 1) / a.tw, ny = (a.oh + a.th - 1) / a.th;
  const int bi = step / (ny * nx);
  const int y0 = min((step / nx % ny) * a.th, a.oh - a.th);    // clamped
  const int x0 = min((step % nx) * a.tw, a.ow - a.tw);
  const int npos = a.th * a.tw;
  const int p_lo = (rank / a.co) * a.pos_b;
  const int p_hi = min(npos, p_lo + a.pos_b);
  const int o_lo = (rank % a.co) * a.oc_b;
  const int o_hi = min(a.oc, o_lo + a.oc_b);
  const float* xb = x + (long long)bi * a.h * a.w * a.c;
  const int tid = threadIdx.x;
  const int kk_n = a.kh * a.kw;
  const bool one_slice = a.cs >= a.c;
  const int c4n = l.cp / 4, ob4 = a.oc_b / 4;   // channels in fours

  for (int pass = 0; pass < s.passes; ++pass) {
    // this thread's tile and K group
    const int t = s.ks > 1 ? tid % s.nt : tid + pass * wp::kThreads;
    const int kg = s.ks > 1 ? tid / s.nt : 0;
    const bool active = s.ks > 1 ? tid < s.nt * s.ks : t < s.nt;
    int tp, to;
    wp::tile_of(t, s, &tp, &to);
    int base[wp::RP];
#pragma unroll
    for (int r = 0; r < wp::RP; ++r) {
      const int p = min(p_lo + tp + s.ntp * r, p_hi - 1);   // clamp: load only
      const int py = dv.tw.div(p);
      base[r] = (py * l.pw + p - py * a.tw) * l.pix;
    }
    float acc[wp::RP][wp::RO] = {};

    for (int c0 = 0; c0 < a.c; c0 += a.cs) {
      const int cn = min(a.cs, a.c - c0);
      const int cp4 = wp::round4(cn) / 4;
      if (!(one_slice && pass > 0)) {
        __syncthreads();               // this block's reads of the last slice
        // the patch and this block's weight columns, copied
        // asynchronously; channels past cn and columns past o_hi zeroed
        // (16-byte copies where channels come in fours: C, O % 4 == 0)
        if (a.c % 4 == 0) {
          for (int e = tid; e < l.npix * c4n; e += wp::kThreads) {
            const int pix = dv.c4n.div(e), cc = 4 * (e - pix * c4n);
            const int r = dv.pw.div(pix), q = pix - r * l.pw;
            float* dst = patch + pix * l.pix + cc;
            if (cc < cn)
              wp::cp_async16(dst, xb + ((long long)(y0 + r) * a.w + x0 + q)
                                           * a.c + c0 + cc);
            else
              *reinterpret_cast<float4*>(dst) = make_float4(0, 0, 0, 0);
          }
        } else {
          for (int e = tid; e < l.npix * l.cp; e += wp::kThreads) {
            const int pix = dv.cp.div(e), cc = e - pix * l.cp;
            const int r = dv.pw.div(pix), q = pix - r * l.pw;
            if (cc < cn)
              wp::cp_async4(patch + pix * l.pix + cc,
                            xb + ((long long)(y0 + r) * a.w + x0 + q) * a.c
                                + c0 + cc);
            else
              patch[pix * l.pix + cc] = 0.f;
          }
        }
        if (a.oc % 4 == 0) {
          for (int e = tid; e < kk_n * l.cp * ob4; e += wp::kThreads) {
            const int rest = dv.ob4.div(e), o = 4 * (e - rest * ob4);
            const int kk = dv.cp.div(rest), cc = rest - kk * l.cp;
            float* dst = ws + rest * a.oc_b + o;
            if (cc < cn && o_lo + o < o_hi)
              wp::cp_async16(dst, wt + ((long long)kk * a.c + c0 + cc) * a.oc
                                      + o_lo + o);
            else
              *reinterpret_cast<float4*>(dst) = make_float4(0, 0, 0, 0);
          }
        } else {
          for (int e = tid; e < kk_n * l.cp * a.oc_b; e += wp::kThreads) {
            const int rest = dv.oc_b.div(e), o = e - rest * a.oc_b;
            const int kk = dv.cp.div(rest), cc = rest - kk * l.cp;
            if (cc < cn && o_lo + o < o_hi)
              wp::cp_async4(ws + e, wt + ((long long)kk * a.c + c0 + cc)
                                            * a.oc + o_lo + o);
            else
              ws[e] = 0.f;
          }
        }
        wp::cp_async_commit();
        wp::cp_async_wait<0>();
        __syncthreads();
      }
      if (active) {
        int j0, j1;
        wp::k_range(kk_n * cp4, kg, s.ks, &j0, &j1);
        wp::product(patch, ws + wp::RO * to, base, cp4, l.cp, a.oc_b, a.kw,
                    l.pw * l.pix, l.pix, j0, j1, acc);
      }
    }
    wp::reduce_groups(scratch, s, t, kg, active, acc);
    if (active && kg == 0) {
#pragma unroll
      for (int r = 0; r < wp::RP; ++r) {
        const int p = p_lo + tp + s.ntp * r;
        if (p >= p_hi) continue;
        const int py = dv.tw.div(p);
        float* o_row = out + (((long long)bi * a.oh + y0 + py) * a.ow + x0 +
                              p - py * a.tw) * a.oc;
#pragma unroll
        for (int q = 0; q < wp::RO; ++q) {
          const int o = o_lo + wp::RO * to + q;
          if (o < o_hi) o_row[o] = acc[r][q];
        }
      }
    }
  }
}

cudaError_t check_args(const ConvArgs& a, wp::Split* s, int* smem) {
  if (a.b < 1 || a.c < 1 || a.oc < 1 || a.oh < 1 || a.ow < 1 || a.th < 1 ||
      a.tw < 1 || a.th > a.oh || a.tw > a.ow || a.cluster < 1 ||
      a.cluster > 8 || a.co < 1 || a.cluster % a.co || a.pos_b < 1 ||
      a.oc_b < 4 || a.oc_b % 4 || a.cs < 1 || a.ks < 1)
    return cudaErrorInvalidValue;
  // the parts cover the window's product exactly
  if ((a.cluster / a.co - 1) * a.pos_b >= a.th * a.tw ||
      (long long)(a.cluster / a.co) * a.pos_b < a.th * a.tw ||
      (a.co - 1) * a.oc_b >= a.oc || (long long)a.co * a.oc_b < a.oc)
    return cudaErrorInvalidValue;
  *s = wp::make_split(a.pos_b, a.oc_b, a.ks);
  if (!wp::split_ok(*s)) return cudaErrorInvalidValue;
  const long long bytes = layout(a, *s).total() * (long long)sizeof(float);
  if (bytes > wp::kSmemLimit) return cudaErrorInvalidValue;
  *smem = (int)bytes;
  return cudaSuccess;
}

cudaError_t configure(int cluster, int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      im2win_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cfg->blockDim = dim3(wp::kThreads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// cudaSuccess when the card can hold at least one cluster of `cluster`
// blocks of `smem` bytes each (cudaOccupancyMaxActiveClusters), else
// cudaErrorInvalidConfiguration.  The (cluster, smem) pairs found
// placeable are remembered, so the query is made once per pair.
cudaError_t check_placeable(int cluster, int smem) {
  static thread_local int placed_smem[9][4] = {};
  int* seen = placed_smem[cluster];
  for (int i = 0; i < 4; ++i)
    if (seen[i] == smem) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = configure(cluster, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cluster);
  int placeable = 0;
  err = cudaOccupancyMaxActiveClusters(&placeable, (void*)im2win_conv_kernel,
                                       &cfg);
  if (err != cudaSuccess) return err;
  if (placeable < 1) return cudaErrorInvalidConfiguration;
  for (int i = 3; i > 0; --i) seen[i] = seen[i - 1];
  seen[0] = smem;
  return cudaSuccess;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  x (b, h, w, c) and w (kh, kw, c, oc)
// contiguous f32, out (b, h - kh + 1, w - kw + 1, oc) contiguous f32; the
// window (th, tw) lies within the output.  (cluster, co, pos_b, oc_b, cs,
// ks) is cluster_split's plan: cluster blocks per grid step (at most 8),
// co channel parts, each block pos_b positions x oc_b channels, cs input
// channels staged at a time, ks thread groups splitting K.
//
// im2win_conv_f32 launches b x ⌈o_h/th⌉ x ⌈o_w/tw⌉ clusters on `stream`,
// writes the blocks it launched (gridDim.x) to *blocks and returns
// cudaGetLastError(); cudaErrorInvalidValue for a plan that does not
// cover the window or does not fit shared memory, and
// cudaErrorInvalidConfiguration when the card cannot place one cluster.
// ---------------------------------------------------------------------------
extern "C" int im2win_conv_f32(const float* x, const float* w, float* out,
                               int b, int h, int wd, int c, int kh, int kw,
                               int oc, int th, int tw, int cluster, int co,
                               int pos_b, int oc_b, int cs, int ks,
                               int* blocks, void* stream) {
  *blocks = 0;
  const ConvArgs a{b, h, wd, c, kh, kw, oc, th, tw, h - kh + 1, wd - kw + 1,
                   cluster, co, pos_b, oc_b, cs, ks};
  wp::Split s;
  int smem = 0;
  cudaError_t err = check_args(a, &s, &smem);
  if (err != cudaSuccess) return (int)err;
  err = check_placeable(cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = configure(cluster, smem, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  const long long steps = (long long)b * ((a.oh + th - 1) / th) *
                          ((a.ow + tw - 1) / tw);
  cfg.gridDim = dim3((unsigned)(steps * cluster));
  cfg.stream = (cudaStream_t)stream;
  const Layout l = layout(a, s);
  const ConvDivs dv{wp::FastDiv(tw), wp::FastDiv(l.pw), wp::FastDiv(l.cp),
                    wp::FastDiv(oc_b), wp::FastDiv(l.cp / 4),
                    wp::FastDiv(oc_b / 4)};
  err = cudaLaunchKernelEx(&cfg, im2win_conv_kernel, x, w, out, a, dv);
  if (err != cudaSuccess) return (int)err;
  *blocks = (int)cfg.gridDim.x;
  return (int)cudaGetLastError();
}
