// Mapping-driven SDK convolution on Hopper (sm_90a), f32.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/im2win_conv.py::sdk_conv_traced:
//
//   sdk_whole_kernel  <- _sdk_kernel          (block="whole")
//   sdk_window_kernel <- _sdk_kernel_blocked  (block="window")
//
// Both compute, for one (group, tile) of a LayerMapping, the tile's
// channel-pass partial sums
//
//   out[ci, b, oi*oc_t + o, y0/s + qy, x0/s + qx] =
//       sum_{dy, dx, c} x[b, ci*ic_t + c, y0 + qy*s + dy, x0 + qx*s + dx]
//                       * w[dy, dx, ci*ic_t + c, oi*oc_t + o]
//
// over every window load (ci, oi, wi) of the tile: ci the channel pass
// (ar_c of them), oi the oc pass (ac_c), wi the window of the ceil-form
// raster (nw = ny*nx), whose origin (y0, x0) is border-clamped to the
// stride grid exactly as _window_origin does.  x is (b, ic_pad, i_h, i_w),
// w is (k_h, k_w, ic_pad, oc_pad) and out is (ar_c, b, oc_pad, o_h, o_w),
// all contiguous f32.  Where the window raster writes every output
// position (TileGeom.covers_output: every served mapping) the wrapper
// leaves out uninitialised; elsewhere it zero-fills it (the counterpart of
// the TPU kernel's `@pl.when(wi == 0)` init).  It sums the ar_c slots
// afterwards.
//
// Index space.  The TPU grid (ar_c, ac_c, nw) runs in order on one core;
// here its steps become blocks that run in parallel and in any order,
// and nothing carries from one block to the next.  Each channel pass
// writes its own slot of out, so no atomics are needed.  Clamped border
// windows overlap, so two blocks may write the same output element: both
// compute it from the same inputs in the same (dy, dx, c) order and store
// bit-identical values, so the race is benign.
//
// What bounds it.  Per output element the kernels do k_h*k_w*ic_t FMAs
// in f32 on the CUDA cores (no tensor cores: the f32 result must match
// the plain version to ~1e-5 relative).  At the main path's shapes (cnn8
// at batch 8) the layers are small: a few MFLOP each, so a launch is
// bound by latency and by the card not being filled, not by bytes or
// FLOP/s.  Both kernels are therefore laid out to fill the card, and both
// run one block body, window_block: the block stages its kernel block
// (k_h*k_w x ic_t x oc_b columns) in shared memory once and a window
// patch at a time with cp.async, and runs window_product.cuh's
// register-tiled product (which im2win_conv.cu shares), its rows the
// (image, output position) pairs of the window at stride s.  What the two
// kernels differ in is what a block owns, as the TPU's whole-array block
// differs from its blocked one:
//
//   sdk_whole_kernel   one window (one TPU grid step), so one patch slot
//                      and no double buffer; kernels/sdk_conv.py::
//                      whole_launch_dims splits oc_t into column parts
//                      until a launch has about 132 blocks, and past two
//                      waves gives a block several images;
//   sdk_window_kernel  a run of consecutive windows, the copy of window
//                      t+1 in flight in a second slot while window t is
//                      computed (the TPU kernel's two VMEM slots and DMA
//                      semaphores); window_launch_dims takes runs only
//                      past two waves of blocks.
//
// A third kernel runs the same body on a mapping's window list instead of
// the raster (the `reference` executor's layers, whose Alg 4 marginal
// windows the raster cannot express):
//
//   sdk_placed_kernel  one launch per (tile, window shape) of
//                      cnn/cim_conv.py::placement_groups, every group of
//                      the layer in its grid; the origins come from a
//                      device table, x and the kernel are read at the
//                      group's and the tile's channel offsets, the tile's
//                      channel passes are one contraction of a block
//                      (ic_t = the tile's kept channels), and the block
//                      stores into the (b, oc, o_h, o_w) output at the
//                      group's channels.  Windows of one launch that
//                      overlap store equal bits, as above; across shapes
//                      the launches run in placement order, so the last
//                      shape that writes a position wins, the writer
//                      cim_conv.py::kept_writes keeps.
//
// wgmma, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_product.cuh"

// Geometry of one (group, tile) launch; mirrors SdkGeom in
// src/repro_torch/kernels/sdk_conv.py field for field.
struct SdkGeom {
  int b, ic_pad, i_h, i_w;        // x: (b, ic_pad, i_h, i_w)
  int oc_pad, o_h, o_w;           // out: (ar_c, b, oc_pad, o_h, o_w)
  int ar_c, ac_c, ic_t, oc_t;     // channel / oc passes and their widths
  int k_h, k_w, s;                // kernel and stride
  int pw_h, pw_w, py, px;         // window patch and its output tile
  int step_y, step_x, nx, nw;     // ceil-form window raster
  int lim_y, lim_x;               // border clamps (on the stride grid)
  int b_chunk;                    // images per block
  int run;                        // windows per block (1: whole kernel)
  int oc_b;                       // oc columns per block
  int ks;                         // thread groups on K
};

// Border-clamped origin of window wi (im2win_conv.py::_window_origin).
__device__ __forceinline__ void window_origin(const SdkGeom& g, int wi,
                                              int* y0, int* x0) {
  *y0 = min((wi / g.nx) * g.step_y, g.lim_y);
  *x0 = min((wi % g.nx) * g.step_x, g.lim_x);
}

// Where a block's windows and input channels come from: the template
// parameter of window_block, so that each kernel compiles to the code of
// its own source alone.
//
// RasterWindows: sdk_whole / sdk_window, the ceil-form raster; channel
// pass ci reads channels ci*ic_t.. of x (ic_pad channels) and rows
// ci*ic_t.. of w (ic_pad rows).
struct RasterWindows {
  __device__ __forceinline__ void origin(const SdkGeom& g, int wi, int* y0,
                                         int* x0) const {
    window_origin(g, wi, y0, x0);
  }
  __device__ __forceinline__ size_t x_channel(const SdkGeom& g, int ci,
                                              int) const {
    return (size_t)ci * g.ic_t;
  }
  __device__ __forceinline__ size_t w_row(const SdkGeom& g, int ci) const {
    return (size_t)ci * g.ic_t;
  }
  __device__ __forceinline__ int w_rows(const SdkGeom& g) const {
    return g.ic_pad;
  }
};

// PlacedWindows: sdk_placed, a table of (y, x) origins.  Its oc pass oi
// is the group: x holds all groups' channels (ic_pad = ic), the group's
// from oi * ic_g on; w is the grouped (k_h, k_w, ic_g, oc) kernel, whose
// oc_pad = oc columns are the groups' oc_t = oc / G each.  The tile
// starts at channel c_base of its group.
struct PlacedWindows {
  const int* yx;                  // (nw, 2) origins (y, x)
  int ic_g;                       // input channels a group: ic / G
  int c_base;                     // the tile's first channel in a group
  __device__ __forceinline__ void origin(const SdkGeom&, int wi, int* y0,
                                         int* x0) const {
    *y0 = __ldg(yx + 2 * wi);
    *x0 = __ldg(yx + 2 * wi + 1);
  }
  __device__ __forceinline__ int x_channel(const SdkGeom& g, int ci,
                                           int oi) const {
    return oi * ic_g + c_base + ci * g.ic_t;
  }
  __device__ __forceinline__ int w_row(const SdkGeom& g, int ci) const {
    return c_base + ci * g.ic_t;
  }
  __device__ __forceinline__ int w_rows(const SdkGeom&) const {
    return ic_g;
  }
};

// Offset of output element (ci, bi, oi*oc_t + o, y0/s + qy, x0/s + qx).
__device__ __forceinline__ size_t out_offset(const SdkGeom& g, int ci,
                                             int bi, int oc, int oy,
                                             int ox) {
  return ((((size_t)ci * g.b + bi) * g.oc_pad + oc) * g.o_h + oy) * g.o_w
         + ox;
}

// Shared-memory layout of one block, in floats.
struct WinLayout {
  int cp, pix, img;                   // staged channels, pixel stride, image
  long long slot, slots, ws, scratch;
  __host__ __device__ long long total() const {
    return slot * slots + ws + scratch;
  }
};

__host__ __device__ inline wp::Split win_split(const SdkGeom& g) {
  return wp::make_split(g.b_chunk * g.py * g.px, g.oc_b, g.ks);
}

__host__ __device__ inline WinLayout win_layout(const SdkGeom& g) {
  WinLayout l;
  l.cp = wp::round4(g.ic_t);
  l.pix = wp::pixel_stride(l.cp);
  l.img = g.pw_h * g.pw_w * l.pix;
  l.slot = (long long)g.b_chunk * l.img;
  l.slots = g.run > 1 ? 2 : 1;
  l.ws = (long long)g.k_h * g.k_w * l.cp * g.oc_b;
  l.scratch = wp::scratch_floats(win_split(g));
  return l;
}

// Divisors of the block body's index arithmetic, built on the host.
struct WinDivs {
  wp::FastDiv pw_w, pw_h, ic_t, oc_b, ob4, cp, per_img, px, pad;
};

// Issue the asynchronous copy of window wi's patch into `slot`: x is read
// along rows (coalesced), the slot holds channels fastest.
template <class Windows>
__device__ __forceinline__ void stage_patch(const SdkGeom& g,
                                            const WinLayout& l,
                                            const WinDivs& dv,
                                            const Windows& src,
                                            const float* __restrict__ x,
                                            float* slot, int ci, int oi,
                                            int wi, int b0, int nb) {
  int y0, x0;
  src.origin(g, wi, &y0, &x0);
  const int row = g.pw_w;
  const int img = g.ic_t * g.pw_h * g.pw_w;
  const size_t plane = (size_t)g.i_h * g.i_w;
  for (int e = threadIdx.x; e < nb * img; e += blockDim.x) {
    const int r1 = dv.pw_w.div(e), xx = e - r1 * row;
    const int r2 = dv.pw_h.div(r1), yy = r1 - r2 * g.pw_h;
    const int bb = dv.ic_t.div(r2), c = r2 - bb * g.ic_t;
    const float* from = x + ((size_t)(b0 + bb) * g.ic_pad
                             + src.x_channel(g, ci, oi) + c) * plane
                        + (size_t)(y0 + yy) * g.i_w + (x0 + xx);
    wp::cp_async4(slot + bb * l.img + (yy * row + xx) * l.pix + c, from);
  }
  wp::cp_async_commit();
}

// ---------------------------------------------------------------------------
// The block body of the three kernels: columns [part*oc_b, part*oc_b +
// oc_b) of the oc_t columns of pass (ci, oi), for windows [w_begin, w_end)
// and the images [b0, b0 + b_chunk).  It stages its kernel block (k_h*k_w
// x ic_t x oc_b) in shared memory once, and each window's patch, b_chunk
// images of (pw_h, pw_w, ic_t) channel fastest, with cp.async; with more
// than one window the copy of window t+1 is in flight in a second slot
// while window t is computed.  The product is window_product.cuh's; output
// tiles are stored straight to device memory.  `src` says where the
// windows' origins and the pass's channels are.
// ---------------------------------------------------------------------------
template <class Windows>
__device__ __forceinline__ void window_block(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             float* __restrict__ out,
                                             const SdkGeom& g,
                                             const WinDivs& dv,
                                             const Windows& src, float* smem,
                                             int ci, int oi, int part,
                                             int w_begin, int w_end,
                                             int b0) {
  const wp::Split s = win_split(g);
  const WinLayout l = win_layout(g);
  float* ws = smem + l.slot * l.slots;
  float* scratch = ws + l.ws;
  const int o_lo = part * g.oc_b;
  const int o_hi = min(g.oc_t, o_lo + g.oc_b);
  const int nb = min(g.b_chunk, g.b - b0);
  const int per_img = g.py * g.px;
  const int rows = nb * per_img;
  const int kk_n = g.k_h * g.k_w;
  const int tid = threadIdx.x;
  const size_t plane_out = (size_t)g.o_h * g.o_w;   // one output channel

  // the kernel block (copied with the first patch), zero past ic_t and
  // o_hi; 16-byte copies where the columns come in fours
  const size_t w_col = (size_t)src.w_row(g, ci) * g.oc_pad
                       + (size_t)oi * g.oc_t + o_lo;
  if (g.oc_t % 4 == 0 && g.oc_pad % 4 == 0) {
    const int ob4 = g.oc_b / 4;
    for (int e = tid; e < kk_n * l.cp * ob4; e += wp::kThreads) {
      const int rest = dv.ob4.div(e), o = 4 * (e - rest * ob4);
      const int kk = dv.cp.div(rest), c = rest - kk * l.cp;
      float* dst = ws + rest * g.oc_b + o;
      if (c < g.ic_t && o_lo + o < o_hi)
        wp::cp_async16(dst, w + w_col + ((size_t)kk * src.w_rows(g) + c)
                                            * g.oc_pad + o);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0, 0, 0, 0);
    }
  } else {
    for (int e = tid; e < kk_n * l.cp * g.oc_b; e += wp::kThreads) {
      const int rest = dv.oc_b.div(e), o = e - rest * g.oc_b;
      const int kk = dv.cp.div(rest), c = rest - kk * l.cp;
      if (c < g.ic_t && o_lo + o < o_hi)
        wp::cp_async4(ws + e, w + w_col + ((size_t)kk * src.w_rows(g) + c)
                                              * g.oc_pad + o);
      else
        ws[e] = 0.f;
    }
  }
  stage_patch(g, l, dv, src, x, smem, ci, oi, w_begin, b0, nb);  // prologue
  // the channels past ic_t of every staged pixel are zero
  const int pad = l.cp - g.ic_t;
  if (pad > 0) {
    const int n_pix = (int)(l.slot * l.slots / l.pix);
    for (int e = tid; e < n_pix * pad; e += wp::kThreads) {
      const int pixel = dv.pad.div(e);
      smem[pixel * l.pix + g.ic_t + e - pixel * pad] = 0.f;
    }
  }

  for (int wi = w_begin; wi < w_end; ++wi) {
    const float* cur = smem + ((wi - w_begin) & 1) * l.slot;
    if (wi + 1 < w_end) {
      // the other slot was last read in the previous iteration, which
      // ended in __syncthreads(): it is free to overwrite
      stage_patch(g, l, dv, src, x,
                  smem + ((wi + 1 - w_begin) & 1) * l.slot, ci, oi, wi + 1,
                  b0, nb);
      wp::cp_async_wait<1>();      // this window's group has landed
    } else {
      wp::cp_async_wait<0>();
    }
    __syncthreads();

    int y0, x0;
    src.origin(g, wi, &y0, &x0);
    const int oy0 = y0 / g.s, ox0 = x0 / g.s;
    for (int p = 0; p < s.passes; ++p) {
      const int t = s.ks > 1 ? tid % s.nt : tid + p * wp::kThreads;
      const int kg = s.ks > 1 ? tid / s.nt : 0;
      const bool active = s.ks > 1 ? tid < s.nt * s.ks : t < s.nt;
      int tp, to;
      wp::tile_of(t, s, &tp, &to);
      int base[wp::RP];
#pragma unroll
      for (int r = 0; r < wp::RP; ++r) {
        const int m = min(tp + s.ntp * r, rows - 1);        // clamp: load only
        const int bb = dv.per_img.div(m), q = m - bb * per_img;
        const int qy = dv.px.div(q), qx = q - qy * g.px;
        base[r] = bb * l.img + (qy * g.s * g.pw_w + qx * g.s) * l.pix;
      }
      float acc[wp::RP][wp::RO] = {};
      if (active) {
        int j0, j1;
        wp::k_range(kk_n * (l.cp / 4), kg, s.ks, &j0, &j1);
        wp::product(cur, ws + wp::RO * to, base, l.cp / 4, l.cp, g.oc_b,
                    g.k_w, g.pw_w * l.pix, l.pix, j0, j1, acc);
      }
      wp::reduce_groups(scratch, s, t, kg, active, acc);
      if (active && kg == 0) {
#pragma unroll
        for (int r = 0; r < wp::RP; ++r) {
          const int m = tp + s.ntp * r;
          if (m >= rows) continue;
          const int bb = dv.per_img.div(m), q = m - bb * per_img;
          const int qy = dv.px.div(q), qx = q - qy * g.px;
          const size_t o0 = out_offset(g, ci, b0 + bb, oi * g.oc_t + o_lo,
                                       oy0 + qy, ox0 + qx);
#pragma unroll
          for (int u = 0; u < wp::RO; ++u) {
            const int o = wp::RO * to + u;
            if (o_lo + o < o_hi) out[o0 + (size_t)o * plane_out] = acc[r][u];
          }
        }
      }
    }
    __syncthreads();               // every read of `cur` is done
  }
}

// ---------------------------------------------------------------------------
// Whole kernel: one block per (TPU grid step, column part, image chunk).
// grid = (ar_c*ac_c*nw, parts, ceil(b / b_chunk)) with parts =
// ceil(oc_t / oc_b); blockIdx.x is the flat step (ci, oi, wi), so
// blocks == steps x parts x chunks.  Up to 255 registers (one block an SM
// by registers): at 128 the body spills, and a served launch has at most
// one block an SM anyway.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wp::kThreads, 1)
sdk_whole_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, SdkGeom g, WinDivs dv) {
  extern __shared__ float4 smem4[];
  const int step = blockIdx.x;
  const int pass = step / g.nw, wi = step - pass * g.nw;
  window_block(x, w, out, g, dv, RasterWindows(),
               reinterpret_cast<float*>(smem4), pass / g.ac_c, pass % g.ac_c,
               blockIdx.y, wi, wi + 1, blockIdx.z * g.b_chunk);
}

// ---------------------------------------------------------------------------
// Window kernel: one block per (pass, column part, run of windows, image
// chunk).  grid = (ar_c*ac_c*parts, ceil(nw / run), ceil(b / b_chunk)).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wp::kThreads)
sdk_window_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, SdkGeom g, WinDivs dv) {
  extern __shared__ float4 smem4[];
  const int parts = (g.oc_t + g.oc_b - 1) / g.oc_b;
  const int pass = blockIdx.x / parts;
  const int w_begin = blockIdx.y * g.run;
  window_block(x, w, out, g, dv, RasterWindows(),
               reinterpret_cast<float*>(smem4), pass / g.ac_c, pass % g.ac_c,
               blockIdx.x % parts, w_begin, min(w_begin + g.run, g.nw),
               blockIdx.z * g.b_chunk);
}

// ---------------------------------------------------------------------------
// Placed kernel: the window kernel's grid over the windows of a table, one
// (tile, window shape) of a mapping a launch, its oc passes the layer's
// groups.  grid = (ac_c*parts, ceil(nw / run), ceil(b / b_chunk)) with
// ar_c = 1.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(wp::kThreads)
sdk_placed_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, SdkGeom g, WinDivs dv,
                  PlacedWindows src) {
  extern __shared__ float4 smem4[];
  const int parts = (g.oc_t + g.oc_b - 1) / g.oc_b;
  const int pass = blockIdx.x / parts;
  const int w_begin = blockIdx.y * g.run;
  window_block(x, w, out, g, dv, src, reinterpret_cast<float*>(smem4),
               pass / g.ac_c, pass % g.ac_c, blockIdx.x % parts, w_begin,
               min(w_begin + g.run, g.nw), blockIdx.z * g.b_chunk);
}

// The shared memory of a block of layout g, in bytes, or -1 when
// (b_chunk, run, oc_b, ks) do not make a block that fits 227 KB (or a
// whole-kernel layout has a run).
static int block_smem(const SdkGeom& g, bool whole) {
  if (g.b_chunk < 1 || g.run < 1 || (whole && g.run != 1) || g.oc_b < 4 ||
      g.oc_b % 4 || !wp::split_ok(win_split(g)))
    return -1;
  const long long smem = win_layout(g).total() * (long long)sizeof(float);
  return smem > wp::kSmemLimit ? -1 : (int)smem;
}

static WinDivs make_divs(const SdkGeom& g) {
  const int cp = wp::round4(g.ic_t);
  return WinDivs{wp::FastDiv(g.pw_w), wp::FastDiv(g.pw_h),
                 wp::FastDiv(g.ic_t), wp::FastDiv(g.oc_b),
                 wp::FastDiv(g.oc_b / 4), wp::FastDiv(cp),
                 wp::FastDiv(g.py * g.px), wp::FastDiv(g.px),
                 wp::FastDiv(cp > g.ic_t ? cp - g.ic_t : 1)};
}

static cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and only this
// return value reports it.  Each returns cudaErrorInvalidValue when
// (b_chunk, run, oc_b, ks) do not make a block that fits 227 KB of shared
// memory; the whole kernel's layout must have run == 1.
// ---------------------------------------------------------------------------
extern "C" int sdk_conv_whole(const float* x, const float* w, float* out,
                              const SdkGeom* geom, int* blocks,
                              void* stream) {
  const SdkGeom g = *geom;
  const int smem = block_smem(g, true);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem((const void*)sdk_whole_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.ar_c * g.ac_c * g.nw, (g.oc_t + g.oc_b - 1) / g.oc_b,
                  (g.b + g.b_chunk - 1) / g.b_chunk);
  sdk_whole_kernel<<<grid, wp::kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, g, make_divs(g));
  *blocks = (int)(grid.x * grid.y * grid.z);
  return (int)cudaGetLastError();
}

extern "C" int sdk_conv_window(const float* x, const float* w, float* out,
                               const SdkGeom* geom, void* stream) {
  const SdkGeom g = *geom;
  const int smem = block_smem(g, false);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem((const void*)sdk_window_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.ar_c * g.ac_c * ((g.oc_t + g.oc_b - 1) / g.oc_b),
                  (g.nw + g.run - 1) / g.run,
                  (g.b + g.b_chunk - 1) / g.b_chunk);
  sdk_window_kernel<<<grid, wp::kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, g, make_divs(g));
  return (int)cudaGetLastError();
}

// One (tile, window shape) of a mapping: the nw origins at yx (device
// memory, (y, x) pairs), x (b, ic_pad, i_h, i_w) read at channel
// oi*ic_g + c_base + c of group oi, w (k_h, k_w, ic_g, oc_pad) at row
// c_base + c, and out (b, oc_pad, o_h, o_w).
extern "C" int sdk_conv_placed(const float* x, const float* w, float* out,
                               const SdkGeom* geom, const int* yx, int ic_g,
                               int c_base, void* stream) {
  const SdkGeom g = *geom;
  const int smem = block_smem(g, false);
  if (smem < 0 || g.ar_c != 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem((const void*)sdk_placed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.ac_c * ((g.oc_t + g.oc_b - 1) / g.oc_b),
                  (g.nw + g.run - 1) / g.run,
                  (g.b + g.b_chunk - 1) / g.b_chunk);
  sdk_placed_kernel<<<grid, wp::kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, g, make_divs(g), PlacedWindows{yx, ic_g, c_base});
  return (int)cudaGetLastError();
}
