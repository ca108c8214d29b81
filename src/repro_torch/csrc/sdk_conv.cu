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
// all contiguous f32.  The wrapper zero-fills out before the launch (the
// counterpart of the TPU kernel's `@pl.when(wi == 0)` init) and sums the
// ar_c slots afterwards.
//
// Index space.  The TPU grid (ar_c, ac_c, nw) runs in order on one core;
// here its steps become blocks that run in parallel and in any order,
// and nothing carries from one block to the next.  Each channel pass
// writes its own slot of out, so no atomics are needed.  Clamped border
// windows overlap, so two blocks may write the same output element: both
// compute it from the same inputs in the same (dy, dx, c) order and store
// bit-identical values, so the race is benign.
//
// What bounds it.  Per output element the kernel does k_h*k_w*ic_t FMAs
// in f32 on the CUDA cores (no tensor cores: the f32 result must match
// the plain version to ~1e-5 relative), and each of those reads one x
// value and one w value.  At the main path's shapes (cnn8 at batch 8)
// the layers are small: a few MFLOP each, so a launch is bound by latency
// and by the card not being filled, not by bytes or FLOP/s.  The design
// keeps each thread on one output element with px fastest, so stores and
// x loads are coalesced along a row and the w load is a broadcast across
// the row's threads; the window kernel stages each window patch in shared
// memory so a patch is read from device memory once per block.  wgmma,
// TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

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
  int run;                        // window kernel: windows per block
};

static constexpr int kThreads = 256;

// Border-clamped origin of window wi (im2win_conv.py::_window_origin).
__device__ __forceinline__ void window_origin(const SdkGeom& g, int wi,
                                              int* y0, int* x0) {
  *y0 = min((wi / g.nx) * g.step_y, g.lim_y);
  *x0 = min((wi % g.nx) * g.step_x, g.lim_x);
}

// Offset of output element (ci, bi, oi*oc_t + o, y0/s + qy, x0/s + qx).
__device__ __forceinline__ size_t out_offset(const SdkGeom& g, int ci,
                                             int bi, int oc, int oy,
                                             int ox) {
  return ((((size_t)ci * g.b + bi) * g.oc_pad + oc) * g.o_h + oy) * g.o_w
         + ox;
}

// ---------------------------------------------------------------------------
// Whole kernel: x and out stay in device memory, read and written directly.
// grid = (ar_c*ac_c*nw, ceil(b / b_chunk)); blockIdx.x is the flat TPU grid
// step (ci, oi, wi), blockIdx.y a chunk of the batch.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sdk_whole_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, SdkGeom g) {
  const int step = blockIdx.x;
  const int wi = step % g.nw;
  const int oi = (step / g.nw) % g.ac_c;
  const int ci = step / (g.nw * g.ac_c);
  int y0, x0;
  window_origin(g, wi, &y0, &x0);
  const int b0 = blockIdx.y * g.b_chunk;
  const int nb = min(g.b_chunk, g.b - b0);
  const int per_img = g.oc_t * g.py * g.px;
  const size_t plane = (size_t)g.i_h * g.i_w;
  const size_t w_tap = (size_t)g.ic_pad * g.oc_pad;   // one (dy, dx) slice

  for (int e = threadIdx.x; e < nb * per_img; e += blockDim.x) {
    const int qx = e % g.px;
    const int qy = (e / g.px) % g.py;
    const int o = (e / (g.px * g.py)) % g.oc_t;
    const int bi = b0 + e / per_img;
    const float* xb = x + ((size_t)bi * g.ic_pad + (size_t)ci * g.ic_t) * plane
                      + (size_t)(y0 + qy * g.s) * g.i_w + (x0 + qx * g.s);
    const float* wb = w + (size_t)ci * g.ic_t * g.oc_pad
                      + (size_t)oi * g.oc_t + o;
    float acc = 0.f;
    for (int dy = 0; dy < g.k_h; ++dy) {
      for (int dx = 0; dx < g.k_w; ++dx) {
        const float* xp = xb + (size_t)dy * g.i_w + dx;
        const float* wp = wb + (size_t)(dy * g.k_w + dx) * w_tap;
        for (int c = 0; c < g.ic_t; ++c) {
          acc = fmaf(xp[c * plane], wp[(size_t)c * g.oc_pad], acc);
        }
      }
    }
    out[out_offset(g, ci, bi, oi * g.oc_t + o, y0 / g.s + qy,
                   x0 / g.s + qx)] = acc;
  }
}

// ---------------------------------------------------------------------------
// Window kernel: each block walks `run` consecutive windows of one
// (ci, oi) pass for one batch chunk.  The window patch
// (b_chunk, ic_t, pw_h, pw_w) is staged into one of two shared-memory
// slots with cp.async; the copy of window t+1 is in flight while window t
// is computed (the TPU kernel's two VMEM slots and DMA semaphores).
// Output tiles are stored straight to device memory: on this card a
// coalesced store needs no staging slot.
// grid = (ar_c*ac_c, ceil(nw / run), ceil(b / b_chunk)).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Issue the asynchronous copy of window wi's patch into `slot`.
__device__ __forceinline__ void stage_patch(const SdkGeom& g,
                                            const float* __restrict__ x,
                                            float* slot, int ci, int wi,
                                            int b0, int nb) {
  int y0, x0;
  window_origin(g, wi, &y0, &x0);
  const int row = g.pw_w;
  const int img = g.ic_t * g.pw_h * g.pw_w;
  const size_t plane = (size_t)g.i_h * g.i_w;
  for (int e = threadIdx.x; e < nb * img; e += blockDim.x) {
    const int xx = e % row;
    const int yy = (e / row) % g.pw_h;
    const int c = (e / (row * g.pw_h)) % g.ic_t;
    const int bb = e / img;
    const float* src = x + ((size_t)(b0 + bb) * g.ic_pad
                            + (size_t)ci * g.ic_t + c) * plane
                       + (size_t)(y0 + yy) * g.i_w + (x0 + xx);
    cp_async4(slot + e, src);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
sdk_window_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, SdkGeom g) {
  extern __shared__ float smem[];
  const int ci = blockIdx.x / g.ac_c;
  const int oi = blockIdx.x % g.ac_c;
  const int w_begin = blockIdx.y * g.run;
  const int w_end = min(w_begin + g.run, g.nw);
  const int b0 = blockIdx.z * g.b_chunk;
  const int nb = min(g.b_chunk, g.b - b0);
  const int img = g.ic_t * g.pw_h * g.pw_w;
  const int slot_elems = g.b_chunk * img;
  const int per_img = g.oc_t * g.py * g.px;
  const size_t w_tap = (size_t)g.ic_pad * g.oc_pad;
  const int cstride = g.pw_h * g.pw_w;

  stage_patch(g, x, smem, ci, w_begin, b0, nb);            // prologue
  for (int wi = w_begin; wi < w_end; ++wi) {
    const float* cur = smem + ((wi - w_begin) & 1) * slot_elems;
    if (wi + 1 < w_end) {
      // the other slot was last read in the previous iteration, which
      // ended in __syncthreads(): it is free to overwrite
      stage_patch(g, x, smem + ((wi + 1 - w_begin) & 1) * slot_elems, ci,
                  wi + 1, b0, nb);
      cp_async_wait<1>();          // this window's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    int y0, x0;
    window_origin(g, wi, &y0, &x0);
    for (int e = threadIdx.x; e < nb * per_img; e += blockDim.x) {
      const int qx = e % g.px;
      const int qy = (e / g.px) % g.py;
      const int o = (e / (g.px * g.py)) % g.oc_t;
      const int bb = e / per_img;
      const float* xb = cur + bb * img + (qy * g.s) * g.pw_w + qx * g.s;
      const float* wb = w + (size_t)ci * g.ic_t * g.oc_pad
                        + (size_t)oi * g.oc_t + o;
      float acc = 0.f;
      for (int dy = 0; dy < g.k_h; ++dy) {
        for (int dx = 0; dx < g.k_w; ++dx) {
          const float* xp = xb + dy * g.pw_w + dx;
          const float* wp = wb + (size_t)(dy * g.k_w + dx) * w_tap;
          for (int c = 0; c < g.ic_t; ++c) {
            acc = fmaf(xp[c * cstride], wp[(size_t)c * g.oc_pad], acc);
          }
        }
      }
      out[out_offset(g, ci, b0 + bb, oi * g.oc_t + o, y0 / g.s + qy,
                     x0 / g.s + qx)] = acc;
    }
    __syncthreads();               // every read of `cur` is done
  }
}

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and only this
// return value reports it.
// ---------------------------------------------------------------------------
extern "C" int sdk_conv_whole(const float* x, const float* w, float* out,
                              const SdkGeom* geom, void* stream) {
  const SdkGeom g = *geom;
  const dim3 grid(g.ar_c * g.ac_c * g.nw, (g.b + g.b_chunk - 1) / g.b_chunk);
  sdk_whole_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, w, out,
                                                                 g);
  return (int)cudaGetLastError();
}

extern "C" int sdk_conv_window(const float* x, const float* w, float* out,
                               const SdkGeom* geom, int smem_bytes,
                               void* stream) {
  const SdkGeom g = *geom;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdk_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(g.ar_c * g.ac_c, (g.nw + g.run - 1) / g.run,
                  (g.b + g.b_chunk - 1) / g.b_chunk);
  sdk_window_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      x, w, out, g);
  return (int)cudaGetLastError();
}
