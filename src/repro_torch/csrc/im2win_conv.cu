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
// clamped, y0 = min(i*th, o_h - th).  The launch keeps that contract: one
// block per grid step, the same clamp, so the blocks launched equal
// n_cycles(o_h, o_w, th, tw, B).  Clamped blocks overlap and write the
// same bits to the same outputs, a benign race.
//
// Inside a block.  A window chosen under the TPU's 4 MiB VMEM budget can
// hold up to 4096 outputs and a kernel of many hundred KB, past the 227 KB
// a Hopper block has.  So the block walks its tile in passes of 64
// positions x 64 output channels, each of its 256 threads holding a 4 x 4
// register tile, and stages the input channels in slices of cs: the
// window patch (th+kh-1) x (tw+kw-1) x cs and the weights kh x kw x cs x
// 64.  cs is the largest slice that fits the shared-memory budget: all of
// C for most of the paper's layers, two slices for CNN8-7, Incep-3b, 4d
// and 4e.  What is staged stays for the next pass when that pass needs
// the same slice (one slice of C and one of O: staged once a block).
//
// What bounds it.  At the paper's layers (cnn8, Inception 5x5, batch 8)
// the windows cover a whole image, so a launch is B = 8 blocks on 132 SMs:
// one SM's f32 FMA rate bounds each block, far below the card's.  The
// card-wide bound is the f32 rate for most of these layers.  Splitting the
// window across blocks breaks the grid contract; that redesign is later
// work, as are tensor cores (TF32 would not hold 1e-5 of max|y|).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int OS = 64;                 // output channels per pass
constexpr int PP = 64;                 // output positions per pass
constexpr int kSmemBudget = 220 * 1024;

struct ConvArgs {
  int b, h, w, c, kh, kw, oc, th, tw, oh, ow, cs;
};

__global__ void __launch_bounds__(kThreads)
im2win_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ out, ConvArgs a) {
  extern __shared__ float smem[];
  const int ph = a.th + a.kh - 1, pw = a.tw + a.kw - 1;
  const int CS = a.cs, KK = a.kh * a.kw;
  float* patch = smem;                 // ph*pw x CS, channel fastest
  float* ws = patch + ph * pw * CS;    // KK x CS x OS

  const int bi = blockIdx.z;
  const int y0 = min((int)blockIdx.y * a.th, a.oh - a.th);   // clamped
  const int x0 = min((int)blockIdx.x * a.tw, a.ow - a.tw);
  const float* xb = x + (long long)bi * a.h * a.w * a.c;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int npos = a.th * a.tw;

  int staged_c = -1, staged_o = -1;
  for (int o0 = 0; o0 < a.oc; o0 += OS) {
    for (int pos0 = 0; pos0 < npos; pos0 += PP) {
      int py[4], px[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pos = min(pos0 + ty + 16 * r, npos - 1);
        py[r] = pos / a.tw;
        px[r] = pos % a.tw;
      }
      float acc[4][4] = {};
      for (int c0 = 0; c0 < a.c; c0 += CS) {
        const int cn = min(CS, a.c - c0);
        const bool new_patch = c0 != staged_c;
        if (new_patch || o0 != staged_o) {        // uniform over the block
          __syncthreads();                        // reads of the old slice done
          if (new_patch) {
            for (int e = tid; e < ph * pw * cn; e += kThreads) {
              const int pix = e / cn, cc = e % cn;
              const int r = pix / pw, q = pix % pw;
              patch[pix * CS + cc] =
                  xb[((long long)(y0 + r) * a.w + x0 + q) * a.c + c0 + cc];
            }
          }
          for (int e = tid; e < KK * cn * OS; e += kThreads) {
            const int o = e % OS, rest = e / OS;
            const int cc = rest % cn, kk = rest / cn;
            ws[(kk * CS + cc) * OS + o] =
                o0 + o < a.oc
                    ? wt[((long long)kk * a.c + c0 + cc) * a.oc + o0 + o]
                    : 0.f;
          }
          staged_c = c0;
          staged_o = o0;
          __syncthreads();
        }
        for (int dy = 0; dy < a.kh; ++dy) {
          for (int dx = 0; dx < a.kw; ++dx) {
            const float* wk = ws + (dy * a.kw + dx) * CS * OS + tx;
            int base[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              base[r] = ((py[r] + dy) * pw + px[r] + dx) * CS;
            for (int cc = 0; cc < cn; ++cc) {
              float pv[4], wv[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) pv[r] = patch[base[r] + cc];
#pragma unroll
              for (int q = 0; q < 4; ++q) wv[q] = wk[cc * OS + 16 * q];
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[r][q] = fmaf(pv[r], wv[q], acc[r][q]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (pos0 + ty + 16 * r >= npos) continue;
        float* o_row = out + (((long long)bi * a.oh + y0 + py[r]) * a.ow +
                              x0 + px[r]) * a.oc;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = o0 + tx + 16 * q;
          if (o < a.oc) o_row[o] = acc[r][q];
        }
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).  x (b, h, w, c) and w (kh, kw, c, oc)
// contiguous f32, out (b, h - kh + 1, w - kw + 1, oc) contiguous f32; the
// window (th, tw) lies within the output.  Launches b x ⌈o_h/th⌉ x
// ⌈o_w/tw⌉ blocks on `stream` and returns cudaGetLastError();
// cudaErrorInvalidValue when not even one input channel of the window
// patch and weights fits in shared memory.
// ---------------------------------------------------------------------------
extern "C" int im2win_conv_f32(const float* x, const float* w, float* out,
                               int b, int h, int wd, int c, int kh, int kw,
                               int oc, int th, int tw, void* stream) {
  const int oh = h - kh + 1, ow = wd - kw + 1;
  if (b < 1 || c < 1 || oc < 1 || oh < 1 || ow < 1 || th < 1 || tw < 1 ||
      th > oh || tw > ow)
    return (int)cudaErrorInvalidValue;
  const long long per_c =
      (long long)(th + kh - 1) * (tw + kw - 1) + (long long)kh * kw * OS;
  long long cs = kSmemBudget / (long long)sizeof(float) / per_c;
  if (cs < 1) return (int)cudaErrorInvalidValue;
  if (cs > c) cs = c;
  const ConvArgs a{b, h, wd, c, kh, kw, oc, th, tw, oh, ow, (int)cs};
  const int smem = (int)(sizeof(float) * per_c * cs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        im2win_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((ow + tw - 1) / tw, (oh + th - 1) / th, b);
  im2win_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, a);
  return (int)cudaGetLastError();
}
