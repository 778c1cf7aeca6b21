// Triangle rasterizer for Hopper (sm_90a): the two pass-2 modes of the
// ArtiBoost tile rasterizer, sharing one pass 1.
//
// Replaces: artiboost_tpu/ops/rasterizer_pallas.py `_raster_kernel` with
// `_tile_core` (pass 1 :140-170), in both of its modes:
//   * raster_uv_kernel  - uv_mode=True, uv pass 2 :178-199 (kernel B1);
//   * raster_rgb_kernel - uv_mode=False, Gouraud `color_body` :201-219 and
//     the `* (1/255)` of `_raster_kernel` :257-260 (kernel B2).
//
// Contract (bit-exact with the plain PyTorch twins `rasterize_batch_uv_torch`
// and `rasterize_batch_rgb_torch` in artiboost_torch/ops/rasterizer_cuda.py):
//   * faces arrive y-sorted (stable) and packed in chunks of 128 lanes,
//     each chunk 16 plane rows: geom = [ea0 ea1 eb0 eb1 ec0' ec1 wa wb wc],
//     col = the attribute planes in edge-major order (ea.c0..c(A-1),
//     eb.c0.., ec.c0..) with A = 4 (u, v, shade, page) or A = 3 (r, g, b);
//     invalid faces carry ec0' = -1e30 so they never pass the inside test;
//   * pass 1: a pixel is inside face f when min(lam0, lam1, lam2) >= -1e-6
//     and w = 1/z > 0; the depth key is w's bits with the low 7 mantissa
//     bits replaced by the lane id. The largest key wins; ties across
//     chunks keep the EARLIER chunk (strict >), which a sequential scan in
//     sorted order with strict > reproduces exactly (keys inside a chunk
//     are distinct because the lane ids differ);
//   * uv pass 2 evaluates only the winning face's u, v, shade, page planes
//     and packs u12*4096+v12 and page8*65536+(shade/4)*65535;
//   * rgb pass 2 evaluates the winner's r, g, b planes, quantises each to
//     floor(clip(c * depth, 0, 1) * 255 + 0.5) and writes it times the
//     float32 constant 1/255 (a multiply, not a division by 255). The TPU
//     kernel packs the three 8-bit values into one float for its one-hot
//     lane sum and unpacks them again; both steps are exact, so the
//     unpacked values are the quantised ones this kernel writes directly;
//   * every a*b+c is rounded twice (__fmul_rn/__fadd_rn): nvcc would
//     otherwise contract it into an FMA and change the bits.
//
// What bounds it on this card: pass 1 is FP32 work, pixels x chunks in the
// tile's y-range x 128 lanes x ~25 operations, against 67 TFLOP/s of
// non-tensor FP32; the outputs are a few 32-bit words per pixel. The design
// keeps the face planes of the chunk being scanned in shared memory (one
// cooperative 4.6 KB load per chunk, read back as broadcasts) and the
// per-pixel best key in registers, so device memory is touched once per
// chunk per block and once per output word. One thread per pixel, one
// block per (pixel tile, image); the block loads its own
// [chunk_start, chunk_end) from the range table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;      // faces per chunk
constexpr int kRows = 16;       // plane rows per chunk
constexpr int kGeomRows = 9;    // geometry rows actually read in pass 1
constexpr int kLaneMask = 0x7F; // low 7 mantissa bits carry the lane id
constexpr int kTilePx = 256;    // pixels per tile = threads per block
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), as the TPU kernel multiplies

__device__ __forceinline__ float plane(float x, float y, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Winner {
  int key;    // (1/z bits & ~0x7F) | lane, 0 = background
  int chunk;  // sorted chunk of the winning face
};

// Pass 1 for the pixel (x, y) of this thread over the chunks [c_start, c_end)
// of one image. Every thread of the block must call it: it stages each chunk
// in s_geom between two barriers.
__device__ __forceinline__ Winner nearest_face(float (*s_geom)[kLane], const float* geom_b,
                                               int c_start, int c_end, float x, float y) {
  Winner w{0, 0};
  for (int c = c_start; c < c_end; ++c) {
    const float* g = geom_b + (size_t)c * kRows * kLane;
    for (int i = threadIdx.x; i < kGeomRows * kLane; i += kTilePx) {
      s_geom[i / kLane][i % kLane] = g[i];
    }
    __syncthreads();
    for (int l = 0; l < kLane; ++l) {
      const float lam0 = plane(x, y, s_geom[0][l], s_geom[2][l], s_geom[4][l]);
      const float lam1 = plane(x, y, s_geom[1][l], s_geom[3][l], s_geom[5][l]);
      const float lam2 = __fsub_rn(__fsub_rn(1.0f, lam0), lam1);
      const float wz = plane(x, y, s_geom[6][l], s_geom[7][l], s_geom[8][l]);
      const int wbits = __float_as_int(wz);
      const bool hit = (lam0 >= -1e-6f) && (lam1 >= -1e-6f) && (lam2 >= -1e-6f) &&
                       (wbits > 0);
      const int key = (wbits & ~kLaneMask) | l;
      if (hit && key > w.key) {
        w.key = key;
        w.chunk = c;
      }
    }
    __syncthreads();
  }
  return w;
}

__device__ __forceinline__ float depth_of(const Winner& w) {
  const float w_rec = __int_as_float(w.key & ~kLaneMask);
  return w.key > 0 ? __fdiv_rn(1.0f, fmaxf(w_rec, 1e-30f)) : 0.0f;
}

__global__ void raster_uv_kernel(const int* __restrict__ ranges,   // (B, T, 2)
                                 const float* __restrict__ geom,   // (B, NC, 16, 128)
                                 const float* __restrict__ col,    // (B, NC, 16, 128)
                                 float* __restrict__ quv,          // (B, H*W)
                                 float* __restrict__ qsp,          // (B, H*W)
                                 int* __restrict__ win,            // (B, H*W) sorted id
                                 float* __restrict__ depth_out,    // (B, H*W)
                                 int n_chunks, int n_tiles, int n_pix, int width) {
  __shared__ float s_geom[kGeomRows][kLane];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int pix = t * kTilePx + threadIdx.x;
  const float x = (float)(pix % width) + 0.5f;
  const float y = (float)(pix / width) + 0.5f;
  const Winner w = nearest_face(s_geom, geom + (size_t)b * n_chunks * kRows * kLane,
                                ranges[(b * n_tiles + t) * 2],
                                ranges[(b * n_tiles + t) * 2 + 1], x, y);
  if (pix >= n_pix) return;

  const float depth = depth_of(w);
  const int lane = w.key & kLaneMask;
  float out_quv = 0.0f;
  float out_qsp = 0.0f;
  if (w.key > 0) {
    const float* fc = col + ((size_t)(b * n_chunks + w.chunk) * kRows) * kLane + lane;
    const float u = plane(x, y, fc[0 * kLane], fc[4 * kLane], fc[8 * kLane]);
    const float v = plane(x, y, fc[1 * kLane], fc[5 * kLane], fc[9 * kLane]);
    const float s = plane(x, y, fc[2 * kLane], fc[6 * kLane], fc[10 * kLane]);
    const float p = plane(x, y, fc[3 * kLane], fc[7 * kLane], fc[11 * kLane]);
    const float qu = floorf(__fadd_rn(__fmul_rn(clip(__fmul_rn(u, depth), 0.0f, 1.0f), 4095.0f), 0.5f));
    const float qv = floorf(__fadd_rn(__fmul_rn(clip(__fmul_rn(v, depth), 0.0f, 1.0f), 4095.0f), 0.5f));
    out_quv = __fadd_rn(__fmul_rn(qu, 4096.0f), qv);
    const float qp = floorf(__fadd_rn(clip(__fmul_rn(p, depth), 0.0f, 255.0f), 0.5f));
    const float ts = clip(__fmul_rn(__fmul_rn(s, depth), 0.25f), 0.0f, 1.0f);
    const float qs = floorf(__fadd_rn(__fmul_rn(ts, 65535.0f), 0.5f));
    out_qsp = __fadd_rn(__fmul_rn(qp, 65536.0f), qs);
  }
  const size_t o = (size_t)b * n_pix + pix;
  quv[o] = out_quv;
  qsp[o] = out_qsp;
  win[o] = w.chunk * kLane + lane;
  depth_out[o] = depth;
}

__device__ __forceinline__ float quant8(float c, float depth) {
  return floorf(__fadd_rn(__fmul_rn(clip(__fmul_rn(c, depth), 0.0f, 1.0f), 255.0f), 0.5f));
}

__global__ void raster_rgb_kernel(const int* __restrict__ ranges,   // (B, T, 2)
                                  const float* __restrict__ geom,   // (B, NC, 16, 128)
                                  const float* __restrict__ col,    // (B, NC, 16, 128)
                                  float* __restrict__ rgb,          // (B, H*W, 3)
                                  float* __restrict__ depth_out,    // (B, H*W)
                                  int n_chunks, int n_tiles, int n_pix, int width) {
  __shared__ float s_geom[kGeomRows][kLane];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int pix = t * kTilePx + threadIdx.x;
  const float x = (float)(pix % width) + 0.5f;
  const float y = (float)(pix / width) + 0.5f;
  const Winner w = nearest_face(s_geom, geom + (size_t)b * n_chunks * kRows * kLane,
                                ranges[(b * n_tiles + t) * 2],
                                ranges[(b * n_tiles + t) * 2 + 1], x, y);
  if (pix >= n_pix) return;

  const float depth = depth_of(w);
  float r8 = 0.0f;
  float g8 = 0.0f;
  float b8 = 0.0f;
  if (w.key > 0) {
    const float* fc = col + ((size_t)(b * n_chunks + w.chunk) * kRows) * kLane +
                      (w.key & kLaneMask);
    r8 = quant8(plane(x, y, fc[0 * kLane], fc[3 * kLane], fc[6 * kLane]), depth);
    g8 = quant8(plane(x, y, fc[1 * kLane], fc[4 * kLane], fc[7 * kLane]), depth);
    b8 = quant8(plane(x, y, fc[2 * kLane], fc[5 * kLane], fc[8 * kLane]), depth);
  }
  const size_t o = (size_t)b * n_pix + pix;
  rgb[3 * o] = __fmul_rn(r8, kInv255);
  rgb[3 * o + 1] = __fmul_rn(g8, kInv255);
  rgb[3 * o + 2] = __fmul_rn(b8, kInv255);
  depth_out[o] = depth;
}

}  // namespace

extern "C" int raster_uv_launch(const int* ranges, const float* geom, const float* col,
                                float* quv, float* qsp, int* win, float* depth,
                                int batch, int n_chunks, int n_tiles,
                                int n_pix, int width, cudaStream_t stream) {
  if (batch <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  dim3 grid(n_tiles, batch);
  raster_uv_kernel<<<grid, kTilePx, 0, stream>>>(ranges, geom, col, quv, qsp, win, depth,
                                                 n_chunks, n_tiles, n_pix, width);
  return (int)cudaGetLastError();
}

extern "C" int raster_rgb_launch(const int* ranges, const float* geom, const float* col,
                                 float* rgb, float* depth, int batch, int n_chunks,
                                 int n_tiles, int n_pix, int width, cudaStream_t stream) {
  if (batch <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  dim3 grid(n_tiles, batch);
  raster_rgb_kernel<<<grid, kTilePx, 0, stream>>>(ranges, geom, col, rgb, depth,
                                                  n_chunks, n_tiles, n_pix, width);
  return (int)cudaGetLastError();
}
