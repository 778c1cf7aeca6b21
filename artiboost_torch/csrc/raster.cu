// Triangle rasterizer for Hopper (sm_90a): the three kernels of the
// ArtiBoost tile rasterizer, sharing one pass 1.
//
// Replaces: artiboost_tpu/ops/rasterizer_pallas.py `_tile_core` (pass 1
// :140-170) under its two grids:
//   * raster_uv_kernel  - `_raster_kernel` :222, uv_mode=True, uv pass 2
//     :178-199 (kernel B1);
//   * raster_rgb_kernel - `_raster_kernel` :222, uv_mode=False, Gouraud
//     `color_body` :201-219 and the `* (1/255)` :257-260 (kernel B2);
//   * raster_rgb_binned_kernel - `_raster_kernel_binned` :272 with
//     `_rasterize_binned` :469, the Gouraud pass over tiles of tile_rows x
//     xbin_w pixels, each scanning its own x-band's face chunks (B3).
//
// Contract (bit-exact with the plain PyTorch twins `rasterize_batch_uv_torch`,
// `rasterize_batch_rgb_torch` and `rasterize_batch_rgb_binned_torch` in
// artiboost_torch/ops/rasterizer_cuda.py):
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
// chunk per block and once per output word. B1 and B2: one thread per
// pixel, one block of 256 per (pixel tile, image). B3: one block per
// (y-tile, band, image); a tile of tile_rows x xbin_w pixels may exceed a
// block, so each of up to 256 threads keeps the winners of P <= 8 pixels
// in registers through one scan, and each chunk is staged once per tile.
// Every block loads its own [chunk_start, chunk_end) from the range table.
// The binned layout pays when faces are small against the frame: a tile
// scans only the chunks of faces whose bbox meets its band.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;      // faces per chunk
constexpr int kRows = 16;       // plane rows per chunk
constexpr int kGeomRows = 9;    // geometry rows actually read in pass 1
constexpr int kLaneMask = 0x7F; // low 7 mantissa bits carry the lane id
constexpr int kTilePx = 256;    // B1/B2: pixels per tile = threads per block
constexpr int kBinnedThreads = 256;   // B3: most threads per block
constexpr int kMaxPixPerThread = 8;   // B3: tile pixels per thread (2048 per tile)
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

// Pass 1 for the P pixels (x[j], y[j]) of this thread over the chunks
// [c_start, c_end) of one image (or band). Every thread of the block must
// call it: it stages each chunk in s_geom between two barriers. Each
// pixel's keys are visited in chunk and lane order, whatever P. NT is the
// block size when it is fixed at compile time (B1, B2), else 0 (B3).
template <int P, int NT>
__device__ __forceinline__ void nearest_face(float (*s_geom)[kLane], const float* geom_b,
                                             int c_start, int c_end, const float (&x)[P],
                                             const float (&y)[P], Winner (&w)[P]) {
  const int n_threads = NT > 0 ? NT : (int)blockDim.x;
#pragma unroll
  for (int j = 0; j < P; ++j) w[j] = Winner{0, 0};
  for (int c = c_start; c < c_end; ++c) {
    const float* g = geom_b + (size_t)c * kRows * kLane;
    for (int i = threadIdx.x; i < kGeomRows * kLane; i += n_threads) {
      s_geom[i / kLane][i % kLane] = g[i];
    }
    __syncthreads();
    for (int l = 0; l < kLane; ++l) {
      const float ea0 = s_geom[0][l], ea1 = s_geom[1][l], eb0 = s_geom[2][l];
      const float eb1 = s_geom[3][l], ec0 = s_geom[4][l], ec1 = s_geom[5][l];
      const float wa = s_geom[6][l], wb = s_geom[7][l], wc = s_geom[8][l];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float lam0 = plane(x[j], y[j], ea0, eb0, ec0);
        const float lam1 = plane(x[j], y[j], ea1, eb1, ec1);
        const float lam2 = __fsub_rn(__fsub_rn(1.0f, lam0), lam1);
        const float wz = plane(x[j], y[j], wa, wb, wc);
        const int wbits = __float_as_int(wz);
        const bool hit = (lam0 >= -1e-6f) && (lam1 >= -1e-6f) && (lam2 >= -1e-6f) &&
                         (wbits > 0);
        const int key = (wbits & ~kLaneMask) | l;
        if (hit && key > w[j].key) {
          w[j].key = key;
          w[j].chunk = c;
        }
      }
    }
    __syncthreads();
  }
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
  const float xs[1] = {(float)(pix % width) + 0.5f};
  const float ys[1] = {(float)(pix / width) + 0.5f};
  Winner ws[1];
  nearest_face<1, kTilePx>(s_geom, geom + (size_t)b * n_chunks * kRows * kLane,
                           ranges[(b * n_tiles + t) * 2],
                           ranges[(b * n_tiles + t) * 2 + 1], xs, ys, ws);
  if (pix >= n_pix) return;

  const float x = xs[0], y = ys[0];
  const Winner w = ws[0];
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

// Gouraud pass 2 of one pixel: the winner's r, g, b planes (col_b: the
// image's or band's packed planes), 8-bit quantised, times float32(1/255).
__device__ __forceinline__ void write_rgb(const float* col_b, const Winner& w, float x, float y,
                                          float* rgb, float* depth_out, size_t o) {
  const float depth = depth_of(w);
  float r8 = 0.0f;
  float g8 = 0.0f;
  float b8 = 0.0f;
  if (w.key > 0) {
    const float* fc = col_b + (size_t)w.chunk * kRows * kLane + (w.key & kLaneMask);
    r8 = quant8(plane(x, y, fc[0 * kLane], fc[3 * kLane], fc[6 * kLane]), depth);
    g8 = quant8(plane(x, y, fc[1 * kLane], fc[4 * kLane], fc[7 * kLane]), depth);
    b8 = quant8(plane(x, y, fc[2 * kLane], fc[5 * kLane], fc[8 * kLane]), depth);
  }
  rgb[3 * o] = __fmul_rn(r8, kInv255);
  rgb[3 * o + 1] = __fmul_rn(g8, kInv255);
  rgb[3 * o + 2] = __fmul_rn(b8, kInv255);
  depth_out[o] = depth;
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
  const float xs[1] = {(float)(pix % width) + 0.5f};
  const float ys[1] = {(float)(pix / width) + 0.5f};
  Winner ws[1];
  nearest_face<1, kTilePx>(s_geom, geom + (size_t)b * n_chunks * kRows * kLane,
                           ranges[(b * n_tiles + t) * 2],
                           ranges[(b * n_tiles + t) * 2 + 1], xs, ys, ws);
  if (pix >= n_pix) return;
  write_rgb(col + (size_t)b * n_chunks * kRows * kLane, ws[0], xs[0], ys[0], rgb, depth_out,
            (size_t)b * n_pix + pix);
}

// B3: block (ty, tx, b) rasterizes the tile_rows x xbin_w pixels of y-tile
// ty in x-band tx of image b. Pixel p of the tile sits at column
// tx*xbin_w + p % xbin_w and row ty*tile_rows + p / xbin_w (:280-282);
// thread i holds the pixels p = i + j*blockDim.x, j < P. Pixels past the
// tile or outside the image take part in every barrier and write nothing.
template <int P>
__global__ void raster_rgb_binned_kernel(const int* __restrict__ ranges,   // (B, NB, YT, 2)
                                         const float* __restrict__ geom,   // (B, NB, NC, 16, 128)
                                         const float* __restrict__ col,    // (B, NB, NC, 16, 128)
                                         float* __restrict__ rgb,          // (B, H*W, 3)
                                         float* __restrict__ depth_out,    // (B, H*W)
                                         int n_bands, int n_ytiles, int n_chunks, int height,
                                         int width, int xbin_w, int tile_rows) {
  __shared__ float s_geom[kGeomRows][kLane];
  const int ty = blockIdx.x;
  const int tx = blockIdx.y;
  const int b = blockIdx.z;
  const int tile_px = xbin_w * tile_rows;
  float xs[P];
  float ys[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    xs[j] = (float)(tx * xbin_w + p % xbin_w) + 0.5f;
    ys[j] = (float)(ty * tile_rows + p / xbin_w) + 0.5f;
  }
  const size_t band = (size_t)b * n_bands + tx;
  const size_t band_planes = (size_t)n_chunks * kRows * kLane;
  const int* r = ranges + (band * n_ytiles + ty) * 2;
  Winner ws[P];
  nearest_face<P, 0>(s_geom, geom + band * band_planes, r[0], r[1], xs, ys, ws);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    const int px = tx * xbin_w + p % xbin_w;
    const int py = ty * tile_rows + p / xbin_w;
    if (p < tile_px && px < width && py < height) {
      write_rgb(col + band * band_planes, ws[j], xs[j], ys[j], rgb, depth_out,
                ((size_t)b * height + py) * width + px);
    }
  }
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

extern "C" int raster_rgb_binned_launch(const int* ranges, const float* geom, const float* col,
                                        float* rgb, float* depth, int batch, int n_bands,
                                        int n_ytiles, int n_chunks, int height, int width,
                                        int xbin_w, int tile_rows, cudaStream_t stream) {
  if (batch <= 0 || n_bands <= 0 || n_ytiles <= 0) return (int)cudaSuccess;
  const int tile_px = xbin_w * tile_rows;
  if (xbin_w <= 0 || tile_rows <= 0 || tile_px > kBinnedThreads * kMaxPixPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  // a tile smaller than a block takes whole warps only
  const int threads = tile_px < kBinnedThreads ? (tile_px + 31) / 32 * 32 : kBinnedThreads;
  const int per_thread = (tile_px + threads - 1) / threads;
  dim3 grid(n_ytiles, n_bands, batch);
#define RASTER_BINNED_LAUNCH(P)                                                        \
  raster_rgb_binned_kernel<P><<<grid, threads, 0, stream>>>(                           \
      ranges, geom, col, rgb, depth, n_bands, n_ytiles, n_chunks, height, width, xbin_w, \
      tile_rows)
  if (per_thread <= 1) {
    RASTER_BINNED_LAUNCH(1);
  } else if (per_thread <= 2) {
    RASTER_BINNED_LAUNCH(2);
  } else if (per_thread <= 4) {
    RASTER_BINNED_LAUNCH(4);
  } else {
    RASTER_BINNED_LAUNCH(8);
  }
#undef RASTER_BINNED_LAUNCH
  return (int)cudaGetLastError();
}
