// Per-pixel UV rasterizer for Hopper (sm_90a): the uv_mode branch of the
// ArtiBoost triangle rasterizer.
//
// Replaces: artiboost_tpu/ops/rasterizer_pallas.py `_raster_kernel` with
// `_tile_core(uv_mode=True)` (pass 1 :140-170, uv pass 2 :178-199).
//
// Contract (bit-exact with the plain PyTorch twin
// `rasterize_batch_uv_torch` in artiboost_torch/ops/rasterizer_cuda.py):
//   * faces arrive y-sorted (stable) and packed in chunks of 128 lanes,
//     each chunk 16 plane rows: geom = [ea0 ea1 eb0 eb1 ec0' ec1 wa wb wc],
//     col = [ea.u ea.v ea.s ea.p  eb.u .. eb.p  ec.u .. ec.p]; invalid faces
//     carry ec0' = -1e30 so they never pass the inside test;
//   * pass 1: a pixel is inside face f when min(lam0, lam1, lam2) >= -1e-6
//     and w = 1/z > 0; the depth key is w's bits with the low 7 mantissa
//     bits replaced by the lane id. The largest key wins; ties across
//     chunks keep the EARLIER chunk (strict >), which a sequential scan in
//     sorted order with strict > reproduces exactly (keys inside a chunk
//     are distinct because the lane ids differ);
//   * pass 2 evaluates only the winning face's u, v, shade, page planes and
//     packs u12*4096+v12 and page8*65536+(shade/4)*65535.
//   * every a*b+c is rounded twice (__fmul_rn/__fadd_rn): nvcc would
//     otherwise contract it into an FMA and change the bits.
//
// What bounds it on this card: pass 1 is FP32 work, pixels x chunks in the
// tile's y-range x 128 lanes x ~25 operations, against 67 TFLOP/s of
// non-tensor FP32; the output (4 planes of B*H*W 32-bit words) is small.
// The design keeps the face planes of the chunk being scanned in shared
// memory (one cooperative 4.6 KB load per chunk, read back as broadcasts)
// and the per-pixel best key in registers, so device memory is touched
// once per chunk per block and once per output word. One thread per
// pixel, one block per (pixel tile, image); the block loads its own
// [chunk_start, chunk_end) from the range table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;      // faces per chunk
constexpr int kRows = 16;       // plane rows per chunk
constexpr int kGeomRows = 9;    // geometry rows actually read in pass 1
constexpr int kLaneMask = 0x7F; // low 7 mantissa bits carry the lane id
constexpr int kTilePx = 256;    // pixels per tile = threads per block

__device__ __forceinline__ float plane(float x, float y, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
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

  const int c_start = ranges[(b * n_tiles + t) * 2];
  const int c_end = ranges[(b * n_tiles + t) * 2 + 1];
  const float* geom_b = geom + (size_t)b * n_chunks * kRows * kLane;

  // ---- pass 1: nearest covering face, packed (depth key | lane) ----
  int best = 0;
  int best_chunk = 0;
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
      const float w = plane(x, y, s_geom[6][l], s_geom[7][l], s_geom[8][l]);
      const int wbits = __float_as_int(w);
      const bool hit = (lam0 >= -1e-6f) && (lam1 >= -1e-6f) && (lam2 >= -1e-6f) &&
                       (wbits > 0);
      const int key = (wbits & ~kLaneMask) | l;
      if (hit && key > best) {
        best = key;
        best_chunk = c;
      }
    }
    __syncthreads();
  }
  if (pix >= n_pix) return;

  const bool hitm = best > 0;
  const float w_rec = __int_as_float(best & ~kLaneMask);
  const float depth = hitm ? __fdiv_rn(1.0f, fmaxf(w_rec, 1e-30f)) : 0.0f;
  const int lane = best & kLaneMask;

  // ---- pass 2: the winning face's (u, v, shade, page) planes ----
  float out_quv = 0.0f;
  float out_qsp = 0.0f;
  if (hitm) {
    const float* fc = col + ((size_t)(b * n_chunks + best_chunk) * kRows) * kLane + lane;
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
  win[o] = best_chunk * kLane + lane;
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
