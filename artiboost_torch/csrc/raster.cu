// Triangle rasterizer for Hopper (sm_90a): the three kernels of the
// ArtiBoost tile rasterizer.
//
// Replaces: artiboost_tpu/ops/rasterizer_pallas.py `_tile_core` (pass 1
// :140-170) under its two grids:
//   * raster_uv_kernel  - `_raster_kernel` :222, uv_mode=True, uv pass 2
//     :178-199 (kernel B1);
//   * raster_rgb_kernel - `_raster_kernel` :222, uv_mode=False, Gouraud
//     `color_body` :201-219 and the `* (1/255)` :257-260 (kernel B2);
//   * raster_rgb_binned_kernel - `_raster_kernel_binned` :272 with
//     `_rasterize_binned` :469, B2's function over each x-band's own face
//     copies, each pixel taking the faces of its band (B3).
//
// Contract (bit-exact with the plain PyTorch twins `rasterize_batch_uv_torch`,
// `rasterize_batch_rgb_torch` and `rasterize_batch_rgb_binned_torch` in
// artiboost_torch/ops/rasterizer_cuda.py):
//   * faces arrive y-sorted (stable) and packed in chunks of 128 lanes,
//     each chunk 16 plane rows: geom = [ea0 ea1 eb0 eb1 ec0' ec1 wa wb wc],
//     col = the attribute planes in edge-major order (ea.c0..c(A-1),
//     eb.c0.., ec.c0..) with A = 4 (u, v, shade, page) or A = 3 (r, g, b);
//     invalid faces carry ec0' = -1e30 so they never pass the inside test;
//     B3's planes hold one such set per x-band of xbin_w columns, the band's
//     copies of the faces whose box meets it, y-sorted per band;
//   * pass 1: a pixel is inside face f when min(lam0, lam1, lam2) >= -1e-6
//     and w = 1/z > 0; the depth key is w's bits with the low 7 mantissa
//     bits replaced by the lane id (B3: the lane in the band's chunks). The
//     largest key wins; ties across
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
// One block of 128 threads per 16 x 16 pixel window of an image (B3: of a
// band of an image; a band's windows start at its left edge, and pixels
// outside its columns or the image are scanned but not written), one warp
// per 8 x 8 region of the window, each thread holding 2 adjacent pixels of
// one row (PERF.md holds the 8 x 32 and 8 x 8 tiles, measured slower on
// the card). The inputs need far less work than a scan of every chunk in
// the window's y-range: a face can only hit pixels inside its own box, and
// a mesh face's box is a few hundred pixels. So the block culls before it
// evaluates:
//   1. the chunks of its row of windows' range (`tiles`, the y-sorted rule
//      of the 1-D table at the window's rows, on the band's chunks for B3)
//      whose box (`chunk_box`) misses the window are skipped;
//   2. of each other chunk, thread t tests lane t's box (`face_box`: its
//      vertices solved from the planes in float64, widened by 2 px) against
//      the window; the survivors are compacted in (chunk, lane) order, by
//      ballot and a prefix over the four 32-lane groups, into a shared list
//      of up to 128 faces: 9 geometry rows padded to 12 floats (three
//      16-byte loads), the chunk, the original lane and the mask of the
//      warps whose region the box meets;
//   3. every warp scans the list in order, skipping the faces whose box
//      misses its region, with today's test and strict > on today's key, so
//      the winner, its chunk and its lane are those of the full scan (a
//      face whose box misses a pixel cannot hit it, so it never changes that
//      pixel's key). A full list is scanned and refilled.
// B3's windows cover only pixels of their own band, so the faces whose box
// meets one are the same as in the 1-D layout, in the band's order: the
// tile_rows x xbin_w tiles of the TPU kernel fix only the twin's range
// table, and any tile shape runs.
// The loads of steps 1-2 wait on global memory twice a chunk (its lanes'
// boxes, then the survivors' rows). Staging them by cp.async instead, the
// boxes three chunks ahead and the rows straight into the list, ran B2 3 %
// faster and B1 3-5 % slower (NVIDIA H100 80GB HBM3, 700.00 W), so the
// loads stay plain (PERF.md, PR 4). Nor does the scan wait on shared
// memory: per face a warp issues 3 LDS.128 against 9 FMUL and 16 FADD for
// its 2 pixels (the SASS counts of chip_smoke.py).
// The products y*b are shared by a thread's pixels: the same operands, the
// same rounding. Tensor cores do not fit this work: a plane value is
// ((x*a)_r + (y*b)_r)_r + c rounded after each operation, and wgmma (TF32
// inputs, fused accumulation) cannot give those bits.
// Pass 2: each thread writes its two pixels of a planar output (B1's four,
// B2's and B3's depth) as one 8-byte store, so a warp fills whole sectors
// row by row. The interleaved r, g, b are staged per warp in shared memory
// and written as contiguous 8-byte pairs along each row of the region:
// written pixel by pixel, every store left a partial sector, and the stores
// ran far below the memory's rate.
// What bounds it on this card: the bytes, the valid faces' rows and the
// range table read once and 16 B written per pixel, at the data sheet's
// 3.35 TB/s; the pass-1 operations (pixel x face-box pairs x ~25) are a few
// microseconds at its 67 TFLOP/s FP32. With every face invalid a kernel
// takes about the time of zeroing its outputs; what holds it back is the
// work of the windows that hold faces: staging, and a scan in which a warp
// evaluates every face whose box meets its region, about twice the faces
// whose box holds a given pixel (chip_smoke.py prints both counts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;      // faces per chunk
constexpr int kRows = 16;       // plane rows per chunk
constexpr int kGeomRows = 9;    // geometry rows actually read in pass 1
constexpr int kLaneMask = 0x7F; // low 7 mantissa bits carry the lane id
constexpr int kGroups = kLane / 32;   // 32-lane groups of a chunk, one ballot each
constexpr int kTile = 16;             // a block's pixels, kTile x kTile
constexpr int kRegion = 8;            // a warp's pixels, 8 x 8 of its block's window
constexpr int kPix = 2;               // pixels a thread holds, adjacent in a row
constexpr int kTileThreads = kTile * kTile / kPix;  // 128, one per lane of a chunk
constexpr int kTileWarps = kTileThreads / 32;       // 4, one per region
constexpr int kListCap = 128;         // faces staged per scan of the list
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), as the TPU kernel multiplies
static_assert(kTileThreads == kLane && kTileWarps == kGroups &&
                  (kTile / kRegion) * (kTile / kRegion) == kTileWarps,
              "a thread per lane, a warp per 32-lane group and per 8 x 8 region");

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

// The test of one face at one pixel: inside and in front, on strict >.
__device__ __forceinline__ void visit(Winner& w, float lam0, float lam1, float wz, int lane,
                                      int chunk) {
  const float lam2 = __fsub_rn(__fsub_rn(1.0f, lam0), lam1);
  const int wbits = __float_as_int(wz);
  const bool hit = (lam0 >= -1e-6f) && (lam1 >= -1e-6f) && (lam2 >= -1e-6f) && (wbits > 0);
  const int key = (wbits & ~kLaneMask) | lane;
  if (hit && key > w.key) {
    w.key = key;
    w.chunk = chunk;
  }
}

// A face staged for the scan: (ea0 ea1 eb0 eb1) (ec0' ec1 wa wb) (wc chunk lane
// warps); the chunk, the lane and the mask of the warps whose region the
// face's box meets as int bits.
struct __align__(16) Staged {
  float4 a, b, c;
};

// Box [b.x, b.y) x [b.z, b.w) against the pixels [x0, x0 + N) x [y0, y0 + N).
template <int N>
__device__ __forceinline__ bool meets(int4 b, int x0, int y0) {
  return b.x < x0 + N && b.y > x0 && b.z < y0 + N && b.w > y0;
}

// Where warp q's kRegion x kRegion pixels sit in the tile.
__device__ __forceinline__ int2 region_of(int q) {
  return make_int2((q % (kTile / kRegion)) * kRegion, (q / (kTile / kRegion)) * kRegion);
}

// The staged faces [0, n) in order, for the kPix pixels (x[j], y) of this
// thread; the warp skips a face whose box misses its region.
__device__ __forceinline__ void scan_staged(const Staged* list, int n, const float (&x)[kPix],
                                            float y, Winner (&w)[kPix], int warp) {
  for (int e = 0; e < n; ++e) {
    const float4 c = list[e].c;
    if (!((__float_as_int(c.w) >> warp) & 1)) continue;
    const float4 a = list[e].a, b = list[e].b;
    const float yb0 = __fmul_rn(y, a.z), yb1 = __fmul_rn(y, a.w), ybw = __fmul_rn(y, b.w);
    const int chunk = __float_as_int(c.y), lane = __float_as_int(c.z);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      visit(w[j], __fadd_rn(__fadd_rn(__fmul_rn(x[j], a.x), yb0), b.x),
            __fadd_rn(__fadd_rn(__fmul_rn(x[j], a.y), yb1), b.y),
            __fadd_rn(__fadd_rn(__fmul_rn(x[j], b.z), ybw), c.x), lane, chunk);
    }
  }
}

// Pass 1 of the window at (x0, y0), in row of windows blockIdx.y, over the
// planes and tables of image `img` (B3: of one band of an image), for the
// kPix pixels (x[j], y) of this thread (see the note at the head of the
// file). Every thread of the block must call it. Thread t owns lane t of
// every chunk.
__device__ __forceinline__ void nearest_face_tile(const int* __restrict__ tiles,
                                                  const int4* __restrict__ chunk_box,
                                                  const int4* __restrict__ face_box,
                                                  const float* __restrict__ geom, int n_chunks,
                                                  int img, int x0, int y0,
                                                  const float (&x)[kPix], float y,
                                                  Winner (&w)[kPix]) {
  __shared__ Staged s_list[kListCap];
  __shared__ int s_chunks[kTileThreads];
  __shared__ int s_count[kGroups];
  const int tid = threadIdx.x, warp = tid / 32;
  const unsigned below = (1u << (tid % 32)) - 1u;
  const size_t bc = (size_t)img * n_chunks;
#pragma unroll
  for (int j = 0; j < kPix; ++j) w[j] = Winner{0, 0};
  const int* range = tiles + ((size_t)img * gridDim.y + blockIdx.y) * 2;
  const int c_begin = range[0], c_end = range[1];
  int n_list = 0;
  for (int base = c_begin; base < c_end; base += kTileThreads) {
    // the chunks of [base, base + 128) whose box meets the window, in order
    const int c = base + tid;
    const bool chunk_in = c < c_end && meets<kTile>(chunk_box[bc + c], x0, y0);
    const unsigned cm = __ballot_sync(0xffffffffu, chunk_in);
    if (tid % 32 == 0) s_count[warp] = __popc(cm);
    __syncthreads();
    int n_in = 0, before = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      before += k < warp ? s_count[k] : 0;
      n_in += s_count[k];
    }
    if (chunk_in) s_chunks[before + __popc(cm & below)] = c;
    __syncthreads();
    for (int i = 0; i < n_in; ++i) {
      // that chunk's faces whose box meets the window
      const int chunk = s_chunks[i];
      const size_t f0 = (bc + chunk) * kLane;
      const bool keep = meets<kTile>(face_box[f0 + tid], x0, y0);
      const unsigned km = __ballot_sync(0xffffffffu, keep);
      if (tid % 32 == 0) s_count[warp] = __popc(km);
      __syncthreads();
      int total = 0, slot = __popc(km & below);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        slot += g < warp ? s_count[g] : 0;
        total += s_count[g];
      }
      if (n_list + total > kListCap) {  // the same for every thread
        scan_staged(s_list, n_list, x, y, w, warp);
        __syncthreads();
        n_list = 0;
      }
      if (keep) {
        const int4 fb = face_box[f0 + tid];  // again: fewer registers live across the barrier
        int warps = 0;
#pragma unroll
        for (int q = 0; q < kTileWarps; ++q) {
          const int2 r = region_of(q);
          warps |= meets<kRegion>(fb, x0 + r.x, y0 + r.y) << q;
        }
        const float* gp = geom + f0 * kRows + tid;
        s_list[n_list + slot] = Staged{
            make_float4(gp[0], gp[kLane], gp[2 * kLane], gp[3 * kLane]),
            make_float4(gp[4 * kLane], gp[5 * kLane], gp[6 * kLane], gp[7 * kLane]),
            make_float4(gp[8 * kLane], __int_as_float(chunk), __int_as_float(tid),
                        __int_as_float(warps))};
      }
      __syncthreads();
      n_list += total;
    }
  }
  scan_staged(s_list, n_list, x, y, w, warp);
}

__device__ __forceinline__ float depth_of(const Winner& w) {
  const float w_rec = __int_as_float(w.key & ~kLaneMask);
  return w.key > 0 ? __fdiv_rn(1.0f, fmaxf(w_rec, 1e-30f)) : 0.0f;
}

// This warp's region of the window at `origin`: its first column and row.
__device__ __forceinline__ int2 warp_region(int2 origin) {
  const int2 r = region_of(threadIdx.x / 32);
  return make_int2(origin.x + r.x, origin.y + r.y);
}

// This thread's kPix pixels of its warp's region (origin r): lane l holds
// row l / 4, columns 2 (l % 4) + j, at (x[j], y) in the image; -> the first
// one's place in the region's row-major staging.
__device__ __forceinline__ int region_pixels(int2 r, float (&x)[kPix], float& y) {
  const int lane = threadIdx.x % 32;
  const int col = (lane % (kRegion / kPix)) * kPix, row = lane / (kRegion / kPix);
#pragma unroll
  for (int j = 0; j < kPix; ++j) x[j] = (float)(r.x + col + j) + 0.5f;
  y = (float)(r.y + row) + 0.5f;
  return row * kRegion + col;
}

// Words v[0, n) of one row of a planar output to dst, as one store where
// all N are written and dst is aligned for it.
template <int N>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&v)[N], int n) {
  static_assert(N == 2, "a thread's kPix pixels");
  if (n == N && reinterpret_cast<uintptr_t>(dst) % 8 == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n) dst[j] = v[j];
    }
  }
}

// The interleaved r, g, b (v) of this thread's kPix pixels at (px0, py),
// in the rgb plane of the image, of which the columns below x_end are
// written. Written pixel by
// pixel every store left a partial sector, so where the warp's whole region
// is written and aligned the warp stages its values in shared
// memory (3 kPix words a lane, in lane order, which is row-major in the
// region) and writes each row of the region as contiguous 8-byte pairs.
__device__ __forceinline__ void store_rgb(float* __restrict__ rgb_b, const float (&v)[3 * kPix],
                                          int2 r, int px0, int py, int height, int width,
                                          int x_end) {
  constexpr int kPairs = 3 * kPix / 2;             // a lane's 8-byte pairs
  constexpr int kRowPairs = kPairs * kRegion / kPix;  // pairs in a row of the region
  __shared__ float2 s_rgb[kTileThreads * kPairs];
  float2* s = s_rgb + (threadIdx.x & ~31) * kPairs;  // this warp's
  const int lane = threadIdx.x % 32;
  const int n = py < height ? min(kPix, x_end - px0) : 0;
  float* dst = rgb_b + 3 * ((size_t)py * width + px0);
  if (__all_sync(0xffffffffu, n == kPix && reinterpret_cast<uintptr_t>(dst) % 8 == 0)) {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) s[lane * kPairs + k] = make_float2(v[2 * k], v[2 * k + 1]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int q = j * 32 + lane, row = q / kRowPairs;
      reinterpret_cast<float2*>(rgb_b + 3 * ((size_t)(r.y + row) * width + r.x))[q % kRowPairs] =
          s[q];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3 * kPix; ++k) {
      if (k < 3 * n) dst[k] = v[k];  // a fixed index keeps v in registers
    }
  }
}

// uv pass 2 of one pixel (col_b: the image's packed planes).
__device__ __forceinline__ void uv_pack(const float* col_b, const Winner& w, float x, float y,
                                        float& out_quv, float& out_qsp, float& depth) {
  depth = depth_of(w);
  out_quv = 0.0f;
  out_qsp = 0.0f;
  if (w.key > 0) {
    const float* fc = col_b + (size_t)w.chunk * kRows * kLane + (w.key & kLaneMask);
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
}

__global__ void __launch_bounds__(kTileThreads)
    raster_uv_kernel(const int* __restrict__ tiles,        // (B, TY, 2)
                     const int4* __restrict__ chunk_box,   // (B, NC)
                     const int4* __restrict__ face_box,    // (B, NC, 128)
                     const float* __restrict__ geom,       // (B, NC, 16, 128)
                     const float* __restrict__ col,        // (B, NC, 16, 128)
                     float* __restrict__ quv,              // (B, H*W)
                     float* __restrict__ qsp,              // (B, H*W)
                     int* __restrict__ win,                // (B, H*W) sorted id
                     float* __restrict__ depth_out,        // (B, H*W)
                     int n_chunks, int height, int width) {
  const int2 origin = make_int2(blockIdx.x * kTile, blockIdx.y * kTile);
  const int2 r = warp_region(origin);
  float xs[kPix], y;
  const int i0 = region_pixels(r, xs, y);
  Winner ws[kPix];
  nearest_face_tile(tiles, chunk_box, face_box, geom, n_chunks, blockIdx.z, origin.x, origin.y,
                    xs, y, ws);
  const int py = r.y + i0 / kRegion, px0 = r.x + i0 % kRegion;
  if (py >= height) return;
  const float* col_b = col + (size_t)blockIdx.z * n_chunks * kRows * kLane;
  float o_quv[kPix], o_qsp[kPix], o_win[kPix], o_depth[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    uv_pack(col_b, ws[j], xs[j], y, o_quv[j], o_qsp[j], o_depth[j]);
    o_win[j] = __int_as_float(ws[j].chunk * kLane + (ws[j].key & kLaneMask));
  }
  const size_t o = ((size_t)blockIdx.z * height + py) * width + px0;
  const int n = min(kPix, width - px0);  // pixels of the row in the image
  store_row(quv + o, o_quv, n);
  store_row(qsp + o, o_qsp, n);
  store_row(reinterpret_cast<float*>(win) + o, o_win, n);
  store_row(depth_out + o, o_depth, n);
}

__device__ __forceinline__ float quant8(float c, float depth) {
  return floorf(__fadd_rn(__fmul_rn(clip(__fmul_rn(c, depth), 0.0f, 1.0f), 255.0f), 0.5f));
}

// Gouraud pass 2 of one pixel: the winner's r, g, b planes (col_b: the
// image's or band's packed planes), 8-bit quantised, times float32(1/255).
__device__ __forceinline__ void rgb_of(const float* col_b, const Winner& w, float x, float y,
                                       float depth, float* rgb) {
  float r8 = 0.0f;
  float g8 = 0.0f;
  float b8 = 0.0f;
  if (w.key > 0) {
    const float* fc = col_b + (size_t)w.chunk * kRows * kLane + (w.key & kLaneMask);
    r8 = quant8(plane(x, y, fc[0 * kLane], fc[3 * kLane], fc[6 * kLane]), depth);
    g8 = quant8(plane(x, y, fc[1 * kLane], fc[4 * kLane], fc[7 * kLane]), depth);
    b8 = quant8(plane(x, y, fc[2 * kLane], fc[5 * kLane], fc[8 * kLane]), depth);
  }
  rgb[0] = __fmul_rn(r8, kInv255);
  rgb[1] = __fmul_rn(g8, kInv255);
  rgb[2] = __fmul_rn(b8, kInv255);
}

// B2's and B3's pass 1 and pass 2 of the window at `origin` over the planes
// and tables of image `img` (B3: a band of one), writing the pixels of
// columns below x_end and rows below height of the output image's rgb_b and
// depth_b planes.
__device__ __forceinline__ void gouraud_window(const int* __restrict__ tiles,
                                               const int4* __restrict__ chunk_box,
                                               const int4* __restrict__ face_box,
                                               const float* __restrict__ geom,
                                               const float* __restrict__ col, int n_chunks,
                                               int img, int2 origin, int x_end,
                                               float* __restrict__ rgb_b,
                                               float* __restrict__ depth_b, int height,
                                               int width) {
  const int2 r = warp_region(origin);
  float xs[kPix], y;
  const int i0 = region_pixels(r, xs, y);
  Winner ws[kPix];
  nearest_face_tile(tiles, chunk_box, face_box, geom, n_chunks, img, origin.x, origin.y, xs, y,
                    ws);
  const float* col_b = col + (size_t)img * n_chunks * kRows * kLane;
  float o_rgb[3 * kPix], o_depth[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    o_depth[j] = depth_of(ws[j]);
    rgb_of(col_b, ws[j], xs[j], y, o_depth[j], &o_rgb[3 * j]);
  }
  const int py = r.y + i0 / kRegion, px0 = r.x + i0 % kRegion;
  store_rgb(rgb_b, o_rgb, r, px0, py, height, width, x_end);
  if (py < height) store_row(depth_b + (size_t)py * width + px0, o_depth, min(kPix, x_end - px0));
}

__global__ void __launch_bounds__(kTileThreads)
    raster_rgb_kernel(const int* __restrict__ tiles,        // (B, TY, 2)
                      const int4* __restrict__ chunk_box,   // (B, NC)
                      const int4* __restrict__ face_box,    // (B, NC, 128)
                      const float* __restrict__ geom,       // (B, NC, 16, 128)
                      const float* __restrict__ col,        // (B, NC, 16, 128)
                      float* __restrict__ rgb,              // (B, H*W, 3)
                      float* __restrict__ depth_out,        // (B, H*W)
                      int n_chunks, int height, int width) {
  const size_t o = (size_t)blockIdx.z * height * width;
  gouraud_window(tiles, chunk_box, face_box, geom, col, n_chunks, blockIdx.z,
                 make_int2(blockIdx.x * kTile, blockIdx.y * kTile), width, rgb + 3 * o,
                 depth_out + o, height, width);
}

// B3: block (window x, row of windows, image b) takes the 16 x 16 window
// blockIdx.x % windows of band blockIdx.x / windows, a band's ceil(xbin_w /
// 16) windows starting at its left edge, over that band's planes and tables.
__global__ void __launch_bounds__(kTileThreads)
    raster_rgb_binned_kernel(const int* __restrict__ tiles,        // (B, NB, TY, 2)
                             const int4* __restrict__ chunk_box,   // (B, NB, NC)
                             const int4* __restrict__ face_box,    // (B, NB, NC, 128)
                             const float* __restrict__ geom,       // (B, NB, NC, 16, 128)
                             const float* __restrict__ col,        // (B, NB, NC, 16, 128)
                             float* __restrict__ rgb,              // (B, H*W, 3)
                             float* __restrict__ depth_out,        // (B, H*W)
                             int n_bands, int n_chunks, int height, int width, int xbin_w) {
  const int windows = (xbin_w + kTile - 1) / kTile;
  const int band = blockIdx.x / windows;
  const int2 origin = make_int2(band * xbin_w + (blockIdx.x % windows) * kTile,
                                blockIdx.y * kTile);
  const int x_end = min((band + 1) * xbin_w, width);
  if (origin.x >= x_end) return;  // the whole block, past the image's last column
  const size_t o = (size_t)blockIdx.z * height * width;
  gouraud_window(tiles, chunk_box, face_box, geom, col, n_chunks, blockIdx.z * n_bands + band,
                 origin, x_end, rgb + 3 * o, depth_out + o, height, width);
}

inline dim3 tile_grid(int batch, int height, int width) {
  return dim3((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, batch);
}

}  // namespace

extern "C" int raster_uv_launch(const int* tiles, const int* chunk_box, const int* face_box,
                                const float* geom, const float* col, float* quv, float* qsp,
                                int* win, float* depth, int batch, int n_chunks, int height,
                                int width, cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (batch > 65535 || (height + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  raster_uv_kernel<<<tile_grid(batch, height, width), kTileThreads, 0, stream>>>(
      tiles, reinterpret_cast<const int4*>(chunk_box), reinterpret_cast<const int4*>(face_box),
      geom, col, quv, qsp, win, depth, n_chunks, height, width);
  return (int)cudaGetLastError();
}

extern "C" int raster_rgb_launch(const int* tiles, const int* chunk_box, const int* face_box,
                                 const float* geom, const float* col, float* rgb, float* depth,
                                 int batch, int n_chunks, int height, int width,
                                 cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (batch > 65535 || (height + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  raster_rgb_kernel<<<tile_grid(batch, height, width), kTileThreads, 0, stream>>>(
      tiles, reinterpret_cast<const int4*>(chunk_box), reinterpret_cast<const int4*>(face_box),
      geom, col, rgb, depth, n_chunks, height, width);
  return (int)cudaGetLastError();
}

extern "C" int raster_rgb_binned_launch(const int* tiles, const int* chunk_box,
                                        const int* face_box, const float* geom, const float* col,
                                        float* rgb, float* depth, int batch, int n_bands,
                                        int n_chunks, int height, int width, int xbin_w,
                                        cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  if (xbin_w <= 0 || n_bands != (width + xbin_w - 1) / xbin_w || batch > 65535 ||
      (height + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_bands * ((xbin_w + kTile - 1) / kTile), (height + kTile - 1) / kTile, batch);
  raster_rgb_binned_kernel<<<grid, kTileThreads, 0, stream>>>(
      tiles, reinterpret_cast<const int4*>(chunk_box), reinterpret_cast<const int4*>(face_box),
      geom, col, rgb, depth, n_bands, n_chunks, height, width, xbin_w);
  return (int)cudaGetLastError();
}
