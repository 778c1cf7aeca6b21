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
// B1 and B2: one block of 128 threads per (16 x 16 pixel tile, image), one
// warp per 8 x 8 region of the tile, each thread holding 2 adjacent pixels
// of one row (PERF.md holds the 8 x 32 and 8 x 8 tiles, measured slower
// on the card). The inputs need far less work than a scan of every chunk in
// the tile's y-range: a face can only hit pixels inside its own box, and a
// mesh face's box is a few hundred pixels. So the block culls before it
// evaluates:
//   1. the chunks of its row of tiles' range (`tiles`, the y-sorted rule of
//      the 1-D table at the tile's rows) whose box (`chunk_box`) misses the
//      tile are skipped;
//   2. of each other chunk, thread t tests lane t's box (`face_box`: its
//      vertices solved from the planes in float64, widened by 2 px) against
//      the tile; the survivors are compacted in (chunk, lane) order, by
//      ballot and a prefix over the four 32-lane groups, into a shared list
//      of up to 128 faces: 9 geometry rows padded to 12 floats (three
//      16-byte loads), the chunk, the original lane and the mask of the
//      warps whose region the box meets;
//   3. every warp scans the list in order, skipping the faces whose box
//      misses its region, with today's test and strict > on today's key, so
//      the winner, its chunk and its lane are those of the full scan (a
//      face whose box misses a pixel cannot hit it, so it never changes that
//      pixel's key). A full list is scanned and refilled.
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
// B2's depth) as one 8-byte store, so a warp fills whole sectors row by row.
// B2's interleaved r, g, b are staged per warp in shared memory and written
// as contiguous 8-byte pairs along each row of the region: written pixel by
// pixel, every store left a partial sector, and the stores ran far below
// the memory's rate.
// What bounds it on this card: the bytes, the valid faces' rows and the
// range table read once and 16 B written per pixel, at the data sheet's
// 3.35 TB/s; the pass-1 operations (pixel x face-box pairs x ~25) are a few
// microseconds at its 67 TFLOP/s FP32. With every face invalid a kernel
// takes about the time of zeroing its outputs; what holds it back is the
// work of the tiles that hold faces: staging, and a scan in which a warp
// evaluates every face whose box meets its region, about twice the faces
// whose box holds a given pixel (chip_smoke.py prints both counts).
//
// B3: one block per (y-tile, band, image); a tile of tile_rows x xbin_w
// pixels may exceed a block, so each of up to 256 threads keeps the winners
// of P <= 8 pixels in registers through one scan of the band's chunks in the
// tile's range, each staged once per tile in shared memory. The binned
// layout pays when faces are small against the frame: a tile scans only the
// chunks of faces whose bbox meets its band.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;      // faces per chunk
constexpr int kRows = 16;       // plane rows per chunk
constexpr int kGeomRows = 9;    // geometry rows actually read in pass 1
constexpr int kLaneMask = 0x7F; // low 7 mantissa bits carry the lane id
constexpr int kGroups = kLane / 32;   // 32-lane groups of a chunk, one ballot each
constexpr int kTile = 16;             // B1/B2: a block's pixels, kTile x kTile
constexpr int kRegion = 8;            // B1/B2: a warp's pixels, 8 x 8 of its block's tile
constexpr int kPix = 2;               // B1/B2: pixels a thread holds, adjacent in a row
constexpr int kTileThreads = kTile * kTile / kPix;  // 128, one per lane of a chunk
constexpr int kTileWarps = kTileThreads / 32;       // 4, one per region
constexpr int kListCap = 128;         // B1/B2: faces staged per scan of the list
constexpr int kBinnedThreads = 256;   // B3: most threads per block
constexpr int kMaxPixPerThread = 8;   // B3: tile pixels per thread (2048 per tile)
constexpr float kInv255 = 0x1.010102p-8f;  // float32(1/255), as the TPU kernel multiplies
static_assert(kTileThreads == kLane && kTileWarps == kGroups &&
                  (kTile / kRegion) * (kTile / kRegion) == kTileWarps,
              "B1/B2: a thread per lane, a warp per 32-lane group and per 8 x 8 region");

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

// B1/B2's test of one face at one pixel: inside and in front, on strict >.
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

// B3's pass 1 for the P pixels (x[j], y[j]) of this thread over the chunks
// [c_start, c_end) of one band. Every thread of the block must call it: it
// stages each chunk in s_geom between two barriers. Each pixel's keys are
// visited in chunk and lane order, whatever P. It keeps its own hit test:
// a version sharing B1/B2's helpers ran slower on the card.
template <int P>
__device__ __forceinline__ void nearest_face(float (*s_geom)[kLane], const float* geom_b,
                                             int c_start, int c_end, const float (&x)[P],
                                             const float (&y)[P], Winner (&w)[P]) {
  const int n_threads = (int)blockDim.x;
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

// A face staged for B1/B2: (ea0 ea1 eb0 eb1) (ec0' ec1 wa wb) (wc chunk lane
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

// B1/B2's pass 1 of block (tile x, row of tiles y, image z) for the kPix
// pixels (x[j], y) of this thread (see the note at the head of the file).
// Every thread of the block must call it. Thread t owns lane t of every
// chunk.
__device__ __forceinline__ void nearest_face_tile(const int* __restrict__ tiles,
                                                  const int4* __restrict__ chunk_box,
                                                  const int4* __restrict__ face_box,
                                                  const float* __restrict__ geom, int n_chunks,
                                                  const float (&x)[kPix], float y,
                                                  Winner (&w)[kPix]) {
  __shared__ Staged s_list[kListCap];
  __shared__ int s_chunks[kTileThreads];
  __shared__ int s_count[kGroups];
  const int tid = threadIdx.x, warp = tid / 32;
  const unsigned below = (1u << (tid % 32)) - 1u;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const size_t bc = (size_t)blockIdx.z * n_chunks;
#pragma unroll
  for (int j = 0; j < kPix; ++j) w[j] = Winner{0, 0};
  const int* range = tiles + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * 2;
  const int c_begin = range[0], c_end = range[1];
  int n_list = 0;
  for (int base = c_begin; base < c_end; base += kTileThreads) {
    // the chunks of [base, base + 128) whose box meets the tile, in order
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
      // that chunk's faces whose box meets the tile
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

// This warp's region: its first column and row in the image.
__device__ __forceinline__ int2 warp_region() {
  const int2 r = region_of(threadIdx.x / 32);
  return make_int2(blockIdx.x * kTile + r.x, blockIdx.y * kTile + r.y);
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
// in the rgb plane of the image. Written pixel by
// pixel every store left a partial sector, so where the warp's whole region
// lies in the image and is aligned the warp stages its values in shared
// memory (3 kPix words a lane, in lane order, which is row-major in the
// region) and writes each row of the region as contiguous 8-byte pairs.
__device__ __forceinline__ void store_rgb(float* __restrict__ rgb_b, const float (&v)[3 * kPix],
                                          int2 r, int px0, int py, int height, int width) {
  constexpr int kPairs = 3 * kPix / 2;             // a lane's 8-byte pairs
  constexpr int kRowPairs = kPairs * kRegion / kPix;  // pairs in a row of the region
  __shared__ float2 s_rgb[kTileThreads * kPairs];
  float2* s = s_rgb + (threadIdx.x & ~31) * kPairs;  // this warp's
  const int lane = threadIdx.x % 32;
  const int n = py < height ? min(kPix, width - px0) : 0;
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
  const int2 r = warp_region();
  float xs[kPix], y;
  const int i0 = region_pixels(r, xs, y);
  Winner ws[kPix];
  nearest_face_tile(tiles, chunk_box, face_box, geom, n_chunks, xs, y, ws);
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

// B3's Gouraud pass 2 of one pixel, kept apart from B2's: the winner's r, g, b
// planes (col_b: the band's packed planes), 8-bit quantised, times
// float32(1/255), written to rgb[3 o ..] and depth_out[o].
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

__global__ void __launch_bounds__(kTileThreads)
    raster_rgb_kernel(const int* __restrict__ tiles,        // (B, TY, 2)
                      const int4* __restrict__ chunk_box,   // (B, NC)
                      const int4* __restrict__ face_box,    // (B, NC, 128)
                      const float* __restrict__ geom,       // (B, NC, 16, 128)
                      const float* __restrict__ col,        // (B, NC, 16, 128)
                      float* __restrict__ rgb,              // (B, H*W, 3)
                      float* __restrict__ depth_out,        // (B, H*W)
                      int n_chunks, int height, int width) {
  const int2 r = warp_region();
  float xs[kPix], y;
  const int i0 = region_pixels(r, xs, y);
  Winner ws[kPix];
  nearest_face_tile(tiles, chunk_box, face_box, geom, n_chunks, xs, y, ws);
  const float* col_b = col + (size_t)blockIdx.z * n_chunks * kRows * kLane;
  float o_rgb[3 * kPix], o_depth[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    o_depth[j] = depth_of(ws[j]);
    rgb_of(col_b, ws[j], xs[j], y, o_depth[j], &o_rgb[3 * j]);
  }
  const int py = r.y + i0 / kRegion, px0 = r.x + i0 % kRegion;
  const size_t img = (size_t)blockIdx.z * height * width;
  store_rgb(rgb + 3 * img, o_rgb, r, px0, py, height, width);
  if (py < height) {
    store_row(depth_out + img + (size_t)py * width + px0, o_depth, min(kPix, width - px0));
  }
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
  nearest_face<P>(s_geom, geom + band * band_planes, r[0], r[1], xs, ys, ws);
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
