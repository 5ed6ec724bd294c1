// Stitcher rasterisation of one frame into the occupancy canvas, for Hopper
// (sm_90a): one launch per frame, no sort, no float atomics, no host read.
//
// For a float32 frame img (H, W) at the per-frame constants
// k = (r00, r01, r10, r11, px, py) (the rotation and translation of its
// image-plane pose), every pixel (j, i) maps to the image-plane point
//   x = (r00*iw + r01*ih) + px,   y = (r10*iw + r11*ih) + py,
//   iw = i - W/2, ih = j - H/2,
// each product and sum rounded to float32 on its own (eager PyTorch's
// order, core/stitcher.py), then truncated toward zero; the canvas cell
// is (row, col) = (trunc(y) - cy + S/2, trunc(x) - cx + S/2).  A pixel on
// the canvas of an enabled frame adds img*scale into data and wsign into
// weight ((S, S) float32 each).  The result is, bit for bit, that of
//   data.view(-1).index_add_(0, cells, values)
//   weight.view(-1).index_add_(0, cells, weights)
// over the frame's pixels in flat order, which is what the CPU computes
// (nislam_torch/ops/stitch_raster.py, stitch_raster_reference).  A pixel
// off the canvas, or of a disabled frame, adds nothing there: +0 to data
// and ±0 to weight, which leave the bits of a cell that is never -0 (a
// canvas starts at +0, and a float sum rounded to nearest gives -0 only
// from two -0s), so the kernel skips it.
//
// No Pallas kernel is replaced: this is the counterpart of the stitcher's
// XLA scatter-add (nislam_tpu/core/stitcher.py:123-124).
//
// The window argument.  The cell of trunc coordinate 0 spans (-1, 1),
// every other cell one unit, so two points of one cell differ by less
// than 2 in x and in y, and are less than 2*sqrt(2) apart.  The pose is
// a rigid motion, so the two pixels that map there are less than 2*sqrt(2)
// < 3 apart too: within 2 rows and 2 columns.  (The float32 rounding of
// the map is below 1e-3 pixel at canvas coordinates under 2^16, against a
// margin of 3/sqrt(2) - 2 > 0.12: the wrapper checks the bound.)
//
// Design.  A block takes a 32 x 32 tile of the frame, computes the cells
// and values of the tile and a 2-pixel halo into shared memory, and each
// of its 256 threads takes 4 pixels of the tile.  A pixel owns its cell
// if no pixel of lower flat index in its 5 x 5 window maps to the same
// cell; by the window argument every cell the frame reaches has exactly
// one owner, the first of its pixels in flat order.  The owner adds its
// window's pixels of that cell in flat order to the cell's data and
// weight with __fadd_rn (no contraction into an FMA), and the cell is
// stored once.  The targets use __fmul_rn and __fadd_rn for the same
// reason.  A turned tile's owners touch a few cells of many canvas rows:
// read and written one by one, a warp's 32 cells would take some 25
// memory sectors each way.  So the block reads the box of canvas cells
// around its owned cells into shared memory row by row, the owners sum
// there, and the block writes its owned cells back row by row.  Every
// load of the first step (the flag, the constants, the tile's pixels) is
// issued before the first is used, and every load of the box before the
// first is stored: two rounds of memory latency in all.  A disabled
// frame's blocks return once the flag has come.
//
// Bound: device-memory bytes, each read once: the frame (4*H*W), and the
// touched cells of both canvases read and written (16 bytes per cell); a
// handful of float operations per pixel is far below the card's rate.
// The boxes read about twice the cells a block owns, neighbouring boxes
// overlap, and the L2 cache takes most of that.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;                       // tile side, pixels
constexpr int kThreadsY = 8;                    // a block is 32 x 8 threads
constexpr int kPerThread = kTile / kThreadsY;   // pixels per thread, one column
constexpr int kHalo = kTile + 4;                // the tile and 2 pixels each side
constexpr int kHaloSteps = (kHalo * kHalo + kTile * kThreadsY - 1) / (kTile * kThreadsY);
constexpr int kBox = 48;                        // side of the staged box of canvas cells
// A tile's pixels differ by at most kTile - 1 in each axis; turned, they
// span at most (kTile - 1)*sqrt(2) canvas units per axis, and truncation
// (the cell of 0 is two units wide) adds at most 2 cells more: the box of
// a block's owned cells always fits in kBox x kBox.
static_assert((kBox - 3) * (kBox - 3) >= 2 * (kTile - 1) * (kTile - 1), "a turned tile's cells overflow the box");
constexpr int kBoxRows = kBox / kThreadsY;      // box rows per thread
constexpr int kBoxCols = (kBox + kTile - 1) / kTile;  // box columns per thread

// The 12 pixels of a 5 x 5 window that come before its centre in flat
// order, and the 12 that come after, as (row, column) offsets in order.
__constant__ int kBeforeDj[12] = {-2, -2, -2, -2, -2, -1, -1, -1, -1, -1, 0, 0};
__constant__ int kBeforeDi[12] = {-2, -1, 0, 1, 2, -2, -1, 0, 1, 2, -2, -1};
__constant__ int kAfterDj[12] = {0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2};
__constant__ int kAfterDi[12] = {1, 2, -2, -1, 0, 1, 2, -2, -1, 0, 1, 2};

__global__ void __launch_bounds__(kTile * kThreadsY)
    stitch_raster_kernel(const float* __restrict__ img, int h, int w, const float* __restrict__ k,
                         const unsigned char* __restrict__ enabled, int on, float half_w, float half_h,
                         int s, int col0, int row0, float scale, float wsign, float* __restrict__ data,
                         float* __restrict__ weight) {
  if (!on) return;
  __shared__ int cell[kHalo][kHalo];    // flat canvas cell, -1: no pixel or off the canvas
  __shared__ int crow[kHalo][kHalo];    // its canvas row
  __shared__ float value[kHalo][kHalo]; // img * scale
  __shared__ int box[4];                // the owned cells' rows and columns: min, max, min, max
  __shared__ float sdata[kBox][kBox], sweight[kBox][kBox];
  __shared__ unsigned char owned[kBox][kBox];
  const int i0 = blockIdx.x * kTile - 2;
  const int j0 = blockIdx.y * kTile - 2;
  const int t = threadIdx.y * kTile + threadIdx.x;
  // The flag, the constants and the tile's pixels load together.
  const bool off = enabled != nullptr && *enabled == 0;
  const float r00 = k[0], r01 = k[1], r10 = k[2], r11 = k[3], px = k[4], py = k[5];
  float pix[kHaloSteps];
#pragma unroll
  for (int u = 0; u < kHaloSteps; ++u) {
    const int q = t + u * kTile * kThreadsY;
    const int hj = q / kHalo, hi = q - hj * kHalo;
    const int i = i0 + hi, j = j0 + hj;
    pix[u] = q < kHalo * kHalo && i >= 0 && i < w && j >= 0 && j < h ? img[static_cast<long long>(j) * w + i] : 0.0f;
  }
  if (off) return;
  if (t == 0) {
    box[0] = box[2] = 0x7fffffff;
    box[1] = box[3] = -1;
  }
#pragma unroll
  for (int u = 0; u < kHaloSteps; ++u) {
    const int q = t + u * kTile * kThreadsY;
    if (q >= kHalo * kHalo) break;
    const int hj = q / kHalo, hi = q - hj * kHalo;
    const int i = i0 + hi, j = j0 + hj;
    int c = -1, row = -1;
    if (i >= 0 && i < w && j >= 0 && j < h) {
      const float iw = __fsub_rn(static_cast<float>(i), half_w);
      const float ih = __fsub_rn(static_cast<float>(j), half_h);
      const float x = __fadd_rn(__fadd_rn(__fmul_rn(r00, iw), __fmul_rn(r01, ih)), px);
      const float y = __fadd_rn(__fadd_rn(__fmul_rn(r10, iw), __fmul_rn(r11, ih)), py);
      const int col = static_cast<int>(truncf(x)) + col0;
      row = static_cast<int>(truncf(y)) + row0;
      if (col >= 0 && col < s && row >= 0 && row < s) c = row * s + col;
    }
    cell[hj][hi] = c;
    crow[hj][hi] = row;
    value[hj][hi] = __fmul_rn(pix[u], scale);
  }
  __syncthreads();

  const int hi = threadIdx.x + 2;
  int key[kPerThread], kr[kPerThread], kc[kPerThread];
  int lo_r = 0x7fffffff, hi_r = -1, lo_c = 0x7fffffff, hi_c = -1;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int hj = threadIdx.y + p * kThreadsY + 2;
    int c = cell[hj][hi];
#pragma unroll
    for (int n = 0; n < 12; ++n) {
      if (cell[hj + kBeforeDj[n]][hi + kBeforeDi[n]] == c) c = -1;  // an earlier pixel owns it
    }
    key[p] = c;
    kr[p] = crow[hj][hi];
    kc[p] = c - kr[p] * s;
    if (c >= 0) {
      lo_r = min(lo_r, kr[p]);
      hi_r = max(hi_r, kr[p]);
      lo_c = min(lo_c, kc[p]);
      hi_c = max(hi_c, kc[p]);
    }
  }
  // The box: a warp's extremes first, then one shared atomic per warp.
  lo_r = __reduce_min_sync(0xffffffffu, lo_r);
  hi_r = __reduce_max_sync(0xffffffffu, hi_r);
  lo_c = __reduce_min_sync(0xffffffffu, lo_c);
  hi_c = __reduce_max_sync(0xffffffffu, hi_c);
  if (threadIdx.x == 0) {
    atomicMin(&box[0], lo_r);
    atomicMax(&box[1], hi_r);
    atomicMin(&box[2], lo_c);
    atomicMax(&box[3], hi_c);
  }
  __syncthreads();
  // The block's owned cells lie in a box of at most kBox x kBox cells (the
  // static_assert above): it is read into shared memory row by row, summed
  // into there, and the owned cells written back row by row.  A block with
  // an empty box owns no cell; it leaves after the sums, not before the box
  // is read (returning there made the kernel 12-19 % slower on the H100).
  const int r0 = box[0], c0 = box[2];
  const int bh = box[1] - r0 + 1, bw = box[3] - c0 + 1;
  if (bh > 0) {
    float dv[kBoxRows][kBoxCols], wv[kBoxRows][kBoxCols];
#pragma unroll
    for (int u = 0; u < kBoxRows; ++u) {
#pragma unroll
      for (int v = 0; v < kBoxCols; ++v) {
        const int br = threadIdx.y + u * kThreadsY, bc = threadIdx.x + v * kTile;
        const bool in = br < bh && bc < bw;
        const long long at = static_cast<long long>(r0 + br) * s + c0 + bc;
        dv[u][v] = in ? data[at] : 0.0f;
        wv[u][v] = in ? weight[at] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBoxRows; ++u) {
#pragma unroll
      for (int v = 0; v < kBoxCols; ++v) {
        const int br = threadIdx.y + u * kThreadsY, bc = threadIdx.x + v * kTile;
        if (bc < kBox) {
          sdata[br][bc] = dv[u][v];
          sweight[br][bc] = wv[u][v];
          owned[br][bc] = 0;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int c = key[p];
    if (c < 0) continue;
    const int hj = threadIdx.y + p * kThreadsY + 2;
    const int br = kr[p] - r0, bc = kc[p] - c0;
    float dsum = __fadd_rn(sdata[br][bc], value[hj][hi]);
    float wsum = __fadd_rn(sweight[br][bc], wsign);
#pragma unroll
    for (int n = 0; n < 12; ++n) {
      const int aj = hj + kAfterDj[n], ai = hi + kAfterDi[n];
      if (cell[aj][ai] == c) {
        dsum = __fadd_rn(dsum, value[aj][ai]);
        wsum = __fadd_rn(wsum, wsign);
      }
    }
    sdata[br][bc] = dsum;
    sweight[br][bc] = wsum;
    owned[br][bc] = 1;
  }
  if (bh <= 0) return;  // no pixel of the tile lands on the canvas
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kBoxRows; ++u) {
#pragma unroll
    for (int v = 0; v < kBoxCols; ++v) {
      const int br = threadIdx.y + u * kThreadsY, bc = threadIdx.x + v * kTile;
      if (br < bh && bc < bw && owned[br][bc]) {
        const long long at = static_cast<long long>(r0 + br) * s + c0 + bc;
        data[at] = sdata[br][bc];
        weight[at] = sweight[br][bc];
      }
    }
  }
}

}  // namespace

// Rasterise img (h, w) f32 at the constants k (6,) f32 into data and
// weight ((s, s) f32 each), on `stream`.  enabled: a device byte (0: the
// frame adds nothing) or null; on = 0 disables the frame from the host.
// (col0, row0) = (s/2 - cx, s/2 - cy).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int nislam_stitch_raster_f32(const void* img, int h, int w, const void* k, const void* enabled,
                                        int on, float half_w, float half_h, int s, int col0, int row0,
                                        float scale, float wsign, void* data, void* weight, void* stream) {
  if (h <= 0 || w <= 0 || s <= 0 || static_cast<long long>(s) * s > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  const dim3 block(kTile, kThreadsY);
  stitch_raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const float*>(k),
      static_cast<const unsigned char*>(enabled), on, half_w, half_h, s, col0, row0, scale, wsign,
      static_cast<float*>(data), static_cast<float*>(weight));
  return static_cast<int>(cudaGetLastError());
}
