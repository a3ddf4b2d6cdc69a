// Kernel B1: fused ORB detection maps over every pyramid level in one launch.
//
// Replaces: mono_slam_framework_tpu/ops/pallas_detect.py::_multi_kernel
// (launched by detect_stage_multi_bands; its per-level forms _banded_kernel
// and _full_kernel compute the same maps). Plain PyTorch version:
// mono_slam_framework_torch/ops/detect.py::detect_maps_plain.
//
// What it computes, for every pixel of every level of the stacked pyramid:
//   score  = Harris at FAST-9 corners that are inside the level's border
//            and survive 3x3 non-max suppression (>=), -inf elsewhere;
//   m10/m01 = 31x31 square-patch intensity moments (orientation);
//   blur   = 7x7 Gaussian, sigma 2 (rBRIEF sampling source);
//   harris = the raw Harris surface (Sobel gradients, 7x7 box structure
//            tensor, k = 0.04), read by the subpixel peak fit.
// Columns past a level's width (the stack is padded to the level-0 width)
// get score -inf and 0 in the other maps.
//
// Layout: level l occupies rows row0[l] .. row0[l]+h[l] of a [rows, w0] f32
// stack; the table holds (row0, h, w, first tile row) per level.
//
// What bounds it on the card: arithmetic and shared-memory traffic per tile,
// not device memory. Each 32x32 output tile reads a 64x64 input window
// (16 KB) once and writes 5 x 4 KB, so the launch moves ~35 MB at 640x480;
// the stencils (16-point ring, Sobel, 2 x 7-tap boxes, 2 x 31-tap moment
// passes, 2 x 7-tap blur) cost ~300 shared-memory reads per output pixel.
//
// Design: one thread block per 2-D output tile of one level, with a 16-px
// halo (the largest stencil radius is the moments' 15) loaded once into
// shared memory with reads clamped to the level. Every map is then computed
// from shared memory in separable passes (box and ramp sums for the moments,
// never a 961-tap loop). Only pixels at least 31 px inside a level are read
// downstream, so clamped edges never reach a feature. The interior mask uses
// the real level height and width before NMS, so padded columns never
// suppress a real corner. There are no row bands, rolls or pre-gathers:
// those existed for the TPU's VMEM budget.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 16;
constexpr int IN = TILE + 2 * HALO;  // 64: input window side
constexpr int NT = 256;
constexpr int PR = TILE + 8;  // 40: gradient-product region, o in [-4, 36)
constexpr int HR = TILE + 2;  // 34: Harris / candidate region, o in [-1, 33)
constexpr int MR = 15;        // moment radius
constexpr int MW = TILE + 2 * MR;  // 62: moment vertical-pass width
constexpr int BW = TILE + 6;       // 38: blur vertical-pass width

// shared-memory layout (floats)
constexpr int OFF_IMG = 0;
constexpr int OFF_P = OFF_IMG + IN * IN;       // 3 x PR x PR products
constexpr int OFF_V = OFF_P + 3 * PR * PR;     // 3 x HR x PR vertical sums
constexpr int OFF_H = OFF_V + 3 * HR * PR;     // HR x HR Harris
constexpr int OFF_C = OFF_H + HR * HR;         // HR x HR NMS candidates
constexpr int SMEM_FLOATS = OFF_C + HR * HR;
// the moment and blur passes reuse the product / vertical-sum region
constexpr int OFF_VB = OFF_P;                  // TILE x MW vertical box
constexpr int OFF_VR = OFF_VB + TILE * MW;     // TILE x MW vertical ramp
constexpr int OFF_VG = OFF_VR + TILE * MW;     // TILE x BW vertical Gaussian
static_assert(OFF_VG + TILE * BW <= OFF_H, "moment passes overflow their region");

// Bresenham circle of radius 3, clockwise: ops/fast.py CIRCLE order
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

struct Gauss7 {
  float w[7];
};

__device__ __forceinline__ bool any_arc9(unsigned m) {
  const unsigned m32 = m | (m << 16);
  unsigned t = m32;
#pragma unroll
  for (int k = 1; k < 9; ++k) t &= m32 >> k;
  return (t & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(NT)
detect_kernel(const float* __restrict__ img, float* __restrict__ out,
              const int4* __restrict__ levels, int n_levels, size_t plane,
              int w0, float thr, int border, Gauss7 g) {
  extern __shared__ float sm[];
  float* s_img = sm + OFF_IMG;

  // this tile's level: the last level whose first tile row is <= blockIdx.y
  int l = 0;
  while (l + 1 < n_levels && levels[l + 1].w <= static_cast<int>(blockIdx.y)) ++l;
  const int4 lv = levels[l];
  const int row0 = lv.x, h = lv.y, w = lv.z;
  const int y0 = (static_cast<int>(blockIdx.y) - lv.w) * TILE;  // level-local
  const int x0 = static_cast<int>(blockIdx.x) * TILE;
  const int tid = threadIdx.x;

  float* o_score = out;
  float* o_m10 = out + plane;
  float* o_m01 = out + 2 * plane;
  float* o_blur = out + 3 * plane;
  float* o_harris = out + 4 * plane;

  if (x0 >= w) {  // a tile wholly in the padded columns
    for (int i = tid; i < TILE * TILE; i += NT) {
      const int y = y0 + i / TILE, x = x0 + i % TILE;
      if (y >= h || x >= w0) continue;
      const size_t o = static_cast<size_t>(row0 + y) * w0 + x;
      o_score[o] = -INFINITY;
      o_m10[o] = 0.0f;
      o_m01[o] = 0.0f;
      o_blur[o] = 0.0f;
      o_harris[o] = 0.0f;
    }
    return;
  }

  // ---- input window, reads clamped to the level ----
  for (int i = tid; i < IN * IN; i += NT) {
    const int r = i / IN, c = i % IN;
    const int gy = min(max(y0 - HALO + r, 0), h - 1);
    const int gx = min(max(x0 - HALO + c, 0), w - 1);
    s_img[i] = img[static_cast<size_t>(row0 + gy) * w0 + gx];
  }
  __syncthreads();
#define IMG(r, c) s_img[(r) * IN + (c)]

  // ---- Sobel gradient products on o in [-4, 36)^2 ----
  // The sums run in the tap order, rounding, and without the FMA
  // contraction of the plain version's separable convolutions (rows first,
  // then columns, each a sequential sum of weight * tap), so the Harris
  // surface and its NMS ties come out as the plain version's do.
  float* p_xx = sm + OFF_P;
  float* p_yy = p_xx + PR * PR;
  float* p_xy = p_yy + PR * PR;
  for (int i = tid; i < PR * PR; i += NT) {
    const int sy = i / PR + (HALO - 4), sx = i % PR + (HALO - 4);
    // ix: [1,2,1] down the rows, then [-1,0,1] along the columns
    const float sm_l = __fadd_rn(__fadd_rn(IMG(sy - 1, sx - 1), 2.0f * IMG(sy, sx - 1)),
                                 IMG(sy + 1, sx - 1));
    const float sm_r = __fadd_rn(__fadd_rn(IMG(sy - 1, sx + 1), 2.0f * IMG(sy, sx + 1)),
                                 IMG(sy + 1, sx + 1));
    const float ix = __fsub_rn(sm_r, sm_l);
    // iy: [-1,0,1] down the rows, then [1,2,1] along the columns
    const float d_l = __fsub_rn(IMG(sy + 1, sx - 1), IMG(sy - 1, sx - 1));
    const float d_c = __fsub_rn(IMG(sy + 1, sx), IMG(sy - 1, sx));
    const float d_r = __fsub_rn(IMG(sy + 1, sx + 1), IMG(sy - 1, sx + 1));
    const float iy = __fadd_rn(__fadd_rn(d_l, 2.0f * d_c), d_r);
    p_xx[i] = __fmul_rn(ix, ix);
    p_yy[i] = __fmul_rn(iy, iy);
    p_xy[i] = __fmul_rn(ix, iy);
  }
  __syncthreads();

  // ---- 7-row box sums (weights 1/7): rows o in [-1, 33), cols o in [-4, 36) ----
  const float w7 = 1.0f / 7.0f;
  float* v_xx = sm + OFF_V;
  float* v_yy = v_xx + HR * PR;
  float* v_xy = v_yy + HR * PR;
  for (int i = tid; i < HR * PR; i += NT) {
    const int a = i / PR, b = i % PR;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      const int k = (a + d) * PR + b;
      sxx = fmaf(w7, p_xx[k], sxx);
      syy = fmaf(w7, p_yy[k], syy);
      sxy = fmaf(w7, p_xy[k], sxy);
    }
    v_xx[i] = sxx;
    v_yy[i] = syy;
    v_xy[i] = sxy;
  }
  __syncthreads();

  // ---- 7-col box sums -> Harris; FAST + interior mask -> candidates,
  //      both on o in [-1, 33)^2 ----
  float* s_h = sm + OFF_H;
  float* s_c = sm + OFF_C;
  for (int i = tid; i < HR * HR; i += NT) {
    const int a = i / HR, b = i % HR;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      const int k = a * PR + b + d;
      sxx = fmaf(w7, v_xx[k], sxx);
      syy = fmaf(w7, v_yy[k], syy);
      sxy = fmaf(w7, v_xy[k], sxy);
    }
    // (sxx*syy - sxy*sxy) - k*tr*tr, each operation rounded on its own
    const float tr = __fadd_rn(sxx, syy);
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const float hv = __fsub_rn(det, __fmul_rn(__fmul_rn(0.04f, tr), tr));
    s_h[i] = hv;

    const int gy = y0 + a - 1, gx = x0 + b - 1;  // level-local pixel
    const bool inside = gy >= border && gy < h - border && gx >= border &&
                        gx < w - border;
    bool corner = false;
    if (inside) {
      const int sy = a - 1 + HALO, sx = b - 1 + HALO;
      const float c = IMG(sy, sx);
      unsigned bright = 0u, dark = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float r = IMG(sy + kRingDy[k], sx + kRingDx[k]);
        bright |= static_cast<unsigned>(r - c > thr) << k;
        dark |= static_cast<unsigned>(c - r > thr) << k;
      }
      corner = any_arc9(bright) || any_arc9(dark);
    }
    s_c[i] = corner ? hv : -INFINITY;
  }
  __syncthreads();

  // ---- 3x3 NMS -> score; raw Harris out ----
  for (int i = tid; i < TILE * TILE; i += NT) {
    const int a = i / TILE, b = i % TILE;
    const int y = y0 + a, x = x0 + b;
    if (y >= h || x >= w0) continue;
    const size_t o = static_cast<size_t>(row0 + y) * w0 + x;
    if (x >= w) {
      o_score[o] = -INFINITY;
      o_harris[o] = 0.0f;
      continue;
    }
    const float c = s_c[(a + 1) * HR + (b + 1)];
    float mx = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, s_c[(a + dy) * HR + (b + dx)]);
    o_score[o] = (c >= mx) ? c : -INFINITY;
    o_harris[o] = s_h[(a + 1) * HR + (b + 1)];
  }
  __syncthreads();  // the product region is reused below

  // ---- moments: vertical box / ramp over 31 rows on cols o in [-15, 47) ----
  float* vb = sm + OFF_VB;
  float* vr = sm + OFF_VR;
  float* vg = sm + OFF_VG;
  for (int i = tid; i < TILE * MW; i += NT) {
    const int a = i / MW, c = i % MW;
    const int sy = a + HALO, sx = c - MR + HALO;
    float box = 0.0f, ramp = 0.0f;
    for (int d = -MR; d <= MR; ++d) {
      const float v = IMG(sy + d, sx);
      box += v;
      ramp += static_cast<float>(d) * v;
    }
    vb[i] = box;
    vr[i] = ramp;
  }
  // ---- blur: vertical 7-tap on cols o in [-3, 35) ----
  for (int i = tid; i < TILE * BW; i += NT) {
    const int a = i / BW, c = i % BW;
    const int sy = a + HALO, sx = c - 3 + HALO;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < 7; ++d) s += g.w[d] * IMG(sy + d - 3, sx);
    vg[i] = s;
  }
  __syncthreads();
#undef IMG

  for (int i = tid; i < TILE * TILE; i += NT) {
    const int a = i / TILE, b = i % TILE;
    const int y = y0 + a, x = x0 + b;
    if (y >= h || x >= w0) continue;
    const size_t o = static_cast<size_t>(row0 + y) * w0 + x;
    if (x >= w) {
      o_m10[o] = 0.0f;
      o_m01[o] = 0.0f;
      o_blur[o] = 0.0f;
      continue;
    }
    float m10 = 0.0f, m01 = 0.0f;
    for (int d = -MR; d <= MR; ++d) {
      const int k = a * MW + b + d + MR;
      m10 += static_cast<float>(d) * vb[k];
      m01 += vr[k];
    }
    float bl = 0.0f;
#pragma unroll
    for (int d = 0; d < 7; ++d) bl += g.w[d] * vg[a * BW + b + d];
    o_m10[o] = m10;
    o_m01[o] = m01;
    o_blur[o] = bl;
  }
}

}  // namespace

// img [rows, w0] f32 level stack; out [5, rows, w0] f32 (score, m10, m01,
// blur, harris); table [n_levels] x (row0, h, w, first tile row) int32 on
// the device; n_tile_rows = sum over levels of ceil(h / 32).
// Returns cudaGetLastError() after the launch.
extern "C" int detect_maps_launch(const float* img, float* out, const int* table,
                                  int n_levels, int n_tile_rows, int rows,
                                  int w0, float threshold, int border,
                                  void* stream) {
  // the sigma-2 7-tap Gaussian, normalized in double and rounded to f32
  // like ops/filters.py::_gaussian_kernel_np
  Gauss7 g;
  double k[7], sum = 0.0;
  for (int i = 0; i < 7; ++i) {
    const double x = i - 3.0;
    k[i] = exp(-(x * x) / (2.0 * 2.0 * 2.0));
    sum += k[i];
  }
  for (int i = 0; i < 7; ++i) g.w[i] = static_cast<float>(k[i] / sum);

  const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels > 0 && n_tile_rows > 0 && w0 > 0) {
    const dim3 grid((w0 + TILE - 1) / TILE, n_tile_rows);
    detect_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        img, out, reinterpret_cast<const int4*>(table), n_levels,
        static_cast<size_t>(rows) * w0, w0, threshold, border, g);
  }
  return static_cast<int>(cudaGetLastError());
}
