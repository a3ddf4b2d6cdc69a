// Kernel B1: fused ORB detection maps over every pyramid level in one launch.
//
// Replaces: mono_slam_framework_tpu/ops/pallas_detect.py::_multi_kernel
// (launched by detect_stage_multi_bands; its per-level forms _banded_kernel
// and _full_kernel compute the same maps and are this launch over one level).
// Plain PyTorch version: mono_slam_framework_torch/ops/detect.py::
// detect_maps_plain.
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
// stack; the table holds (row0, h, w, first tile row) per level
// (ops/detect.py::tile_plan). N streams' stacks [N, rows, w0] run in one
// launch (the counterpart of detect_stage_multi_bands(..., n_streams=N)):
// blockIdx.z is the stream, every stream reads the same one-stream level
// table, and the output is [5, N, rows, w0], so each map of all N streams
// is one contiguous [N, rows, w0] block (ops/orb.py reads it per stream
// with a stream offset, without a copy). N = 1 is the one-stream launch.
//
// What bounds it on the card: shared-memory traffic per tile, not device
// memory (the launch moves ~34 MB at 640x480, 10 us at 3.35 TB/s). Summing
// the 31-tap moments tap by tap cost ~186 shared-memory reads per output
// pixel.
//
// Design: one 384-thread block per 32-row x 64-column output tile of one
// level, its input window (16-px halo, reads clamped to the level) loaded
// once into shared memory. Every map is computed there in separable passes:
//  - moments by running sums in f64 registers: a thread walks along a row
//    keeping the box and ramp sums of the 31 taps (adding the entering pixel,
//    dropping the leaving one: ramp(x+1) = ramp(x) + 15 I(x-15) + 16 I(x+16)
//    - box(x+1)), then a thread walks down a column doing the same over the
//    row sums and writes m10 / m01 (consecutive threads, consecutive
//    columns: coalesced). About 10 shared reads per pixel. f64 keeps the
//    running sums exact to f32 output rounding (f32 running sums would drift
//    by up to ~3 over a walk), so they differ from the plain version's only
//    by its own f32 reassociation;
//  - Harris by walks too, keeping the 7 taps of the box sums in registers:
//    down a column for the Sobel products and their 7-row sums, along a row
//    for the 7-column sums, FAST-9 and the candidate map. The sums run in the
//    plain version's tap order with its rounding and without FMA contraction
//    of the Sobel and Harris terms, so the score map is bit-identical to the
//    plain version's and no NMS tie flips;
//  - the 7-tap Gaussian in the plain version's tap order.
// Shared memory: 66,184 B per block (img 64 x 97, row sums / box sums 32,240
// B, Gaussian / Harris 9,112 B; odd strides keep row walks free of bank
// conflicts): 32 B per output pixel, 3 blocks = 1152 threads per SM.
// Tiles wholly in the padded columns only store their constants (float4).
// The smem attribute is set once per process, the Gaussian weights are
// compile-time constants.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TH = 32;  // output tile rows
constexpr int TW = 64;  // output tile columns
constexpr int HALO = 16;  // the largest stencil radius is the moments' 15
constexpr int NT = 384;
constexpr int MR = 15;  // moment radius
constexpr int WH = TH + 2 * HALO;  // 64: window rows
constexpr int WW = TW + 2 * HALO;  // 96: window columns
constexpr int IS = WW + 1;         // 97: window row stride
// row sums of the moments: rows o in [-15, TH+15), cols o in [0, TW)
constexpr int MH = TH + 2 * MR;  // 62
constexpr int MS = TW + 1;       // 65
// Harris: 7-row sums on rows o in [-1, TH+1), cols o in [-4, TW+4); the
// surface and corner flags on o in [-1, TH+1) x [-1, TW+1)
constexpr int VR = TH + 2;   // 34
constexpr int VC = TW + 8;   // 72
constexpr int VS = VC + 1;   // 73
constexpr int HC = TW + 2;   // 66
constexpr int HS = HC + 1;   // 67
// Gaussian column sums: rows o in [0, TH), cols o in [-3, TW+3)
constexpr int BC = TW + 6;  // 70
constexpr int VSEG = 17;    // Harris column-walk segment (2 per column)
constexpr int HSEG = 6;     // Harris row-walk segment (11 per row)
constexpr int MSEG = 16;    // moment row-walk segment (4 per row)
constexpr int CSEG = 16;    // moment column-walk segment (2 per column)

// shared-memory regions (bytes)
constexpr int IMG_BYTES = WH * IS * 4;                 // 24,832
constexpr int A_BYTES = 2 * MH * MS * 4;               // 32,240: moment row sums,
constexpr int V_BYTES = 3 * VR * VS * 4;               //   later Harris 7-row sums
constexpr int CORNER_OFF = V_BYTES;                    //   and corner flags
constexpr int B_BYTES = VR * HS * 4;                   // 9,112: Gaussian column
constexpr int SMEM_BYTES = IMG_BYTES + A_BYTES + B_BYTES;  // sums, later Harris
static_assert(CORNER_OFF + VR * HS <= A_BYTES, "corner flags overflow region A");
static_assert(TH * BC * 4 <= B_BYTES, "Gaussian sums overflow region B");
static_assert(2 * VSEG == VR && (HC % HSEG) == 0 && (TW % MSEG) == 0 && (TH % CSEG) == 0,
              "walk segments must tile their regions");
static_assert((WH * WW) % NT == 0, "the window load is unrolled");

// Bresenham circle of radius 3, clockwise: ops/fast.py CIRCLE order
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
// the sigma-2 7-tap Gaussian normalized in double and rounded to f32, as
// ops/filters.py::_gaussian_kernel_np(7, 2.0)
__constant__ float kGauss[7] = {0x1.1f5f62p-4f, 0x1.0c70fcp-3f, 0x1.869472p-3f, 0x1.ba95c0p-3f,
                                0x1.869472p-3f, 0x1.0c70fcp-3f, 0x1.1f5f62p-4f};

__device__ __forceinline__ bool any_arc9(unsigned m) {
  const unsigned m32 = m | (m << 16);
  unsigned t = m32;
#pragma unroll
  for (int k = 1; k < 9; ++k) t &= m32 >> k;
  return (t & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(NT, 3)
detect_kernel(const float* __restrict__ img, float* __restrict__ out,
              const int4* __restrict__ levels, int n_levels, size_t plane, size_t stack,
              int w0, float thr, int border) {
  extern __shared__ __align__(16) float sm[];
  // this block's stream: its stack in the input, its rows in each map
  img += static_cast<size_t>(blockIdx.z) * stack;
  out += static_cast<size_t>(blockIdx.z) * stack;
  float* s_img = sm;
  float* reg_a = sm + IMG_BYTES / 4;
  float* reg_b = reg_a + A_BYTES / 4;

  // this tile's level: the last level whose first tile row is <= blockIdx.y
  int l = 0;
  while (l + 1 < n_levels && levels[l + 1].w <= static_cast<int>(blockIdx.y)) ++l;
  const int4 lv = levels[l];
  const int row0 = lv.x, h = lv.y, w = lv.z;
  const int y0 = (static_cast<int>(blockIdx.y) - lv.w) * TH;  // level-local
  const int x0 = static_cast<int>(blockIdx.x) * TW;
  const int tid = threadIdx.x;

  // plane: the distance between two maps of the output (N stacks)
  float* o_score = out;
  float* o_m10 = out + plane;
  float* o_m01 = out + 2 * plane;
  float* o_blur = out + 3 * plane;
  float* o_harris = out + 4 * plane;
  // level-local (y, x) -> offset into one map, and whether it is stored
  auto at = [&](int y, int x) { return static_cast<size_t>(row0 + y) * w0 + x; };
  auto stored = [&](int y, int x) { return y < h && x < w0; };

  if (x0 >= w) {  // a tile wholly in the padded columns: constants only
    const int ncol = min(TW, w0 - x0);
    if ((w0 & 3) == 0) {  // rows and x0 are 16-byte aligned
      const float4 ninf = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = tid; i < TH * (TW / 4); i += NT) {
        const int y = y0 + i / (TW / 4), x = x0 + 4 * (i % (TW / 4));
        if (y >= h || x - x0 >= ncol) continue;
        const size_t o = at(y, x);
        reinterpret_cast<float4*>(o_score + o)[0] = ninf;
        reinterpret_cast<float4*>(o_m10 + o)[0] = zero;
        reinterpret_cast<float4*>(o_m01 + o)[0] = zero;
        reinterpret_cast<float4*>(o_blur + o)[0] = zero;
        reinterpret_cast<float4*>(o_harris + o)[0] = zero;
      }
    } else {
      for (int i = tid; i < TH * TW; i += NT) {
        const int y = y0 + i / TW, x = x0 + i % TW;
        if (!stored(y, x)) continue;
        const size_t o = at(y, x);
        o_score[o] = -INFINITY;
        o_m10[o] = o_m01[o] = o_blur[o] = o_harris[o] = 0.0f;
      }
    }
    return;
  }

  // ---- P1: the input window, reads clamped to the level (all in flight) ----
#pragma unroll
  for (int k = 0; k < WH * WW / NT; ++k) {
    const int i = tid + k * NT;
    const int r = i / WW, c = i % WW;
    const int gy = min(max(y0 - HALO + r, 0), h - 1);
    const int gx = min(max(x0 - HALO + c, 0), w - 1);
    s_img[r * IS + c] = img[static_cast<size_t>(row0 + gy) * w0 + gx];
  }
  __syncthreads();
  // window pixel at tile offset (oy, ox)
#define IMG(oy, ox) s_img[((oy) + HALO) * IS + (ox) + HALO]

  // ---- P2: moment row sums: box hb and ramp hr of 31 columns, by row walks ----
  float* hb = reg_a;  // [MH][MS], row index oy + 15
  float* hr = reg_a + MH * MS;
  for (int i = tid; i < MH * (TW / MSEG); i += NT) {
    const int oy = i % MH - MR, xs = (i / MH) * MSEG;
    double box = 0.0, ramp = 0.0;
#pragma unroll 4
    for (int d = -MR; d <= MR; ++d) {
      const double v = IMG(oy, xs + d);
      box += v;
      ramp += d * v;
    }
    float* rb = hb + (oy + MR) * MS;
    float* rr = hr + (oy + MR) * MS;
    rb[xs] = static_cast<float>(box);
    rr[xs] = static_cast<float>(ramp);
#pragma unroll 4
    for (int x = xs + 1; x < xs + MSEG; ++x) {
      const double leave = IMG(oy, x - MR - 1), enter = IMG(oy, x + MR);
      box += enter - leave;
      ramp += 15.0 * leave + 16.0 * enter - box;
      rb[x] = static_cast<float>(box);
      rr[x] = static_cast<float>(ramp);
    }
  }
  __syncthreads();

  // ---- P3: m10 / m01 by column walks over the row sums; Gaussian column sums ----
  constexpr int N_MWALK = TW * (TH / CSEG);  // 128
  float* vg = reg_b;                          // [TH][BC]
  if (tid < N_MWALK) {
    const int ox = tid % TW, ys = (tid / TW) * CSEG;
    const int x = x0 + ox;
    double boxr = 0.0, boxb = 0.0, rampb = 0.0;
#pragma unroll 4
    for (int d = -MR; d <= MR; ++d) {
      const double b = hb[(ys + d + MR) * MS + ox];
      boxr += hr[(ys + d + MR) * MS + ox];
      boxb += b;
      rampb += d * b;
    }
#pragma unroll 4
    for (int oy = ys; oy < ys + CSEG; ++oy) {
      if (oy > ys) {
        const int ro = (oy - 1) * MS + ox, ri = (oy + 2 * MR) * MS + ox;  // rows oy-16, oy+15
        const double lb = hb[ro], eb = hb[ri];
        boxr += static_cast<double>(hr[ri]) - hr[ro];
        boxb += eb - lb;
        rampb += 15.0 * lb + 16.0 * eb - boxb;
      }
      const int y = y0 + oy;
      if (stored(y, x)) {
        const size_t o = at(y, x);
        o_m10[o] = x < w ? static_cast<float>(boxr) : 0.0f;
        o_m01[o] = x < w ? static_cast<float>(rampb) : 0.0f;
      }
    }
  } else {
    for (int i = tid - N_MWALK; i < TH * BC; i += NT - N_MWALK) {
      const int a = i / BC, ox = i % BC - 3;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < 7; ++d) s += kGauss[d] * IMG(a + d - 3, ox);
      vg[i] = s;
    }
  }
  __syncthreads();

  // ---- P4: Harris 7-row sums by column walks; Gaussian row sums -> blur ----
  // The sums run in the tap order, rounding, and without the FMA
  // contraction of the plain version's separable convolutions (rows first,
  // then columns, each a sequential sum of weight * tap), so the Harris
  // surface and its NMS ties come out as the plain version's do.
  constexpr int N_VWALK = VC * 2;  // 144
  const float w7 = 1.0f / 7.0f;
  float* v_xx = reg_a;  // [VR][VS], row index oy + 1, column index ox + 4
  float* v_yy = v_xx + VR * VS;
  float* v_xy = v_yy + VR * VS;
  if (tid < N_VWALK) {
    const int c = tid % VC, ox = c - 4;
    const int vs = (tid / VC) * VSEG - 1;  // 7-row sums of rows vs .. vs + VSEG - 1
    // products rows vs-3 .. vs+VSEG+2, Sobel from window rows one beyond
    float a0[3], a1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a0[k] = IMG(vs - 4, ox - 1 + k);
      a1[k] = IMG(vs - 3, ox - 1 + k);
    }
    float pxx[7] = {}, pyy[7] = {}, pxy[7] = {};
#pragma unroll
    for (int k = 0; k < VSEG + 6; ++k) {  // product row py = vs - 3 + k
      const int py = vs - 3 + k;
      float a2[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) a2[j] = IMG(py + 1, ox - 1 + j);
      // ix: [1,2,1] down the rows, then [-1,0,1] along the columns
      const float sm_l = __fadd_rn(__fadd_rn(a0[0], 2.0f * a1[0]), a2[0]);
      const float sm_r = __fadd_rn(__fadd_rn(a0[2], 2.0f * a1[2]), a2[2]);
      const float ix = __fsub_rn(sm_r, sm_l);
      // iy: [-1,0,1] down the rows, then [1,2,1] along the columns
      const float d_l = __fsub_rn(a2[0], a0[0]);
      const float d_c = __fsub_rn(a2[1], a0[1]);
      const float d_r = __fsub_rn(a2[2], a0[2]);
      const float iy = __fadd_rn(__fadd_rn(d_l, 2.0f * d_c), d_r);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        pxx[j] = pxx[j + 1];
        pyy[j] = pyy[j + 1];
        pxy[j] = pxy[j + 1];
      }
      pxx[6] = __fmul_rn(ix, ix);
      pyy[6] = __fmul_rn(iy, iy);
      pxy[6] = __fmul_rn(ix, iy);
      if (k >= 6) {  // the sum for row py - 3 is complete
        float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
        for (int d = 0; d < 7; ++d) {
          sxx = fmaf(w7, pxx[d], sxx);
          syy = fmaf(w7, pyy[d], syy);
          sxy = fmaf(w7, pxy[d], sxy);
        }
        const int k_out = (py - 3 + 1) * VS + c;
        v_xx[k_out] = sxx;
        v_yy[k_out] = syy;
        v_xy[k_out] = sxy;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a0[j] = a1[j];
        a1[j] = a2[j];
      }
    }
  } else {
    for (int i = tid - N_VWALK; i < TH * TW; i += NT - N_VWALK) {
      const int a = i / TW, b = i % TW;
      const int y = y0 + a, x = x0 + b;
      if (!stored(y, x)) continue;
      float bl = 0.0f;
#pragma unroll
      for (int d = 0; d < 7; ++d) bl += kGauss[d] * vg[a * BC + b + d];
      o_blur[at(y, x)] = x < w ? bl : 0.0f;
    }
  }
  __syncthreads();

  // ---- P5: 7-column sums -> Harris, FAST + interior mask -> corner flags,
  //      by row walks on o in [-1, TH+1) x [-1, TW+1) ----
  float* s_h = reg_b;  // [VR][HS], index (oy + 1) * HS + ox + 1
  uint8_t* s_corner = reinterpret_cast<uint8_t*>(reg_a) + CORNER_OFF;
  for (int i = tid; i < VR * (HC / HSEG); i += NT) {
    const int a = i % VR, oy = a - 1;
    const int xs = (i / VR) * HSEG - 1;  // first output column of this walk
    const float* rxx = v_xx + a * VS;
    const float* ryy = v_yy + a * VS;
    const float* rxy = v_xy + a * VS;
    float qxx[7] = {}, qyy[7] = {}, qxy[7] = {};  // 7-row sums, columns ox - 3 .. ox + 3
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      qxx[d + 1] = rxx[xs - 3 + d + 4];
      qyy[d + 1] = ryy[xs - 3 + d + 4];
      qxy[d + 1] = rxy[xs - 3 + d + 4];
    }
#pragma unroll
    for (int k = 0; k < HSEG; ++k) {
      const int ox = xs + k;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        qxx[j] = qxx[j + 1];
        qyy[j] = qyy[j + 1];
        qxy[j] = qxy[j + 1];
      }
      qxx[6] = rxx[ox + 3 + 4];
      qyy[6] = ryy[ox + 3 + 4];
      qxy[6] = rxy[ox + 3 + 4];
      float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
      for (int d = 0; d < 7; ++d) {
        sxx = fmaf(w7, qxx[d], sxx);
        syy = fmaf(w7, qyy[d], syy);
        sxy = fmaf(w7, qxy[d], sxy);
      }
      // (sxx*syy - sxy*sxy) - k*tr*tr, each operation rounded on its own
      const float tr = __fadd_rn(sxx, syy);
      const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
      s_h[a * HS + ox + 1] = __fsub_rn(det, __fmul_rn(__fmul_rn(0.04f, tr), tr));

      const int gy = y0 + oy, gx = x0 + ox;  // level-local pixel
      const bool inside = gy >= border && gy < h - border && gx >= border && gx < w - border;
      bool corner = false;
      if (inside) {
        const float c = IMG(oy, ox);
        // an arc of 9 of the 16 ring pixels holds at least 2 of the 4 at
        // ring positions 0, 4, 8, 12: fewer rules the pixel out, exactly
        const float n0 = IMG(oy - 3, ox), n4 = IMG(oy, ox + 3);
        const float n8 = IMG(oy + 3, ox), n12 = IMG(oy, ox - 3);
        const int nb = (n0 - c > thr) + (n4 - c > thr) + (n8 - c > thr) + (n12 - c > thr);
        const int nd = (c - n0 > thr) + (c - n4 > thr) + (c - n8 > thr) + (c - n12 > thr);
        if (nb >= 2 || nd >= 2) {
          unsigned bright = 0u, dark = 0u;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float r = IMG(oy + kRingDy[q], ox + kRingDx[q]);
            bright |= static_cast<unsigned>(r - c > thr) << q;
            dark |= static_cast<unsigned>(c - r > thr) << q;
          }
          corner = any_arc9(bright) || any_arc9(dark);
        }
      }
      s_corner[a * HS + ox + 1] = corner;
    }
  }
  __syncthreads();
#undef IMG

  // ---- P6: 3x3 NMS -> score; raw Harris out ----
  for (int i = tid; i < TH * TW; i += NT) {
    const int a = i / TW, b = i % TW;
    const int y = y0 + a, x = x0 + b;
    if (!stored(y, x)) continue;
    const size_t o = at(y, x);
    if (x >= w) {
      o_score[o] = -INFINITY;
      o_harris[o] = 0.0f;
      continue;
    }
    const int k = (a + 1) * HS + (b + 1);
    const float c = s_corner[k] ? s_h[k] : -INFINITY;
    float mx = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int kk = (a + dy) * HS + (b + dx);
        mx = fmaxf(mx, s_corner[kk] ? s_h[kk] : -INFINITY);
      }
    o_score[o] = (c >= mx) ? c : -INFINITY;
    o_harris[o] = s_h[k];
  }
}

// A kernel's dynamic shared-memory limit is a per-device attribute: raise it
// once on each device a launch meets (the current one), never once per
// process, which would leave every other card at the 48 KB default.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// img [n_streams, rows, w0] f32 level stacks; out [5, n_streams, rows, w0]
// f32 (score, m10, m01, blur, harris); table [n_levels] x (row0, h, w, first
// tile row) int32 on the device, one stream's; grid_x x grid_y tiles of
// 32 x 64 per stream (ops/detect.py::tile_plan). Returns the launch's error
// code.
extern "C" int detect_maps_batch_launch(const float* img, float* out, const int* table,
                                        int n_levels, int grid_x, int grid_y, int n_streams,
                                        int rows, int w0, float threshold, int border,
                                        void* stream) {
  static std::atomic<bool> smem_raised[MAX_DEVICES];
  const cudaError_t attr = raise_smem_limit(detect_kernel, SMEM_BYTES, smem_raised);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_levels > 0 && grid_x > 0 && grid_y > 0 && n_streams > 0) {
    const size_t stack = static_cast<size_t>(rows) * w0;
    detect_kernel<<<dim3(grid_x, grid_y, n_streams), NT, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
        img, out, reinterpret_cast<const int4*>(table), n_levels, n_streams * stack, stack,
        w0, threshold, border);
  }
  return static_cast<int>(cudaGetLastError());
}

// One stream: img [rows, w0], out [5, rows, w0].
extern "C" int detect_maps_launch(const float* img, float* out, const int* table,
                                  int n_levels, int grid_x, int grid_y, int rows, int w0,
                                  float threshold, int border, void* stream) {
  return detect_maps_batch_launch(img, out, table, n_levels, grid_x, grid_y, 1, rows, w0,
                                  threshold, border, stream);
}
