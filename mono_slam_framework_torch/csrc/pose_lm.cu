// Kernel B2: the whole motion-only pose LM (4 rounds x 10 iterations) in one
// launch.
//
// Replaces: mono_slam_framework_tpu/optim/pose_opt_pallas.py::_lm_kernel
// (launched by pose_optimize_pallas). Plain PyTorch version:
// mono_slam_framework_torch/optim/pose_opt.py::pose_optimize_plain (one
// problem) and pose_lm_batched_plain (a batch).
//
// What it computes, per pose problem: Optimizer::PoseOptimization's
// schedule. Each of 4 rounds restarts from T_init and runs 10 LM iterations
// over the edges that are valid and were inliers after the previous round:
// per-edge reprojection residuals times per-edge info, Huber IRLS weights in
// rounds 0-2, H = J^T W J (6x6) and b, Nielsen damping from
// lambda0 = tau * max diag H, a 6x6 solve, the left update exp(delta) * T,
// kept only if the robust chi2 drops. After each round every edge is
// reclassified by its information-weighted chi2 <= 5.991. The kernel ends
// with the outputs the caller needs: the pose with its rotation
// orthonormalized (two Newton steps of se3.orthonormalize), the inlier mask
// ANDed with valid, and the inlier count.
//
// What bounds it on the card: the dependent chain, not bytes or FLOPs. One
// problem at 2000 edges is ~50 KB of edges and ~16 MFLOP over 44 edge passes
// (4 rounds x (1 + 10)); between the passes lie 44 reductions and 40 serial
// 6x6 solves, each waiting on the one before.
//
// Design: a thread-block cluster of C CTAs per problem (grid = C x B), each
// CTA owning a contiguous slice of the problem's edge slots.
//  - Residency: each CTA stages its slice once with Hopper's bulk copy
//    (cp.async.bulk, completion on an mbarrier), then compacts the valid
//    edges into SoA arrays in shared memory, keeping each edge's slot for the
//    write-back. After that the 44 passes read only shared memory. Slots
//    beyond what 227 KB holds are read from device memory in the same passes.
//  - Reduction: each thread sums its edges' 28 terms (21 of H, 6 of b, chi2)
//    and the inlier count in registers; a reduce-scatter of 31 shuffles
//    leaves lane l of each warp with the warp's total of term l; one CTA
//    barrier, and warp 0 sums the warps' and pushes the CTA's totals into
//    every CTA of the cluster with st.async, which counts the bytes on the
//    receiving CTA's mbarrier (distributed shared memory; two buffers, so a
//    pass never overwrites totals still being read); each CTA waits for its
//    own mbarrier only, never for a cluster barrier; each lane sums its term
//    over the CTAs in a fixed order and 29 shuffles give every thread every
//    total. Every thread of the cluster holds bit-identical totals.
//  - No serial thread: every thread does the accept/reject rule, the
//    Cholesky solve and the SE(3) exp redundantly in registers (fully
//    unrolled, so nothing indexes a local array), and so holds the next pose.
//  - Reclassification from the carried chi2: each pass writes its edges'
//    chi2 into one of two shared buffers; an accepted step makes it the
//    carried one (as _lm_kernel carries e2), and the next round's first pass
//    reclassifies from it. Slots read from device memory keep their flag in
//    the inlier output instead, reclassified at each round's end.
// The Taylor branch of exp is the widened theta^2 < 2.5e-3 of se3.exp_se3.
// The kernel allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int N_ROUNDS = 4;
constexpr int N_ITERS = 10;
constexpr int NV = 32;  // reduced terms: 21 H, 6 b, chi2, inlier count, 3 unused
constexpr int I_CHI = 27;
constexpr int I_CNT = 28;
constexpr float TAU = 1e-5f;
constexpr float CHI2_MONO = 5.991f;
constexpr float HUBER_DELTA2 = 5.991f;
constexpr float SMALL_THETA2 = 2.5e-3f;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may have

// Shared-memory layout for n resident slots (a multiple of 16) per CTA in a
// cluster of C; mirrored by optim/pose_opt_cuda.py::smem_bytes.
struct Layout {
  uint32_t warp_red, cta_red, raw_xw, raw_uv, raw_valid, raw_info;
  uint32_t sx, sy, sz, su, sv, sw, idx, e2a, e2b, inl, total;
};

__host__ __device__ inline Layout layout(int n, int C) {
  Layout L;
  L.warp_red = 128;  // [0, 8) staging mbarrier, [16, 48) compaction counts,
                     // [64, 80) exchange mbarriers
  L.cta_red = L.warp_red + NWARP * 32 * 4;  // the CTA's warps' totals
  L.raw_xw = L.cta_red + 2 * C * 32 * 4;    // two buffers of the cluster's CTA totals
  L.raw_uv = L.raw_xw + 12 * n + 16;  // raw copies, 16 B of slack for alignment
  L.raw_valid = L.raw_uv + 8 * n + 16;
  L.raw_info = L.raw_valid + n + 16;
  L.sx = L.raw_info + 4 * n + 16;
  L.sy = L.sx + 4 * n;
  L.sz = L.sy + 4 * n;
  L.su = L.sz + 4 * n;
  L.sv = L.su + 4 * n;
  L.sw = L.sv + 4 * n;
  L.idx = L.sw + 4 * n;
  L.e2a = L.idx + 4 * n;
  L.e2b = L.e2a + 4 * n;
  L.inl = L.e2b + 4 * n;
  L.total = L.inl + n;  // = 1216 + 256 C + 62 n
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 16-byte-aligned span that covers [src, src + bytes): the bulk copy
// needs 16-byte alignment, and rounding out to 16 B never leaves the
// allocation (CUDA allocations are at least 256-byte aligned and sized).
__device__ __forceinline__ void span16(const void* src, uint32_t bytes,
                                       const char** a0, uint32_t* len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + bytes + 15) & ~uintptr_t(15);
  *a0 = reinterpret_cast<const char*>(lo);
  *len = bytes ? static_cast<uint32_t>(hi - lo) : 0u;
}

__device__ __forceinline__ void bulk_copy(void* dst, const char* src, uint32_t bytes,
                                          uint32_t mbar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete; acquire at cluster
// scope, so stores into this CTA from the cluster are visible after it.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  }
}

// The same shared-memory offset in the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v into another CTA's shared memory and count its 4 bytes on that
// CTA's mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

// Projection of X at pose T (rows 0-2 of a row-major 4x4); returns chi2.
struct Proj {
  float x, y, z, iz, r0, r1, e2;
};

__device__ __forceinline__ Proj project(const float T[12], float X0, float X1, float X2,
                                        float u, float v, float inf, float fx, float fy,
                                        float cx, float cy) {
  Proj p;
  p.x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  p.y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float zr = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  p.z = (zr == 0.0f) ? 1.0f : zr;
  p.iz = 1.0f / p.z;
  p.r0 = fx * p.x * p.iz + cx - u;
  p.r1 = fy * p.y * p.iz + cy - v;
  p.e2 = (p.r0 * p.r0 + p.r1 * p.r1) * inf;
  return p;
}

// One inlier edge's Huber-weighted terms of H (upper triangle, row-major),
// b and chi2.
__device__ __forceinline__ void accumulate(float acc[NV], const Proj& p, float inf,
                                           float fx, float fy, bool huber) {
  float w = 1.0f, rho = p.e2;
  if (huber && p.e2 > HUBER_DELTA2) {
    const float delta = sqrtf(HUBER_DELTA2);
    const float rs = rsqrtf(fmaxf(p.e2, 1e-12f));
    w = delta * rs;
    rho = 2.0f * delta * p.e2 * rs - HUBER_DELTA2;
  }
  w *= inf;
  acc[I_CHI] += rho;
  const float iz = p.iz;
  const float a0 = fx * iz, a2 = -fx * p.x * iz * iz;
  const float b1 = fy * iz, b2 = -fy * p.y * iz * iz;
  const float ju[6] = {a2 * p.y, a0 * p.z - a2 * p.x, -a0 * p.y, a0, 0.0f, a2};
  const float jv[6] = {-b1 * p.z + b2 * p.y, -b2 * p.x, b1 * p.x, 0.0f, b1, b2};
  int k = 0;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = r; c < 6; ++c) acc[k++] += w * (ju[r] * ju[c] + jv[r] * jv[c]);
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) acc[21 + r] += w * (ju[r] * p.r0 + jv[r] * p.r1);
}

// Solve (H + lam I) x = b by Cholesky; H given as the 21-entry upper
// triangle. A non-SPD system gives NaN, and the step is rejected.
__device__ __forceinline__ void solve6(const float h[21], const float b[6], float lam,
                                       float x[6]) {
  float L[6][6];
  int k = 0;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = r; c < 6; ++c) {
      L[c][r] = h[k] + (r == c ? lam : 0.0f);
      ++k;
    }
  }
  float inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = L[j][j];
#pragma unroll
    for (int p = 0; p < j; ++p) d -= L[j][p] * L[j][p];
    inv[j] = rsqrtf(d);  // NaN for d < 0
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = L[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) s -= L[i][p] * L[j][p];
      L[i][j] = s * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int p = 0; p < i; ++p) s -= L[i][p] * y[p];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int p = i + 1; p < 6; ++p) s -= L[p][i] * x[p];
    x[i] = s * inv[i];
  }
}

// out = exp(xi) * T for xi = [omega, upsilon]; T and out are rows 0-2 of
// row-major 4x4s (the last row is 0 0 0 1).
__device__ __forceinline__ void exp_left(const float xi[6], const float T[12], float out[12]) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float t2 = wx * wx + wy * wy + wz * wz;
  float A, B, C;
  if (t2 < SMALL_THETA2) {
    A = 1.0f - t2 * (1.0f / 6.0f) + t2 * t2 * (1.0f / 120.0f);
    B = 0.5f - t2 * (1.0f / 24.0f) + t2 * t2 * (1.0f / 720.0f);
    C = 1.0f / 6.0f - t2 * (1.0f / 120.0f) + t2 * t2 * (1.0f / 5040.0f);
  } else {
    const float rth = rsqrtf(t2), th = t2 * rth;
    float s, c;
    // the pi-scaled form reduces its argument exactly: sincosf's slow path
    // for large arguments would keep a local array (a stack frame)
    sincospif(th * 0.318309886183790672f, &s, &c);
    A = s * rth;
    B = (1.0f - c) * rth * rth;
    C = (1.0f - A) * rth * rth;
  }
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ti = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float id = (i == j) ? 1.0f : 0.0f;
      E[i][j] = id + A * W[i][j] + B * w2;
      ti += (id + B * W[i][j] + C * w2) * xi[3 + j];
    }
    E[i][3] = ti;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                       (j == 3 ? E[i][3] : 0.0f);
    }
  }
}

// One step of the warp's reduce-scatter: a lane keeps the half of its 2H
// terms selected by its bit H and adds its partner's copy of that half.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float acc[NV], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? acc[j] : acc[j + H];
    const float keep = upper ? acc[j + H] : acc[j];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

template <int C>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // release / acquire: remote stores are visible after it
  }
}

// Pairwise sum of n = 2^k values v[i * 32] (shared memory), in one fixed
// order, so every thread that sums the same values gets the same bits.
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    return tree_sum<N / 2>(v) + tree_sum<N / 2>(v + N / 2 * 32);
  }
}

// Sum acc[NV] over the cluster; returns with tot[0..28] in every thread.
// warp_red holds NWARP x 32 floats, cta_red this pass's C x 32, whose
// arrival the mbarrier `mb` (this pass's, of parity `parity`) counts.
template <int C>
__device__ __forceinline__ void cluster_reduce(float acc[NV], float* warp_red, float* cta_red,
                                               uint32_t mb, uint32_t parity, int rank,
                                               float tot[I_CNT + 1]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 31 shuffles: lane l ends with the warp's total of term l in acc[0]
  reduce_scatter_step<16>(acc, lane);
  reduce_scatter_step<8>(acc, lane);
  reduce_scatter_step<4>(acc, lane);
  reduce_scatter_step<2>(acc, lane);
  reduce_scatter_step<1>(acc, lane);
  warp_red[warp * 32 + lane] = acc[0];
  __syncthreads();
  if constexpr (C == 1) {
    if (warp == 0) cta_red[lane] = tree_sum<NWARP>(warp_red + lane);
    __syncthreads();
  } else {
    if (warp == 0) {  // the CTA's totals, pushed into every CTA of the cluster
      if (lane == 0) mbar_expect_tx(mb, C * 32 * 4);
      const float s = tree_sum<NWARP>(warp_red + lane);
      const uint32_t dst = smem_addr(cta_red + rank * 32 + lane);
#pragma unroll
      for (int r = 0; r < C; ++r) st_async(map_rank(dst, r), s, map_rank(mb, r));
    }
    mbar_wait(mb, parity);  // all C CTAs' totals have landed here
  }
  const float t = tree_sum<C>(cta_red + lane);
#pragma unroll
  for (int j = 0; j <= I_CNT; ++j) tot[j] = __shfl_sync(0xffffffffu, t, j);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
pose_lm_kernel(const float* __restrict__ xw, const float* __restrict__ uv,
               const uint8_t* __restrict__ valid, const float* __restrict__ info,
               const float* __restrict__ K, const float* __restrict__ t_init,
               float* __restrict__ t_out, uint8_t* __restrict__ inlier,
               int* __restrict__ n_good, int E, int slice, int n_res) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(n_res, C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x;  // the CTA's rank in its cluster (cluster dims C x 1)
  const size_t p = blockIdx.y;
  xw += p * E * 3;
  uv += p * E * 2;
  valid += p * E;
  if (info) info += p * E;
  inlier += p * E;
  const float fx = K[9 * p], cx = K[9 * p + 2], fy = K[9 * p + 4], cy = K[9 * p + 5];

  // this CTA's slots: [s0, s_end), the first n_stage of them resident
  const int s0 = min(E, rank * slice);
  const int s_end = min(E, s0 + slice);
  const int n_stage = min(s_end - s0, n_res);
  const int o0 = s0 + n_stage;  // first slot read from device memory

  // ---- stage the resident slots with bulk copies ----
  int* counts = reinterpret_cast<int*>(smem + 16);
  const uint32_t mb = smem_addr(smem);          // staging
  const uint32_t mb_x = smem_addr(smem + 64);   // exchange, one per cta_red buffer (+8)
  const char *g_xw, *g_uv, *g_va, *g_in;
  uint32_t n_xw, n_uv, n_va, n_in;
  span16(xw + 3 * s0, 12u * n_stage, &g_xw, &n_xw);
  span16(uv + 2 * s0, 8u * n_stage, &g_uv, &n_uv);
  span16(valid + s0, n_stage, &g_va, &n_va);
  span16(info ? info + s0 : nullptr, info ? 4u * n_stage : 0u, &g_in, &n_in);
  if (tid == 0) {
    mbar_init(mb);
    mbar_init(mb_x);
    mbar_init(mb_x + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(mb, n_xw + n_uv + n_va + n_in);
    bulk_copy(smem + L.raw_xw, g_xw, n_xw, mb);
    bulk_copy(smem + L.raw_uv, g_uv, n_uv, mb);
    bulk_copy(smem + L.raw_valid, g_va, n_va, mb);
    bulk_copy(smem + L.raw_info, g_in, n_in, mb);
  }
  // meanwhile: resident slots' flags start at 0 (the valid ones are written
  // at the end); device-memory slots start as valid (round 0 takes them all)
  for (int s = s0 + tid; s < o0; s += NT) inlier[s] = 0;
  for (int s = o0 + tid; s < s_end; s += NT) inlier[s] = valid[s];
  __syncthreads();  // the mbarrier is initialized before anyone waits on it
  mbar_wait(mb, 0);

  // ---- compact the valid resident slots into SoA arrays, in slot order ----
  const float* r_xw = reinterpret_cast<const float*>(
      smem + L.raw_xw + (reinterpret_cast<uintptr_t>(xw + 3 * s0) & 15));
  const float* r_uv = reinterpret_cast<const float*>(
      smem + L.raw_uv + (reinterpret_cast<uintptr_t>(uv + 2 * s0) & 15));
  const uint8_t* r_va = smem + L.raw_valid + (reinterpret_cast<uintptr_t>(valid + s0) & 15);
  const float* r_in = reinterpret_cast<const float*>(
      smem + L.raw_info + (info ? (reinterpret_cast<uintptr_t>(info + s0) & 15) : 0));
  float* sX = reinterpret_cast<float*>(smem + L.sx);
  float* sY = reinterpret_cast<float*>(smem + L.sy);
  float* sZ = reinterpret_cast<float*>(smem + L.sz);
  float* sU = reinterpret_cast<float*>(smem + L.su);
  float* sV = reinterpret_cast<float*>(smem + L.sv);
  float* sW = reinterpret_cast<float*>(smem + L.sw);
  int* sIdx = reinterpret_cast<int*>(smem + L.idx);
  float* e2a = reinterpret_cast<float*>(smem + L.e2a);
  float* e2b = reinterpret_cast<float*>(smem + L.e2b);
  uint8_t* sInl = smem + L.inl;
  int n_edge = 0;
  for (int c0 = 0; c0 < n_stage; c0 += NT) {
    const int s = c0 + tid;
    const bool v = s < n_stage && r_va[s] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) counts[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const int c = counts[w];
      before += (w < warp) ? c : 0;
      total += c;
    }
    if (v) {
      const int j = n_edge + before + __popc(bal & ((1u << lane) - 1u));
      sX[j] = r_xw[3 * s];
      sY[j] = r_xw[3 * s + 1];
      sZ[j] = r_xw[3 * s + 2];
      sU[j] = r_uv[2 * s];
      sV[j] = r_uv[2 * s + 1];
      sW[j] = info ? r_in[s] : 1.0f;
      sIdx[j] = s0 + s;
    }
    n_edge += total;
    __syncthreads();  // counts[] is reused
  }
  // every CTA of the cluster has started and initialized its mbarriers
  // before the first remote store
  cluster_barrier<C>();

  // ---- one edge pass at pose T: this thread's terms, then the cluster's ----
  float* warp_red = reinterpret_cast<float*>(smem + L.warp_red);
  float* cta_red = reinterpret_cast<float*>(smem + L.cta_red);
  int n_pass = 0;   // cta_red buffer and mbarrier: n_pass & 1; phase parity: n_pass >> 1 & 1
  int carried = 0;  // which e2 buffer holds the chi2 of the accepted pose
  auto pass = [&](const float T[12], bool huber, bool first, int rnd, float tot[I_CNT + 1]) {
    float acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.0f;
    const float* e2c = carried ? e2b : e2a;
    float* e2n = carried ? e2a : e2b;
    for (int j = tid; j < n_edge; j += NT) {
      bool m;
      if (first) {  // reclassify from the chi2 carried out of the last round
        m = rnd == 0 || e2c[j] <= CHI2_MONO;
        sInl[j] = m;
      } else {
        m = sInl[j] != 0;
      }
      const float inf = sW[j];
      const Proj pr = project(T, sX[j], sY[j], sZ[j], sU[j], sV[j], inf, fx, fy, cx, cy);
      e2n[j] = pr.e2;
      acc[I_CNT] += (pr.e2 <= CHI2_MONO) ? 1.0f : 0.0f;
      if (m) accumulate(acc, pr, inf, fx, fy, huber);
    }
    for (int s = o0 + tid; s < s_end; s += NT) {
      if (!valid[s]) continue;
      const float inf = info ? info[s] : 1.0f;
      const Proj pr = project(T, xw[3 * s], xw[3 * s + 1], xw[3 * s + 2], uv[2 * s],
                              uv[2 * s + 1], inf, fx, fy, cx, cy);
      acc[I_CNT] += (pr.e2 <= CHI2_MONO) ? 1.0f : 0.0f;
      if (inlier[s]) accumulate(acc, pr, inf, fx, fy, huber);
    }
    // the next pass fills the other buffer while this one is read
    const int b = n_pass & 1;
    cluster_reduce<C>(acc, warp_red, cta_red + b * (C * 32), mb_x + 8 * b, (n_pass >> 1) & 1,
                      rank, tot);
    ++n_pass;
  };

  float Ti[12], T[12], Tn[12], H[21], bv[6];
#pragma unroll
  for (int j = 0; j < 12; ++j) Ti[j] = t_init[16 * p + j];
  float chi = 0.0f, cnt = 0.0f, lam = 0.0f, nu = 2.0f;
  float tot[I_CNT + 1];
  for (int rnd = 0; rnd < N_ROUNDS; ++rnd) {
    const bool huber = rnd < 3;
    pass(Ti, huber, true, rnd, tot);
    carried ^= 1;
#pragma unroll
    for (int j = 0; j < 12; ++j) T[j] = Ti[j];
#pragma unroll
    for (int j = 0; j < 21; ++j) H[j] = tot[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) bv[j] = tot[21 + j];
    chi = tot[I_CHI];
    cnt = tot[I_CNT];
    // diagonal of the row-major upper triangle: indices 0, 6, 11, 15, 18, 20
    lam = TAU * fmaxf(fmaxf(fmaxf(H[0], H[6]), fmaxf(H[11], H[15])), fmaxf(H[18], H[20]));
    nu = 2.0f;
    for (int it = 0; it < N_ITERS; ++it) {
      float x[6], delta[6];
      solve6(H, bv, lam, x);
#pragma unroll
      for (int j = 0; j < 6; ++j) delta[j] = -x[j];
      exp_left(delta, T, Tn);
      pass(Tn, huber, false, rnd, tot);
      const float chi_new = tot[I_CHI];
      float pred = 0.0f;  // delta^T (lambda*delta - b)
#pragma unroll
      for (int j = 0; j < 6; ++j) pred += delta[j] * (lam * delta[j] - bv[j]);
      const float rho = (chi - chi_new) / fmaxf(pred, 1e-12f);
      if (isfinite(chi_new) && chi_new < chi) {
        const float g = 2.0f * rho - 1.0f;
        lam *= fmaxf(1.0f / 3.0f, 1.0f - g * g * g);
        nu = 2.0f;
        chi = chi_new;
        cnt = tot[I_CNT];
        carried ^= 1;
#pragma unroll
        for (int j = 0; j < 12; ++j) T[j] = Tn[j];
#pragma unroll
        for (int j = 0; j < 21; ++j) H[j] = tot[j];
#pragma unroll
        for (int j = 0; j < 6; ++j) bv[j] = tot[21 + j];
      } else {
        lam *= nu;
        nu *= 2.0f;
      }
    }
    // slots read from device memory: reclassify at the round's pose
    for (int s = o0 + tid; s < s_end; s += NT) {
      if (!valid[s]) continue;
      const float inf = info ? info[s] : 1.0f;
      const Proj pr = project(T, xw[3 * s], xw[3 * s + 1], xw[3 * s + 2], uv[2 * s],
                              uv[2 * s + 1], inf, fx, fy, cx, cy);
      inlier[s] = pr.e2 <= CHI2_MONO;
    }
  }

  // ---- epilogue: inlier flags, orthonormalized pose, count ----
  const float* e2f = carried ? e2b : e2a;
  for (int j = tid; j < n_edge; j += NT) inlier[sIdx[j]] = e2f[j] <= CHI2_MONO;
  if (rank == 0 && tid == 0) {
    float R[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = T[4 * i + j];
#pragma unroll
    for (int n = 0; n < 2; ++n) {  // R <- 1.5 R - 0.5 (R R^T) R
      float S[3][3], Rn[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          S[i][j] = R[i][0] * R[j][0] + R[i][1] * R[j][1] + R[i][2] * R[j][2];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rn[i][j] = 1.5f * R[i][j] -
                     0.5f * (S[i][0] * R[0][j] + S[i][1] * R[1][j] + S[i][2] * R[2][j]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
    }
    float* to = t_out + 16 * p;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) to[4 * i + j] = R[i][j];
      to[4 * i + 3] = T[4 * i + 3];
    }
    to[12] = 0.0f;
    to[13] = 0.0f;
    to[14] = 0.0f;
    to[15] = 1.0f;
    n_good[p] = static_cast<int>(cnt);
  }
}

template <int C>
int launch(const float* xw, const float* uv, const uint8_t* valid, const float* info,
           const float* K, const float* t_init, float* t_out, uint8_t* inlier, int* n_good,
           int B, int E, int slice, int n_res, int smem, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      pose_lm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_lm_kernel<C>, xw, uv, valid, info, K,
                                             t_init, t_out, inlier, n_good, E, slice, n_res);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// xw [B,E,3], uv [B,E,2] f32; valid [B,E] bool; info [B,E] f32 or null (all
// ones); K [B,3,3], t_init [B,4,4] f32. Writes t_out [B,4,4] (rotation
// orthonormalized), inlier [B,E] bool (ANDed with valid) and n_good [B]
// int32. The launch plan (cluster size, slots per CTA, resident slots per
// CTA, shared-memory bytes) comes from optim/pose_opt_cuda.py::lm_plan; a
// plan the kernel cannot run is refused with cudaErrorInvalidValue.
// Returns the launch's error code.
extern "C" int pose_lm_launch(const float* xw, const float* uv, const void* valid,
                              const float* info, const float* K, const float* t_init,
                              float* t_out, void* inlier, void* n_good, int B, int E,
                              int cluster, int slice, int n_res, int smem, void* stream) {
  if (slice % 16 != 0 || n_res % 16 != 0 || n_res > slice ||
      static_cast<long long>(cluster) * slice < E || smem != static_cast<int>(layout(n_res, cluster).total) ||
      smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto va = static_cast<const uint8_t*>(valid);
  const auto in = static_cast<uint8_t*>(inlier);
  const auto ng = static_cast<int*>(n_good);
  switch (cluster) {
    case 1: return launch<1>(xw, uv, va, info, K, t_init, t_out, in, ng, B, E, slice, n_res, smem, st);
    case 2: return launch<2>(xw, uv, va, info, K, t_init, t_out, in, ng, B, E, slice, n_res, smem, st);
    case 4: return launch<4>(xw, uv, va, info, K, t_init, t_out, in, ng, B, E, slice, n_res, smem, st);
    case 8: return launch<8>(xw, uv, va, info, K, t_init, t_out, in, ng, B, E, slice, n_res, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
