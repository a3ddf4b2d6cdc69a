// Kernel B2: the whole motion-only pose LM (4 rounds x 10 iterations) in one
// launch.
//
// Replaces: mono_slam_framework_tpu/optim/pose_opt_pallas.py::_lm_kernel
// (launched by pose_optimize_pallas). Plain PyTorch version:
// mono_slam_framework_torch/optim/pose_opt.py::pose_optimize_plain.
//
// What it computes, per pose problem: Optimizer::PoseOptimization's
// schedule. Each of 4 rounds restarts from T_init and runs 10 LM iterations
// over the edges that are valid and were inliers after the previous round:
// per-edge reprojection residuals times per-edge info, Huber IRLS weights in
// rounds 0-2, H = J^T W J (6x6) and b, Nielsen damping from
// lambda0 = tau * max diag H, a 6x6 solve, the left update exp(delta) * T,
// kept only if the robust chi2 drops. After each round every edge is
// reclassified by its information-weighted chi2 <= 5.991.
//
// What bounds it on the card: latency, not bytes or FLOPs. One problem is
// ~2000 edges x 44 edge passes (~4 MFLOP, 100 KB of edges read from L2 each
// pass); the 40 serial 6x6 solves and the block-wide reductions between the
// passes are a dependent chain of ~90 barriers.
//
// Design: one thread block per pose problem (grid = B problems, so a batch of
// camera streams can share the launch). The 256 threads stride over the
// edges at the trial pose and each accumulates its share of the 21 entries
// of H, the 6 of b and chi2 in registers; a warp-shuffle then shared-memory
// reduction combines them. Thread 0 then does the serial step in registers:
// the Nielsen accept/reject rule, a Cholesky solve of H + lambda*I (SPD),
// and the SE(3) exp, and broadcasts the new trial pose through shared
// memory. The per-edge inlier flags live in the output array between rounds.
// The Taylor branch of exp is the widened theta^2 < 2.5e-3 of se3.exp_se3.
// The kernel allocates nothing and keeps no limit on the number of edges.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int N_ROUNDS = 4;
constexpr int N_ITERS = 10;
constexpr int NACC = 28;  // 21 upper-triangle H entries, 6 b entries, chi2
constexpr float TAU = 1e-5f;
constexpr float CHI2_MONO = 5.991f;
constexpr float HUBER_DELTA2 = 5.991f;
constexpr float SMALL_THETA2 = 2.5e-3f;

// Edge pass at pose T (row-major 4x4 in shared memory): accumulates this
// thread's share of H (upper triangle, row-major), b and chi2.
__device__ void edge_pass(const float* __restrict__ xw,
                          const float* __restrict__ uv,
                          const float* __restrict__ valid,
                          const float* __restrict__ info,
                          const float* inlier, int E,  // written between rounds:
                                                       // no read-only-cache path
                          const float* T, float fx, float fy, float cx,
                          float cy, bool huber, float acc[NACC]) {
  const float delta = sqrtf(HUBER_DELTA2);
  for (int i = threadIdx.x; i < E; i += NT) {
    const float m = valid[i] * inlier[i];
    if (m == 0.0f) continue;
    const float X0 = xw[3 * i], X1 = xw[3 * i + 1], X2 = xw[3 * i + 2];
    const float x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
    const float y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
    const float zr = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
    const float z = (zr == 0.0f) ? 1.0f : zr;
    const float r0 = fx * x / z + cx - uv[2 * i];
    const float r1 = fy * y / z + cy - uv[2 * i + 1];
    const float inf_i = info[i];
    const float e2 = (r0 * r0 + r1 * r1) * inf_i;
    float w = 1.0f, rho = e2;
    if (huber && e2 > HUBER_DELTA2) {
      const float s = sqrtf(fmaxf(e2, 1e-12f));
      w = delta / s;
      rho = 2.0f * delta * s - HUBER_DELTA2;
    }
    w *= inf_i * m;
    acc[27] += rho * m;
    const float iz = 1.0f / z;
    const float a0 = fx * iz, a2 = -fx * x * iz * iz;
    const float b1 = fy * iz, b2 = -fy * y * iz * iz;
    const float ju[6] = {a2 * y, a0 * z - a2 * x, -a0 * y, a0, 0.0f, a2};
    const float jv[6] = {-b1 * z + b2 * y, -b2 * x, b1 * x, 0.0f, b1, b2};
    int k = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int c = r; c < 6; ++c) {
        acc[k++] += w * (ju[r] * ju[c] + jv[r] * jv[c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[21 + r] += w * (ju[r] * r0 + jv[r] * r1);
  }
}

// Block-wide sum of acc[NACC] into out[NACC] (shared); ends synchronized.
__device__ void block_reduce(float acc[NACC], float (*red)[NACC], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float s = 0.0f;
    for (int w = 0; w < NWARP; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Solve (H + lam I) x = b by Cholesky; H given as the 21-entry upper triangle.
__device__ void solve6(const float* h, const float* b, float lam, float x[6]) {
  float L[6][6];
  int k = 0;
  for (int r = 0; r < 6; ++r)
    for (int c = r; c < 6; ++c) {
      L[c][r] = h[k] + (r == c ? lam : 0.0f);  // lower triangle of A
      ++k;
    }
  for (int j = 0; j < 6; ++j) {
    float d = L[j][j];
    for (int p = 0; p < j; ++p) d -= L[j][p] * L[j][p];
    const float ljj = sqrtf(d);  // NaN for a non-SPD system: the step is rejected
    L[j][j] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      float s = L[i][j];
      for (int p = 0; p < j; ++p) s -= L[i][p] * L[j][p];
      L[i][j] = s / ljj;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int p = 0; p < i; ++p) s -= L[i][p] * y[p];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int p = i + 1; p < 6; ++p) s -= L[p][i] * x[p];
    x[i] = s / L[i][i];
  }
}

// out = exp(xi) * T for xi = [omega, upsilon] (row-major 4x4s).
__device__ void exp_left(const float xi[6], const float* T, float* out) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float t2 = wx * wx + wy * wy + wz * wz;
  float A, B, C;
  if (t2 < SMALL_THETA2) {
    A = 1.0f - t2 / 6.0f + t2 * t2 / 120.0f;
    B = 0.5f - t2 / 24.0f + t2 * t2 / 720.0f;
    C = 1.0f / 6.0f - t2 / 120.0f + t2 * t2 / 5040.0f;
  } else {
    const float th = sqrtf(t2);
    A = sinf(th) / th;
    B = (1.0f - cosf(th)) / t2;
    C = (1.0f - A) / t2;
  }
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    float ti = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float id = (i == j) ? 1.0f : 0.0f;
      E[i][j] = id + A * W[i][j] + B * W2[i][j];
      ti += (id + B * W[i][j] + C * W2[i][j]) * xi[3 + j];
    }
    E[i][3] = ti;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                       E[i][3] * T[12 + j];
}

__global__ void __launch_bounds__(NT)
pose_lm_kernel(const float* __restrict__ xw, const float* __restrict__ uv,
               const float* __restrict__ valid, const float* __restrict__ info,
               const float* __restrict__ k4, const float* __restrict__ t_init,
               float* __restrict__ t_out, float* inlier, int E) {
  const size_t p = blockIdx.x;
  xw += p * E * 3;
  uv += p * E * 2;
  valid += p * E;
  info += p * E;
  inlier += p * E;
  const float fx = k4[4 * p], fy = k4[4 * p + 1];
  const float cx = k4[4 * p + 2], cy = k4[4 * p + 3];

  __shared__ float sT[16];  // the pose the next edge pass evaluates
  __shared__ float red[NWARP][NACC];
  __shared__ float tot[NACC];

  for (int i = threadIdx.x; i < E; i += NT) inlier[i] = 1.0f;
  // thread 0's serial LM state (the other threads carry unused copies)
  float T0[16], T[16], Tn[16], H[21], bv[6], chi = 0.0f, lam = 0.0f, nu = 2.0f;
  for (int j = 0; j < 16; ++j) T0[j] = t_init[16 * p + j];

  for (int rnd = 0; rnd < N_ROUNDS; ++rnd) {
    const bool huber = rnd < 3;
    if (threadIdx.x == 0)
      for (int j = 0; j < 16; ++j) sT[j] = T0[j];
    __syncthreads();
    float acc[NACC];
    for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;
    edge_pass(xw, uv, valid, info, inlier, E, sT, fx, fy, cx, cy, huber, acc);
    block_reduce(acc, red, tot);
    if (threadIdx.x == 0) {
      for (int j = 0; j < 16; ++j) T[j] = T0[j];
      for (int j = 0; j < 21; ++j) H[j] = tot[j];
      for (int j = 0; j < 6; ++j) bv[j] = tot[21 + j];
      chi = tot[27];
      // diagonal of the row-major upper triangle: indices 0, 6, 11, 15, 18, 20
      lam = TAU * fmaxf(fmaxf(fmaxf(H[0], H[6]), fmaxf(H[11], H[15])),
                        fmaxf(H[18], H[20]));
      nu = 2.0f;
    }
    for (int it = 0; it < N_ITERS; ++it) {
      float delta[6];
      if (threadIdx.x == 0) {
        float x[6];
        solve6(H, bv, lam, x);
        for (int j = 0; j < 6; ++j) delta[j] = -x[j];
        exp_left(delta, T, Tn);
        for (int j = 0; j < 16; ++j) sT[j] = Tn[j];
      }
      __syncthreads();
      for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;
      edge_pass(xw, uv, valid, info, inlier, E, sT, fx, fy, cx, cy, huber, acc);
      block_reduce(acc, red, tot);
      if (threadIdx.x == 0) {
        const float chi_new = tot[27];
        float pred = 0.0f;  // delta^T (lambda*delta - b)
        for (int j = 0; j < 6; ++j) pred += delta[j] * (lam * delta[j] - bv[j]);
        const float rho = (chi - chi_new) / fmaxf(pred, 1e-12f);
        const bool accept = isfinite(chi_new) && chi_new < chi;
        if (accept) {
          const float g = 2.0f * rho - 1.0f;
          lam *= fmaxf(1.0f / 3.0f, 1.0f - g * g * g);
          nu = 2.0f;
          chi = chi_new;
          for (int j = 0; j < 16; ++j) T[j] = Tn[j];
          for (int j = 0; j < 21; ++j) H[j] = tot[j];
          for (int j = 0; j < 6; ++j) bv[j] = tot[21 + j];
        } else {
          lam *= nu;
          nu *= 2.0f;
        }
      }
    }
    // end of round: reclassify every edge at the round's pose
    if (threadIdx.x == 0)
      for (int j = 0; j < 16; ++j) sT[j] = T[j];
    __syncthreads();
    for (int i = threadIdx.x; i < E; i += NT) {
      const float X0 = xw[3 * i], X1 = xw[3 * i + 1], X2 = xw[3 * i + 2];
      const float x = sT[0] * X0 + sT[1] * X1 + sT[2] * X2 + sT[3];
      const float y = sT[4] * X0 + sT[5] * X1 + sT[6] * X2 + sT[7];
      const float zr = sT[8] * X0 + sT[9] * X1 + sT[10] * X2 + sT[11];
      const float z = (zr == 0.0f) ? 1.0f : zr;
      const float r0 = fx * x / z + cx - uv[2 * i];
      const float r1 = fy * y / z + cy - uv[2 * i + 1];
      inlier[i] = ((r0 * r0 + r1 * r1) * info[i] <= CHI2_MONO) ? 1.0f : 0.0f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    for (int j = 0; j < 16; ++j) t_out[16 * p + j] = sT[j];
}

}  // namespace

// xw [B,E,3], uv [B,E,2], valid/info [B,E], k4 [B,4] = (fx, fy, cx, cy),
// t_init [B,4,4]; writes t_out [B,4,4] and inlier [B,E] (1.0 / 0.0, not yet
// masked by valid). Returns cudaGetLastError() after the launch.
extern "C" int pose_lm_launch(const float* xw, const float* uv,
                              const float* valid, const float* info,
                              const float* k4, const float* t_init,
                              float* t_out, float* inlier, int B, int E,
                              void* stream) {
  if (B > 0) {
    pose_lm_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        xw, uv, valid, info, k4, t_init, t_out, inlier, E);
  }
  return static_cast<int>(cudaGetLastError());
}
