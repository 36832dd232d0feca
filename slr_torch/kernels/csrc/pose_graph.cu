// The pose graph's Gauss-Newton solve in one launch: every iteration of
// slr_torch/registration/posegraph.py::pose_graph_optimize on the card.
//
// Replaces no TPU kernel: the JAX package solves its pose graph in plain
// JAX (slr/registration/posegraph.py), as the port did before this kernel,
// and the port keeps that plain version for CPU tensors. The plain version
// takes the Jacobian of the residuals with torch.func.jacfwd, some 500
// eager launches an iteration.
//
// Contract: S poses (R (S, 3, 3), t (S, 3) float32, world <- scan), E edges
// (i, j) (int64 each) with measured relative poses Z = (Z_R (E, 3, 3), Z_t
// (E, 3)) of scan j in scan i. The residual of an edge is
// log(Z^-1 T_i^-1 T_j) * [1, 1, 1, s, s, s] (s = rot_scale), each pose
// updated on the right, T <- T Exp(xi). An iteration: the residuals and
// their Jacobian at xi = 0, H = J^T J + diag (the damping, plus 1e12 on
// pose 0's block: the gauge), g = J^T r, dx = -H^-1 g (the plain version
// by Cholesky, the kernel by LDL^T: the same solution of a positive
// definite H, rounded otherwise), then the update. After `iters`
// iterations: R, t, the final cost (the sum of squared residuals) and the
// RMS over the 6E residuals. An index outside
// [0, S) makes every output NaN.
//
// Bounds and design: config 5's graph (S = 8, E <= 11: 48 unknowns, 66
// residuals) is a few hundred thousand flops an iteration, microseconds
// of the card's time; what bounds the solve is latency: 20 iterations,
// each a chain of dependent steps (a 48-column factorisation, two
// triangular solves). So one block of SLR_PG_THREADS threads on one SM does it all,
// the poses, H and the Jacobian resident in shared memory for the whole
// solve, and the host launches once. Once, before the iterations, each of
// H's S (S + 1) / 2 pose blocks gets the list of the edges that touch it
// (1 to 3 on config 5's graph). Then each iteration:
//   1. the Jacobian, by the whole block: a thread an (edge, tangent) pair,
//      12 an edge (the tangents of poses i and j), evaluating the edge's
//      residual in dual numbers (a value and a derivative) through the
//      plain version's own formulas (geom/se3.py), so its branches follow
//      jacfwd's; at xi = 0 a pose's tangent is exact: dR = R hat(dphi),
//      dt = R drho;
//   2. H's lower triangle and g, by the whole block: a thread an entry,
//      summing over its block's edges in their order (no float atomics:
//      the same bits on every call and on every rank);
//   3. LDL^T, right-looking: for each column the whole block updates the
//      trailing triangle (one barrier a column), with g carried as one
//      more row, which makes the forward solve part of the factorisation;
//      then D L^T x = L^-1 g by one warp (its __syncwarp costs a fraction
//      of a block barrier), a row a step;
//   4. the update, a thread a pose, with se3_exp's branches.
// Memory: (6S + 1)^2 floats for H and g (rows padded by one float, so a
// warp walking down a column hits 32 banks) and 95 words an edge, laid out
// as kernels/pose_graph.py::words counts them. Where that fits the card's
// 227 KB of shared memory (config 5's graph takes 14 KB; any graph of up to
// 38 poses as a chain) it lives there; past it the same body runs on a
// workspace in global memory, which the wrapper allocates (the kernel's
// template argument picks the pointer). The workspace route's time grows
// as (6S)^3 on one SM: it is there so that every graph on the card takes
// this kernel, not for speed.

#include <cuda_runtime.h>
#include <math.h>

#include "se3.cuh"

#define SLR_PG_THREADS 256
// a block's opt-in shared memory on an H100 (232,448 bytes), less `bad`
#define SLR_PG_SMEM_MAX 232432
#define SLR_PG_MAX_DEVICES 64

extern __shared__ float slr_pg_smem[];

namespace {

// ---- dual numbers: a value and its derivative along one tangent ----------

struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual dual(float v) { return {v, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float r = sqrtf(a.v);
  return {r, a.d / (2.0f * r)};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), cosf(a.v) * a.d}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -sinf(a.v) * a.d}; }
// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}

using slr::hat;
using slr::matmul;
using slr::matvec;

// ---- one edge's residual and its derivative -------------------------------

// The residual of edge (i, j) at the poses R, t (shared memory), scaled,
// into val[6]; with 0 <= slot < 12 also its derivative along tangent slot
// % 6 of pose i (slot < 6) or j, into der[6] (zero for slot >= 6 when
// i == j: slots 0-5 then carry the whole derivative). slot -1: the value
// alone. The formulas are geom/se3.py's: se3_inverse, se3_compose,
// so3_log (atan2, with its Taylor branch below |w|^2 = 1e-12) and
// _so3_left_jacobian_inv (its Taylor branch below theta^2 = 1e-8).
__device__ void edge_residual(const float* R, const float* t, int i, int j, const float* Z,
                              float rot_scale, int slot, float* val, float* der) {
  Dual Ri[9], ti[3], Rj[9], tj[3];
  for (int k = 0; k < 9; ++k) Ri[k] = dual(R[9 * i + k]), Rj[k] = dual(R[9 * j + k]);
  for (int k = 0; k < 3; ++k) ti[k] = dual(t[3 * i + k]), tj[k] = dual(t[3 * j + k]);
  if (slot >= 0 && !(slot >= 6 && i == j)) {
    const int p = slot < 6 ? i : j, c = slot % 6;
    const float* Rp = R + 9 * p;
    float dR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, dt[3] = {0, 0, 0};
    if (c < 3) {  // drho = e_c: dt = R e_c
      for (int r = 0; r < 3; ++r) dt[r] = Rp[3 * r + c];
    } else {      // dphi = e_(c-3): dR = R hat(e)
      float e[3] = {0, 0, 0}, K[9];
      e[c - 3] = 1.0f;
      hat(e, K, 0.0f);
      matmul(Rp, K, dR);
    }
    if (p == i) {
      for (int k = 0; k < 9; ++k) Ri[k].d = dR[k];
      for (int k = 0; k < 3; ++k) ti[k].d = dt[k];
    }
    if (p == j) {
      for (int k = 0; k < 9; ++k) Rj[k].d = dR[k];
      for (int k = 0; k < 3; ++k) tj[k].d = dt[k];
    }
  }
  // T_i^-1 = (R_i^T, -R_i^T t_i); T_i^-1 T_j
  Dual Rii[9], tii[3], Rij[9], tij[3], u[3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Rii[3 * r + c] = Ri[3 * c + r];
  matvec(Rii, ti, u);
  for (int k = 0; k < 3; ++k) tii[k] = -u[k];
  matmul(Rii, Rj, Rij);
  matvec(Rii, tj, u);
  for (int k = 0; k < 3; ++k) tij[k] = u[k] + tii[k];
  // Z^-1 T_i^-1 T_j, Z^-1 = (Z_R^T, -Z_R^T Z_t)
  Dual ZRt[9], Ztt[3], Zt[3], Er[9], Et[3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) ZRt[3 * r + c] = dual(Z[3 * c + r]);
  for (int k = 0; k < 3; ++k) Zt[k] = dual(Z[9 + k]);
  matvec(ZRt, Zt, u);
  for (int k = 0; k < 3; ++k) Ztt[k] = -u[k];
  matmul(ZRt, Rij, Er);
  matvec(ZRt, tij, u);
  for (int k = 0; k < 3; ++k) Et[k] = u[k] + Ztt[k];
  // so3_log: w = vee(R - R^T), |w| = 2 sin(theta)
  const Dual trace = Er[0] + Er[4] + Er[8];
  Dual w[3] = {Er[7] - Er[5], Er[2] - Er[6], Er[3] - Er[1]};
  const Dual w2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  Dual scale;
  if (w2.v < 1e-12f) {
    scale = dual(0.5f) + (dual(3.0f) - trace) / dual(12.0f);
  } else {
    const Dual nw = dsqrt(w2);
    scale = datan2(nw, trace - dual(1.0f)) / nw;
  }
  Dual phi[3];
  for (int k = 0; k < 3; ++k) phi[k] = scale * w[k];
  // _so3_left_jacobian_inv(phi) = I - K / 2 + cot K^2
  const Dual theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  Dual cot;
  if (theta2.v < 1e-8f) {
    cot = dual(1.0f / 12.0f) + theta2 / dual(720.0f);
  } else {
    const Dual theta = dsqrt(theta2 + dual(1e-16f));
    const Dual half = theta * dual(0.5f);
    cot = (dual(1.0f) - half * dcos(half) / dsin(half)) / theta2;
  }
  Dual K[9], K2[9], Jinv[9], rho[3];
  hat(phi, K, dual(0.0f));
  matmul(K, K, K2);
  for (int k = 0; k < 9; ++k) {
    const Dual eye = dual(k % 4 == 0 ? 1.0f : 0.0f);
    Jinv[k] = eye - dual(0.5f) * K[k] + cot * K2[k];
  }
  matvec(Jinv, Et, rho);
  for (int k = 0; k < 3; ++k) {
    val[k] = rho[k].v, val[3 + k] = phi[k].v * rot_scale;
    if (der) der[k] = rho[k].d, der[3 + k] = phi[k].d * rot_scale;
  }
}

// The column of pose p's tangent c in edge (i, j)'s Jacobian block Je
// (12 columns of 6), or null where the edge does not touch pose p.
__device__ __forceinline__ const float* column(const float* Je, int i, int j, int p, int c) {
  if (p == i) return Je + 6 * c;
  if (p == j) return Je + 6 * (6 + c);
  return nullptr;
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = 0.0f;
  for (int m = 0; m < 6; ++m) s = fmaf(a[m], b[m], s);
  return s;
}

// se3_exp(xi) = (so3_exp(phi), J_l(phi) rho), with their Taylor branches
// below theta^2 = 1e-8 (se3.cuh's coefficients); T <- T Exp(xi) in place.
__device__ void apply_update(float* R, float* t, const float* rho, const float* phi) {
  const slr::So3Coeffs s = slr::so3_coeffs(phi);
  const float c = s.small ? 1.0f / 6.0f - s.theta2 / 120.0f
                          : (s.theta - sinf(s.theta)) / (s.theta2 * s.theta);
  float K[9], K2[9], dR[9], Jl[9], dt[3], Rn[9], u[3];
  slr::so3_exp(phi, dR);
  hat(phi, K, 0.0f);
  matmul(K, K, K2);
  for (int k = 0; k < 9; ++k) Jl[k] = (k % 4 == 0 ? 1.0f : 0.0f) + s.b * K[k] + c * K2[k];
  matvec(Jl, rho, dt);
  matmul(R, dR, Rn);
  matvec(R, dt, u);
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
  for (int k = 0; k < 3; ++k) t[k] = u[k] + t[k];
}

// Row and column (p, q), p >= q, of entry p (p + 1) / 2 + q of a lower
// triangle stored row by row (H's pose blocks; a trailing triangle).
__device__ __forceinline__ void block_pair(int k, int* p, int* q) {
  int a = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while (a * (a + 1) / 2 > k) --a;
  while ((a + 1) * (a + 2) / 2 <= k) ++a;
  *p = a, *q = k - a * (a + 1) / 2;
}

// Whether edge (i, j) touches both poses of block (p, q).
__device__ __forceinline__ bool touches(int i, int j, int p, int q) {
  return p == q ? (i == p || j == p) : ((i == p && j == q) || (i == q && j == p));
}

// kShared: the working memory in dynamic shared memory; else in `ws`
// (global memory, kernels/pose_graph.py::words floats).
template <bool kShared>
__global__ void __launch_bounds__(SLR_PG_THREADS)
    pose_graph_kernel(const float* __restrict__ R_init, const float* __restrict__ t_init,
                      const long long* __restrict__ ei, const long long* __restrict__ ej,
                      const float* __restrict__ ZR, const float* __restrict__ Zt, int S, int E,
                      int iters, float damping, float rot_scale, float* __restrict__ R_out,
                      float* __restrict__ t_out, float* __restrict__ cost_out,
                      float* __restrict__ rms_out, float* __restrict__ ws) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = 6 * S, ld = n + 1, nb = S * (S + 1) / 2;
  float* H = kShared ? slr_pg_smem : ws;  // (n + 1) x ld: H, then L D in its lower triangle;
  float* g = H + n * ld;        // row n: the right-hand side, then L^-1 g, then the step
  float* Li = H + ld * ld;      // n: 1 / D
  float* R = Li + n;            // S x 9
  float* t = R + 9 * S;         // S x 3
  float* Z = t + 3 * S;         // E x 12: Z_R row-major, then Z_t
  float* J = Z + 12 * E;        // E x 12 x 6: an edge's Jacobian block, by column
  float* r = J + 72 * E;        // E x 6
  int* edge = (int*)(r + 6 * E);  // E x 2
  int* first = edge + 2 * E;    // nb + 1: where each block's edges start in `touching`
  int* touching = first + nb + 1;  // <= 3E: the edges touching each block, in order
  __shared__ int bad;

  if (tid == 0) bad = 0;
  __syncthreads();
  for (int k = tid; k < 9 * S; k += nt) R[k] = R_init[k];
  for (int k = tid; k < 3 * S; k += nt) t[k] = t_init[k];
  for (int k = tid; k < 12 * E; k += nt) {
    const int e = k / 12, m = k % 12;
    Z[k] = m < 9 ? ZR[9 * e + m] : Zt[3 * e + m - 9];
  }
  for (int e = tid; e < E; e += nt) {
    const long long i = ei[e], j = ej[e];
    if (i < 0 || i >= S || j < 0 || j >= S) bad = 1;
    edge[2 * e] = (int)i, edge[2 * e + 1] = (int)j;
  }
  __syncthreads();
  if (bad) {
    const float nan = nanf("");
    for (int k = tid; k < 9 * S; k += nt) R_out[k] = nan;
    for (int k = tid; k < 3 * S; k += nt) t_out[k] = nan;
    if (tid == 0) *cost_out = nan, *rms_out = nan;
    return;
  }
  // the edges of each block of H, once: counts, their running sum, the lists
  for (int k = tid; k < nb; k += nt) {
    int p, q, c = 0;
    block_pair(k, &p, &q);
    for (int e = 0; e < E; ++e) c += touches(edge[2 * e], edge[2 * e + 1], p, q);
    first[k + 1] = c;
  }
  __syncthreads();
  if (tid == 0) {
    first[0] = 0;
    for (int k = 0; k < nb; ++k) first[k + 1] += first[k];
  }
  __syncthreads();
  for (int k = tid; k < nb; k += nt) {
    int p, q, c = first[k];
    block_pair(k, &p, &q);
    for (int e = 0; e < E; ++e)
      if (touches(edge[2 * e], edge[2 * e + 1], p, q)) touching[c++] = e;
  }
  const float gauge = damping + 1e12f;

  for (int it = 0; it < iters; ++it) {
    __syncthreads();
    // 1. residuals and the Jacobian's blocks
    for (int q = tid; q < 12 * E; q += nt) {
      const int e = q / 12, slot = q % 12;
      float val[6];
      edge_residual(R, t, edge[2 * e], edge[2 * e + 1], Z + 12 * e, rot_scale, slot, val,
                    J + 72 * e + 6 * slot);
      if (slot == 0)
        for (int m = 0; m < 6; ++m) r[6 * e + m] = val[m];
    }
    __syncthreads();
    // 2. H = J^T J + diag (lower triangle), block by block, and g = J^T r,
    // each a sum over the edges touching its block in their order
    for (int q = tid; q < 36 * nb + n; q += nt) {
      int p, pb, ca, cb, k;
      if (q < 36 * nb) {
        k = q / 36, ca = q % 36 / 6, cb = q % 6;
        block_pair(k, &p, &pb);
        if (p == pb && cb > ca) continue;
      } else {
        p = pb = (q - 36 * nb) / 6, ca = (q - 36 * nb) % 6, cb = -1;
        k = p * (p + 1) / 2 + p;
      }
      float s = 0.0f;
      for (int x = first[k]; x < first[k + 1]; ++x) {
        const int e = touching[x], i = edge[2 * e], j = edge[2 * e + 1];
        const float* u = column(J + 72 * e, i, j, p, ca);
        s += dot6(u, cb < 0 ? r + 6 * e : column(J + 72 * e, i, j, pb, cb));
      }
      const int a = 6 * p + ca;
      if (cb < 0)
        g[a] = s;
      else
        H[a * ld + 6 * pb + cb] = a == 6 * pb + cb ? s + (a < 6 ? gauge : damping) : s;
    }
    __syncthreads();
    // 3. H = L D L^T (L unit lower triangular), right-looking: for each
    // column c, every entry of the triangle below and right of its
    // diagonal, row n (g) included, takes its share; one barrier a column.
    // Column c then holds L's column times d_c, and row n v = L^-1 g.
    for (int c = 0; c < n; ++c) {
      const float rd = 1.0f / H[c * ld + c];
      const int m = n - c;  // rows c + 1 .. n; their entries but (n, n)
      for (int q = tid; q < m * (m + 1) / 2 - 1; q += nt) {
        int a, b;
        block_pair(q, &a, &b);
        a += c + 1, b += c + 1;
        H[a * ld + b] = fmaf(-H[a * ld + c] * rd, H[b * ld + c], H[a * ld + b]);
      }
      if (tid == 0) Li[c] = rd;
      __syncthreads();
    }
    // then D L^T x = v by the first warp, a row a step, in place in row n
    if (tid < warpSize) {
      for (int c = n - 1; c >= 0; --c) {
        const float x = g[c] * Li[c];
        __syncwarp();
        if (tid == 0) g[c] = x;
        for (int a = tid; a < c; a += warpSize) g[a] = fmaf(-H[c * ld + a], x, g[a]);
        __syncwarp();
      }
    }
    __syncthreads();
    // 4. T_s <- T_s Exp(-x_s)
    for (int s = tid; s < S; s += nt) {
      const float rho[3] = {-g[6 * s], -g[6 * s + 1], -g[6 * s + 2]};
      const float phi[3] = {-g[6 * s + 3], -g[6 * s + 4], -g[6 * s + 5]};
      apply_update(R + 9 * s, t + 3 * s, rho, phi);
    }
  }
  __syncthreads();

  // the final residuals, cost and RMS
  for (int e = tid; e < E; e += nt)
    edge_residual(R, t, edge[2 * e], edge[2 * e + 1], Z + 12 * e, rot_scale, -1, r + 6 * e,
                  nullptr);
  __syncthreads();
  if (tid == 0) {
    float cost = 0.0f;
    for (int k = 0; k < 6 * E; ++k) cost += r[k] * r[k];
    *cost_out = cost;
    *rms_out = sqrtf(cost / (float)(6 * E));
  }
  for (int k = tid; k < 9 * S; k += nt) R_out[k] = R[k];
  for (int k = tid; k < 3 * S; k += nt) t_out[k] = t[k];
}

// The dynamic shared memory granted to the kernel so far, per device.
size_t granted[SLR_PG_MAX_DEVICES];

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The whole solve, one launch on `stream` of `device`: R_out (S, 3, 3),
// t_out (S, 3), cost_out and rms_out (one float each) written on the card.
// The working memory: `smem` bytes of dynamic shared memory where `ws` is
// null, else the workspace `ws` (then `smem` is 0); both sized by
// kernels/pose_graph.py::words. Returns the launch's error code (0:
// launched); neither synchronises nor allocates. S >= 1, E >= 1, and
// `smem` within SLR_PG_SMEM_MAX, else cudaErrorInvalidValue.
int slr_pose_graph(const float* R_init, const float* t_init, const long long* ei,
                   const long long* ej, const float* ZR, const float* Zt, int S, int E,
                   int iters, float damping, float rot_scale, float* R_out, float* t_out,
                   float* cost_out, float* rms_out, long long smem, float* ws, int device,
                   cudaStream_t stream) {
  if (S < 1 || E < 1 || smem < 0 || smem > SLR_PG_SMEM_MAX || (ws != nullptr && smem != 0) ||
      device < 0 || device >= SLR_PG_MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ws != nullptr) {
    pose_graph_kernel<false><<<1, SLR_PG_THREADS, 0, stream>>>(
        R_init, t_init, ei, ej, ZR, Zt, S, E, iters, damping, rot_scale, R_out, t_out,
        cost_out, rms_out, ws);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024 && (size_t)smem > granted[device]) {
    err = cudaFuncSetAttribute(pose_graph_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[device] = (size_t)smem;
  }
  pose_graph_kernel<true><<<1, SLR_PG_THREADS, (size_t)smem, stream>>>(
      R_init, t_init, ei, ej, ZR, Zt, S, E, iters, damping, rot_scale, R_out, t_out, cost_out,
      rms_out, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
