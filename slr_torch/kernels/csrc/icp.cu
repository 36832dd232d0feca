// Point-to-plane ICP in one launch: every iteration of every edge of a round
// (slr_torch/registration/icp.py::icp_point_to_plane on its exact route,
// slr_torch/registration/projective.py::icp_projective) on the card.
//
// Replaces no TPU kernel: the JAX package runs its ICP in plain JAX under
// jit (slr/registration/icp.py, projective.py), with the distance tiles
// of slr/registration/nn.py left to XLA. The port keeps that plain version
// for CPU tensors; on the card it cost a hundred-odd eager launches an
// iteration, and its exact search wrote each (E, N, 2048) distance tile to
// device memory and read it back six times.
//
// Contract: E edges, each N source points (E, N, 3) moved by a pose (R, t)
// onto a target, from (R0, t0) (identity where null), for `iters` >= 1
// iterations. An iteration: associate each moved source point with a target
// point q and normal n (below), gate: w0 = valid and |moved - q|^2 <
// max_d2; e = (moved - q) . n; the Huber weights w = w0 min(delta / |e|, 1),
// delta = max(1.3 sum(w0 |e|) / max(sum(w0), 1e-9), 1e-6); one Gauss-Newton
// step xi = -(H + 1e-6 I)^-1 g, H = sum w A A^T, g = sum w A e, A = [n,
// moved x n] (6x6 Cholesky); then (R, t) <- (so3_exp(omega) R, so3_exp(omega)
// t + tau), xi = [tau, omega]. Out: R, t, and of the last iteration's
// residuals (before its update) rms = sqrt(sum w e^2 / sum w) (inf where sum
// w <= 1) and inlier_frac = sum w / (n_valid + 1e-9).
//   - NN route (slr_icp_nn): q is the nearest valid target of M by the
//     reference's expanded form |moved|^2 + |t|^2 - 2 moved . t, ties to
//     the lowest index (nn.py); n its normal.
//   - projective route (slr_icp_projective): q and n are read from the
//     edge's organized target grid at the pixel where the rig camera
//     (geom/camera.py::project, Brown-Conrady distortion) sees the moved
//     point, rounded half to even and clamped, as torch.round; valid only
//     inside the image, in front of the camera and on the grid's mask.
//
// Bounds and design: the NN route is bounded by operations. An iteration
// tests N M pairs an edge: config 5's rounds, N = M = 4096, E = 7 and 4,
// 20 iterations, are 2.3 and 1.3 G pairs a launch, each 3 FMAs, a compare
// and two selects. The whole target of an edge, (x, y, z, |t|^2) as a
// float4 with +inf in place of |t|^2 for an invalid target, is 16 B a
// point: 64 KB at M = 4096. So:
//   - one thread-block cluster of SLR_ICP_CLUSTER blocks an edge; each
//     block stages the edge's target in shared memory once, for every
//     iteration; the cluster's blocks own the edge's source points between
//     them, a thread two points at a time, and scan the staged target for
//     both (the target read once from shared memory for two queries). No
//     distance reaches device memory.
//   - a target past one block's shared memory (M > SLR_ICP_CHUNK) is
//     staged a chunk of SLR_ICP_CHUNK points at a time in every iteration,
//     in index order; each point's running nearest (index and value) waits
//     between chunks in a second workspace (E, N float, the wrapper's).
//     The comparisons are those of one pass, in the same order, so the
//     result has the bits a single staging would give.
//   - the per-edge sums (sum w0, sum w0 |e|; then H's 21 entries, g's 6,
//     sum w, sum w e^2) are reduced in a fixed order: a thread over its
//     points, each warp by a butterfly of shuffles, the block's warps in
//     order, then the cluster's blocks in rank order through distributed
//     shared memory, one barrier.cluster a reduction. No float atomics: two
//     runs give the same bits, and an edge in a batch the bits it gets
//     alone. Every block sums the same partials in the same order, so every
//     block holds the same totals and solves the 6x6 system itself.
//   - a thread keeps its points' association (target or pixel index and
//     the gate) between the two reductions in a workspace in device memory
//     (E, N int32, the wrapper's), written and read by that thread alone.
// The projective route has no search: its iterations are bounded by the
// two barriers and the solve's latency, and it shares the rest.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "se3.cuh"

namespace cg = cooperative_groups;

#define SLR_ICP_CLUSTER 8
#define SLR_ICP_THREADS 256
#define SLR_ICP_WARPS (SLR_ICP_THREADS / 32)
#define SLR_ICP_SUMS 32  // a reduction's width in floats: 29 used
// the block's shared memory before the staged target: two reductions'
// partials, the warps' sums, the totals (SLR_ICP_SUMS floats each), then the
// pose (12) and the camera (21), padded to 48 floats
#define SLR_ICP_HEAD_BYTES 1600
// a block's opt-in shared memory on an H100
#define SLR_ICP_SMEM_MAX 232448
// the most target points a block stages at once
#define SLR_ICP_CHUNK ((SLR_ICP_SMEM_MAX - SLR_ICP_HEAD_BYTES) / 16)
#define SLR_ICP_MAX_DEVICES 64

static_assert(SLR_ICP_HEAD_BYTES ==
                  4 * ((2 + SLR_ICP_WARPS + 1) * SLR_ICP_SUMS + 48),
              "the head's layout");

extern __shared__ float4 slr_icp_smem[];

namespace {

using slr::matmul;
using slr::matvec;

struct Args {
  const float* src;                 // (E, N, 3)
  const unsigned char* src_valid;   // (E, N) or null: every point valid
  const float* R0;                  // (E, 3, 3) or null: the identity
  const float* t0;                  // (E, 3) or null: zero
  int E, N, iters;
  float max_d2;
  // the NN route
  const float* tgt;                 // (E, M, 3)
  const float* tgt_n;               // (E, M, 3)
  const unsigned char* tgt_valid;   // (E, M) or null
  int M;
  int chunk;                        // the target points staged at once: M, or SLR_ICP_CHUNK
  float* best;                      // (E, N): the running nearest's value; null unless chunk < M
  // the projective route: G organized grids, edge e on grid grid_of[e]
  const float* grid;                // (G, H, W, 3)
  const unsigned char* grid_mask;   // (G, H, W)
  const float* grid_n;              // (G, H, W, 3)
  const long long* grid_of;         // (E,) or null: edge e on grid e
  const float* cam;                 // R (9), t (3), fx, fy, cx, cy, dist (5)
  int G, H, W;
  int* work;                        // (E, N)
  float* R_out;                     // (E, 3, 3)
  float* t_out;                     // (E, 3)
  float* rms_out;                   // (E,)
  float* inl_out;                   // (E,)
};

// The sum of v[0..K) over the cluster, into tot[0..K) of every block: each
// warp by a butterfly, the warps in order into `part`, then every block
// adds the cluster's `part`s in rank order. One barrier.cluster; `part`
// must not be written again before the cluster's next barrier.
template <int K>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, float (&v)[K],
                                            float* warps, float* part, float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) warps[w * SLR_ICP_SUMS + k] = v[k];
  __syncthreads();
  if (tid < K) {
    float s = 0.0f;
    for (int i = 0; i < SLR_ICP_WARPS; ++i) s += warps[i * SLR_ICP_SUMS + tid];
    part[tid] = s;
  }
  cluster.sync();
  if (tid < K) {
    float s = 0.0f;
    for (int r = 0; r < SLR_ICP_CLUSTER; ++r) s += cluster.map_shared_rank(part, r)[tid];
    tot[tid] = s;
  }
  __syncthreads();
}

// The moved point R p + t of source point p.
__device__ __forceinline__ void move(const float* pose, const float* src, int p, float* m) {
  const float x[3] = {src[3 * p], src[3 * p + 1], src[3 * p + 2]};
  matvec(pose, x, m);
  for (int k = 0; k < 3; ++k) m[k] += pose[9 + k];
}

// Targets [c0, c0 + n) of an edge's M into shared memory as (x, y, z,
// |t|^2), +inf in place of |t|^2 for an invalid target.
__device__ __forceinline__ void stage(float4* target, const float* tg, const unsigned char* tv,
                                      int c0, int n) {
  for (int j = threadIdx.x; j < n; j += SLR_ICP_THREADS) {
    const size_t g = (size_t)c0 + j;
    const float x = tg[3 * g], y = tg[3 * g + 1], z = tg[3 * g + 2];
    target[j] = make_float4(x, y, z, !tv || tv[g] ? x * x + y * y + z * z : INFINITY);
  }
}

// The nearest of n staged targets, target c0 + j at j, to two queries,
// carried on from (i, v): for each, the index and the smallest |t|^2 - 2
// q . t, ties to the lowest index.
__device__ __forceinline__ void nearest2(const float4* __restrict__ tgt, int n, int c0,
                                         const float* q0, const float* q1, int& i0, float& v0,
                                         int& i1, float& v1) {
  const float ax = -2.0f * q0[0], ay = -2.0f * q0[1], az = -2.0f * q0[2];
  const float bx = -2.0f * q1[0], by = -2.0f * q1[1], bz = -2.0f * q1[2];
  float best0 = v0, best1 = v1;
  int j0 = -1, j1 = -1;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float4 t = tgt[j];
    const float d0 = fmaf(ax, t.x, fmaf(ay, t.y, fmaf(az, t.z, t.w)));
    const float d1 = fmaf(bx, t.x, fmaf(by, t.y, fmaf(bz, t.z, t.w)));
    if (d0 < best0) best0 = d0, j0 = j;
    if (d1 < best1) best1 = d1, j1 = j;
  }
  if (j0 >= 0) i0 = c0 + j0, v0 = best0;
  if (j1 >= 0) i1 = c0 + j1, v1 = best1;
}

__device__ __forceinline__ float norm2(const float* x) {
  return x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
}

// e = (m - q) . n
__device__ __forceinline__ float residual(const float* m, const float* q, const float* n) {
  return (m[0] - q[0]) * n[0] + (m[1] - q[1]) * n[1] + (m[2] - q[2]) * n[2];
}

// The gate's first sums of one point, and its association kept in the
// workspace: the index, the gate in the top bit.
__device__ __forceinline__ void first_sums(float (&s)[2], int* work, int p, int idx, bool ok,
                                           const float* m, const float* q, const float* n) {
  const float w0 = ok ? 1.0f : 0.0f;
  s[0] += w0;
  s[1] += w0 * fabsf(residual(m, q, n));
  work[p] = idx | (ok ? (int)0x80000000u : 0);
}

// The pixel of the rig camera where moved point m lands, and whether it
// lies inside the image and in front of the camera (geom/camera.py::project
// and projective.py's rounding and tests).
__device__ __forceinline__ int project(const float* cam, const float* m, int H, int W,
                                       bool& in_img) {
  float pc[3];
  matvec(cam, m, pc);
  for (int k = 0; k < 3; ++k) pc[k] += cam[9 + k];
  const float z = pc[2];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float xn = pc[0] / zs, yn = pc[1] / zs;
  const float k1 = cam[16], k2 = cam[17], p1 = cam[18], p2 = cam[19], k3 = cam[20];
  const float r2 = xn * xn + yn * yn;
  const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
  const float xy = xn * yn;
  const float xd = xn * radial + 2.0f * p1 * xy + p2 * (r2 + 2.0f * xn * xn);
  const float yd = yn * radial + p1 * (r2 + 2.0f * yn * yn) + 2.0f * p2 * xy;
  const float u = cam[12] * xd + cam[14], v = cam[13] * yd + cam[15];
  in_img = u >= 0.0f && u <= (float)(W - 1) && v >= 0.0f && v <= (float)(H - 1) && z > 0.0f;
  const int ui = (int)fminf(fmaxf(rintf(u), 0.0f), (float)(W - 1));
  const int vi = (int)fminf(fmaxf(rintf(v), 0.0f), (float)(H - 1));
  return vi * W + ui;
}

// The Gauss-Newton step of the totals (H's upper triangle row by row, g,
// sum w, sum w e^2) and the pose update, in place; rms and inlier_frac of
// these residuals.
__device__ void solve_and_update(const float* tot, float n_valid, float* pose, float* rms,
                                 float* inl) {
  float Hm[6][6], L[6][6], y[6], x[6];
  for (int i = 0, k = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j, ++k) Hm[i][j] = Hm[j][i] = tot[k];
  for (int i = 0; i < 6; ++i) Hm[i][i] += 1e-6f;
  for (int j = 0; j < 6; ++j) {
    float s = Hm[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    for (int i = j + 1; i < 6; ++i) {
      float r = Hm[i][j];
      for (int k = 0; k < j; ++k) r -= L[i][k] * L[j][k];
      L[i][j] = r / L[j][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float r = tot[21 + i];
    for (int k = 0; k < i; ++k) r -= L[i][k] * y[k];
    y[i] = r / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float r = y[i];
    for (int k = i + 1; k < 6; ++k) r -= L[k][i] * x[k];
    x[i] = r / L[i][i];
  }
  const float omega[3] = {-x[3], -x[4], -x[5]};
  float dR[9], Rn[9], tn[3];
  slr::so3_exp(omega, dR);
  matmul(dR, pose, Rn);
  matvec(dR, pose + 9, tn);
  for (int k = 0; k < 9; ++k) pose[k] = Rn[k];
  for (int k = 0; k < 3; ++k) pose[9 + k] = tn[k] - x[k];
  const float wsum = tot[27];
  *rms = wsum > 1.0f ? sqrtf(tot[28] / fmaxf(wsum, 1e-9f)) : INFINITY;
  *inl = wsum / (n_valid + 1e-9f);
}

template <bool kProjective>
__global__ void __cluster_dims__(SLR_ICP_CLUSTER, 1, 1) __launch_bounds__(SLR_ICP_THREADS)
    icp_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / SLR_ICP_CLUSTER, tid = threadIdx.x;
  const int N = a.N, M = a.M, stride = SLR_ICP_CLUSTER * SLR_ICP_THREADS;
  float* part = (float*)slr_icp_smem;            // [2][SUMS]: the two reductions'
  float* warps = part + 2 * SLR_ICP_SUMS;        // [WARPS][SUMS]
  float* tot = warps + SLR_ICP_WARPS * SLR_ICP_SUMS;  // [SUMS]
  float* pose = tot + SLR_ICP_SUMS;              // R (9), t (3)
  float* cam = pose + 12;                        // 21
  float4* target = slr_icp_smem + SLR_ICP_HEAD_BYTES / 16;  // M
  const float* src = a.src + (size_t)e * N * 3;
  const unsigned char* sv = a.src_valid ? a.src_valid + (size_t)e * N : nullptr;
  int* work = a.work + (size_t)e * N;
  const float* tg = nullptr;
  const unsigned char* tv = nullptr;
  const float* tgt_n = nullptr;
  float* best = a.best ? a.best + (size_t)e * N : nullptr;
  const bool tiled = !kProjective && a.chunk < M;
  const float* grid = nullptr;
  const float* grid_n = nullptr;
  const unsigned char* grid_mask = nullptr;
  bool bad = false;

  if (tid < 12)
    pose[tid] = tid < 9 ? (a.R0 ? a.R0[9 * e + tid] : (tid % 4 == 0 ? 1.0f : 0.0f))
                        : (a.t0 ? a.t0[3 * e + tid - 9] : 0.0f);
  if (kProjective) {
    if (tid < 21) cam[tid] = a.cam[tid];
    const long long g = a.grid_of ? a.grid_of[e] : e;
    bad = g < 0 || g >= a.G;
    const size_t pixels = (size_t)a.H * a.W, off = bad ? 0 : (size_t)g * pixels;
    grid = a.grid + 3 * off, grid_n = a.grid_n + 3 * off, grid_mask = a.grid_mask + off;
  } else {
    tg = a.tgt + (size_t)e * M * 3;
    tv = a.tgt_valid ? a.tgt_valid + (size_t)e * M : nullptr;
    tgt_n = a.tgt_n + (size_t)e * M * 3;
    if (!tiled) stage(target, tg, tv, 0, M);
  }
  // target point i: staged, or (tiled) from device memory
  auto target_point = [&](int i, float* q) {
    if (tiled) {
      for (int k = 0; k < 3; ++k) q[k] = tg[3 * (size_t)i + k];
    } else {
      const float4 t = target[i];
      q[0] = t.x, q[1] = t.y, q[2] = t.z;
    }
  };
  // n_valid (its reduction uses the second partials, as each iteration's
  // last does)
  float nv[1] = {0.0f};
  for (int p = rank * SLR_ICP_THREADS + tid; p < N; p += stride) nv[0] += !sv || sv[p] ? 1.0f : 0.0f;
  cluster_sum(cluster, nv, warps, part + SLR_ICP_SUMS, tot);
  const float n_valid = tot[0];
  float rms = 0.0f, inl = 0.0f;

  for (int it = 0; it < a.iters; ++it) {
    // 1. associate; the gate's sums
    float s1[2] = {0.0f, 0.0f};
    if (kProjective) {
      for (int p = rank * SLR_ICP_THREADS + tid; p < N; p += stride) {
        float m[3], q[3], n[3];
        bool in_img;
        move(pose, src, p, m);
        const int pix = project(cam, m, a.H, a.W, in_img);
        for (int k = 0; k < 3; ++k) q[k] = grid[3 * pix + k], n[k] = grid_n[3 * pix + k];
        const float d[3] = {m[0] - q[0], m[1] - q[1], m[2] - q[2]};
        const bool ok = in_img && grid_mask[pix] && (!sv || sv[p]) && norm2(d) < a.max_d2;
        first_sums(s1, work, p, pix, ok, m, q, n);
      }
    } else {
      auto associate = [&](int pk, const float* m, int i, float v) {
        float q[3];
        target_point(i, q);
        const float n[3] = {tgt_n[3 * i], tgt_n[3 * i + 1], tgt_n[3 * i + 2]};
        const bool ok = (!sv || sv[pk]) && norm2(m) + v < a.max_d2;
        first_sums(s1, work, pk, i, ok, m, q, n);
      };
      for (int c0 = 0; c0 < M; c0 += a.chunk) {
        const int n = min(a.chunk, M - c0);
        const bool last = c0 + n == M;
        if (tiled) {
          __syncthreads();  // nobody scans the last chunk still
          stage(target, tg, tv, c0, n);
          __syncthreads();
        }
        for (int p = rank * SLR_ICP_THREADS + tid; p < N; p += 2 * stride) {
          const int p1 = p + stride < N ? p + stride : p;
          float m0[3], m1[3];
          move(pose, src, p, m0);
          move(pose, src, p1, m1);
          int i0 = 0, i1 = 0;
          float v0 = INFINITY, v1 = INFINITY;
          if (c0 > 0) i0 = work[p], v0 = best[p], i1 = work[p1], v1 = best[p1];
          nearest2(target, n, c0, m0, m1, i0, v0, i1, v1);
          if (!last) {
            work[p] = i0, best[p] = v0, work[p1] = i1, best[p1] = v1;
          } else {
            associate(p, m0, i0, v0);
            if (p1 != p) associate(p1, m1, i1, v1);
          }
        }
      }
    }
    cluster_sum(cluster, s1, warps, part, tot);
    const float delta = fmaxf(1.3f * (tot[1] / fmaxf(tot[0], 1e-9f)), 1e-6f);

    // 2. the Huber weights; H, g, sum w, sum w e^2
    float s2[29];
#pragma unroll
    for (int k = 0; k < 29; ++k) s2[k] = 0.0f;
    for (int p = rank * SLR_ICP_THREADS + tid; p < N; p += stride) {
      const int packed = work[p], idx = packed & 0x7fffffff;
      float m[3], q[3], n[3];
      move(pose, src, p, m);
      if (kProjective) {
        for (int k = 0; k < 3; ++k) q[k] = grid[3 * idx + k], n[k] = grid_n[3 * idx + k];
      } else {
        target_point(idx, q);
        for (int k = 0; k < 3; ++k) n[k] = tgt_n[3 * idx + k];
      }
      const float r = residual(m, q, n);
      const float w = (packed < 0 ? 1.0f : 0.0f) * fminf(delta / fmaxf(fabsf(r), 1e-12f), 1.0f);
      const float A[6] = {n[0], n[1], n[2], m[1] * n[2] - m[2] * n[1],
                          m[2] * n[0] - m[0] * n[2], m[0] * n[1] - m[1] * n[0]};
#pragma unroll
      for (int i = 0, k = 0; i < 6; ++i) {
        const float Aw = A[i] * w;
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) s2[k] += Aw * A[j];
        s2[21 + i] += Aw * r;
      }
      s2[27] += w;
      s2[28] += w * r * r;
    }
    cluster_sum(cluster, s2, warps, part + SLR_ICP_SUMS, tot);

    // 3. the step and the update, by every block alike
    if (tid == 0) solve_and_update(tot, n_valid, pose, &rms, &inl);
    __syncthreads();
  }

  if (rank == 0 && tid < 12) {
    const float out = bad ? nanf("") : pose[tid];
    if (tid < 9)
      a.R_out[9 * e + tid] = out;
    else
      a.t_out[3 * e + tid - 9] = out;
  }
  if (rank == 0 && tid == 0) {
    a.rms_out[e] = bad ? nanf("") : rms;
    a.inl_out[e] = bad ? nanf("") : inl;
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

// The dynamic shared memory granted to each route's kernel so far, per device.
size_t granted[2][SLR_ICP_MAX_DEVICES];

template <bool kProjective>
int launch(const Args& a, size_t smem, int device, cudaStream_t stream) {
  if (a.E < 1 || a.N < 0 || 3LL * a.N > INT_MAX || a.iters < 1 || smem > SLR_ICP_SMEM_MAX ||
      device < 0 || device >= SLR_ICP_MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && smem > granted[kProjective][device]) {
    err = cudaFuncSetAttribute(icp_kernel<kProjective>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[kProjective][device] = smem;
  }
  icp_kernel<kProjective><<<a.E * SLR_ICP_CLUSTER, SLR_ICP_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The NN route, one launch on `stream` of `device`: R_out (E, 3, 3), t_out
// (E, 3), rms_out and inl_out (E,) written on the card; `work` (E, N int32)
// and `best` (E, N float; null where M <= SLR_ICP_CHUNK) its workspaces.
// The valid masks (one byte a point) and the inits may be null. Returns the
// launch's error code (0: launched); neither synchronises nor allocates.
// 0 <= N and 1 <= M, each at most INT_MAX / 3, and `best` where M needs
// it, else cudaErrorInvalidValue.
int slr_icp_nn(const float* src, const unsigned char* src_valid, const float* tgt,
               const float* tgt_n, const unsigned char* tgt_valid, const float* R0,
               const float* t0, int E, int N, int M, int iters, float max_d2, int* work,
               float* best, float* R_out, float* t_out, float* rms_out, float* inl_out,
               int device, cudaStream_t stream) {
  const int chunk = M < SLR_ICP_CHUNK ? M : SLR_ICP_CHUNK;
  if (M < 1 || 3LL * M > INT_MAX || (chunk < M && !best)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.src = src, a.src_valid = src_valid, a.R0 = R0, a.t0 = t0;
  a.E = E, a.N = N, a.iters = iters, a.max_d2 = max_d2;
  a.tgt = tgt, a.tgt_n = tgt_n, a.tgt_valid = tgt_valid, a.M = M, a.chunk = chunk;
  a.best = best;
  a.work = work, a.R_out = R_out, a.t_out = t_out, a.rms_out = rms_out, a.inl_out = inl_out;
  return launch<false>(a, SLR_ICP_HEAD_BYTES + 16 * (size_t)chunk, device, stream);
}

// The projective route, one launch: as slr_icp_nn, with G organized target
// grids (points, mask of one byte a pixel, normals), edge e on grid
// grid_of[e] (null: grid e; outside [0, G): that edge's outputs NaN), and
// the rig camera `cam` (21 floats on the card: R, t, fx, fy, cx, cy, the
// five distortion terms).
int slr_icp_projective(const float* src, const unsigned char* src_valid, const float* grid,
                       const unsigned char* grid_mask, const float* grid_n,
                       const long long* grid_of, const float* cam, const float* R0,
                       const float* t0, int E, int N, int G, int H, int W, int iters,
                       float max_d2, int* work, float* R_out, float* t_out, float* rms_out,
                       float* inl_out, int device, cudaStream_t stream) {
  if (G < 1 || H < 1 || W < 1 || 3LL * H * W > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.src = src, a.src_valid = src_valid, a.R0 = R0, a.t0 = t0;
  a.E = E, a.N = N, a.iters = iters, a.max_d2 = max_d2;
  a.grid = grid, a.grid_mask = grid_mask, a.grid_n = grid_n, a.grid_of = grid_of, a.cam = cam;
  a.G = G, a.H = H, a.W = W;
  a.work = work, a.R_out = R_out, a.t_out = t_out, a.rms_out = rms_out, a.inl_out = inl_out;
  return launch<true>(a, SLR_ICP_HEAD_BYTES, device, stream);
}

}  // extern "C"
