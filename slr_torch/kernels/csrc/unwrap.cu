// Spatial phase repair of a temporally unwrapped phase map, for Hopper.
//
// Replaces the three TPU kernels of the spatial repair:
// - K3, vote_resident_kernel: slr/kernels/unwrap_scan.py::quality_unwrap_pallas
//   (_kernel), every strict-consensus sweep with the whole map resident;
// - K4, vote_tiled_kernel: unwrap_scan.py::quality_unwrap_tiled
//   (_tiled_kernel), the same sweeps per tile with a halo;
// - K5, wavefront_pass_kernel: slr/kernels/wavefront.py::_pass_rows
//   (_scan_kernel), one directional wavefront growth pass.
// The plain PyTorch versions are slr_torch/codec/unwrap.py::
// spatial_quality_unwrap (propagation_step) and ::directional_pass.
//
// Numerics: K3 and K4 equal the plain version bit for bit, and K5 does
// where the plain version's divisions do. Every vote is round(d / 2pi) as
// the plain version's IEEE division and torch.round (half to even) give
// it; the kernels take it as a reciprocal product and one FMA correction
// (K5: cycles_recip, equal to rintf(__fdiv_rn(d, 2pi)) in every bit on all
// 2^32 float32 inputs; K3, K4: vote_round, equal to it but for the sign of
// a zero, which a vote never shows; slr_wavefront_cycles_check, run by the
// tests and chip_smoke.py), without the division's slow path. Every Phi + 2pi k is
// __fadd_rn(Phi, __fmul_rn(2pi, k)), two roundings as in the two torch
// ops, which nvcc would otherwise contract into one FMA. A vote stays a
// float: on a neighbour outside the mask it may be huge, and is never
// converted.
//
// The vote (vote_consensus, shared by K3 and K4). A pixel moves by the vote
// that at least 3 of its valid neighbours share when it is not 0. Of 4
// votes at most one value can be shared by 3, so the reference's "first
// best in the order above, below, left, right" never decides anything the
// count does not: the consensus is "vote 0 and two others agree, or votes
// 1, 2 and 3 agree", 5 compares in place of the reference's 16. And the
// vote across an edge whose two pixels are both in the mask is one
// rounding seen from both ends: IEEE subtraction and division and rounding
// half to even are sign-symmetric, so round((Phi_j - Phi_i) / 2pi) is
// -round((Phi_i - Phi_j) / 2pi), up to the sign of a zero vote, which is
// never counted (a vote is compared with == and != 0 only). A vote from a
// neighbour outside the mask is never counted, and a pixel outside the mask
// never moves: so the vote across an edge with an end outside the mask is
// NaN, which equals nothing, and the consensus needs no mask at all. So K3
// and K4 round each edge once (a vertical and a horizontal edge a pixel and
// sweep, not 4 votes), in one sweep function (sweep_run).
//
// Bounds and design:
// - A sweep reads 5 values per pixel, so sweeps out of device memory would
//   be bound by bandwidth (5 B in, 4 B out per pixel and sweep). The TPU
//   kept the map in VMEM for all sweeps; K4 keeps a tile in registers
//   (temporal blocking): a launch reads phi and the mask once, runs h
//   sweeps and writes the map once, so the least time is its arithmetic
//   (2 roundings and the consensus a pixel and sweep) or its 9 B a pixel.
//   Sweep t updates only the cells at depth >= t from the loaded region's
//   edge, which read cells at depth >= t - 1: every value read is exact, so
//   h sweeps with a halo of h are exact (the reference's halo >= iters
//   argument). Cells outside the image load as mask 0, phi 0: the
//   reference's zero fill. More sweeps than SLR_MAX_HALO take one launch per
//   chunk, each exact.
// - K4's layout: a thread holds a run of K4_RUN rows of one column in
//   registers, lanes along a row, K4_WARPS warps side by side. The pixel
//   above and below is a register, left and right a shuffle; the right
//   edge's vote is rounded by the left pixel and handed to the right one by
//   a shuffle. Lanes 1..30 of a warp are its own columns, lanes 0 and 31
//   copies of the neighbouring warps' edge columns, refreshed through shared
//   memory after each sweep (double-buffered: one barrier a sweep), so a
//   block's tile is 30 K4_WARPS + 2 columns wide with a halo of h on its
//   outer edges only; rows take their halo inside the run. At config 3 (h =
//   4) a tile computes 1.43 cells for each pixel it writes (122 x 32 loaded
//   for 114 x 24 out; 1.61 over the grid with its ragged edge). Nothing
//   waits on shared memory inside a sweep. A thread's mask is a word of
//   bits, and so are its edges with both ends in the mask. The loads are one
//   float and one byte a row a thread, coalesced along the warp's row, all
//   2 K4_RUN of them issued before the first sweep; at most 128 registers a
//   thread keep the grid (516 blocks of 128 threads at config 3) resident in
//   one wave, so a launch waits on its loads once. A persistent grid would
//   give each block about one tile at config 3: there is no second tile to
//   prefetch. Scalar loads take a map at any alignment and width, so no
//   separate unaligned path exists.
// - K3 is the card's form of "whole map resident, one launch": the map
//   lives in the register file of one wave of blocks for all its sweeps.
//   One cooperative launch puts one tile on each block, in K4's layout
//   (K3_WARPS warps of K3_RUN-row runs, a halo of K3_HALO), and every tile
//   is resident at once. The block sweeps its tile in registers as K4 does
//   (the same sweep_run and refresh_warp_edges). Every K3_HALO sweeps it
//   trades edges, not the map: it writes the K3_HALO-deep ring of its owned
//   cells to a small exchange buffer in device memory (it stays in L2),
//   publishes a per-tile sweep counter, waits on the counters of the tiles
//   that can reach it and reads their rings into its halo. With a halo of
//   1 those are the 4 edge neighbours; with 2 or more also the 4 diagonal
//   ones, because a cell at depth h then reads the corner halo (a cell's
//   h sweeps read the cells within h steps along the grid). One grid-wide
//   barrier a launch, behind which the tiles zero their counters, waited on
//   only before the first exchange; after it a tile waits only on the
//   tiles that can reach it. Each block
//   writes its owned cells once, after the last sweep, so a launch moves 9
//   B a pixel (phi and the mask in, Phi out) plus the rings, and any number
//   of sweeps is one launch (the last chunk sweeps iters mod h). The map
//   is read with no index division and no mask test inside a sweep.
// - K5 scans lines (rows, or columns when axis = 0; the direction reversed
//   when reverse = 1) with the Hillis-Steele tree of the plain version: step
//   s composes element i with element i - s, s = 1, 2, 4, ..., so
//   ceil(log2 n) steps of one compose per element. The monoid's float sums
//   are not associative, so the tree, not only the result, is the contract.
//   Device traffic per pass: phi, Phi (4 B) and elig, done (1 B) in; Phi
//   (4 B) and done (1 B) out per pixel, 19.7 MB at 1280x1024: 0.0059 ms.
//   A compose does work only where its y is still CHAIN, and on a repair's
//   map (half the masked pixels trusted) CHAIN runs resolve within a few
//   steps, so the bytes, not the tree, are the bound. The design keeps
//   the tree in registers: a thread holds K = 8 consecutive elements of its
//   line (16 in the build for lines past 8,192), the tags as 2-bit fields of
//   one word, so steps s < K run in the thread, with the previous segment's
//   last s elements by a warp shuffle; steps s >= K take the same element of
//   the segment s / K upstream by a shuffle while it is in the warp, and
//   through shared memory (one barrier to publish, one to release) only
//   across warps. A thread whose elements are all resolved (no CHAIN left)
//   composes nothing more, and a warp of such threads shuffles nothing. The
//   rounding round((x - ps) / 2pi) is a reciprocal product and one FMA
//   correction in place of the IEEE division, equal to it in every bit on
//   all 2^32 float32 inputs (slr_wavefront_cycles_check, run by the tests).
//   A row pass puts one row on a block and moves each thread's elements by
//   16-byte loads and stores where the row is aligned. A column pass puts up
//   to 8 adjacent columns on a block and stages them through a box in shared
//   memory, read and written a map row of those columns at a time (32-byte
//   segments), so the scan runs with lanes along each column as a row's
//   does. Its loads remain one 32-byte sector a row: that, not the tree, is
//   where a column pass loses against a row pass.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// K5's exchanges across warps (dynamic shared memory)
extern __shared__ float k5_smem[];

#define SLR_MAX_HALO 8
#define SLR_MAX_DEVICES 64
// K4: rows a thread holds (the tile's height with its halo), warps a block,
// and the blocks an SM must hold (at most 128 registers a thread), so that
// config 3's grid is resident at once
constexpr int K4_RUN = 32;
constexpr int K4_WARPS = 4;
constexpr int K4_BLOCKS_PER_SM = 4;
// K3: rows a thread holds, warps a block, the blocks an SM must hold (at
// most 128 registers a thread) and the halo, the sweeps between two
// exchanges. Capacity: every tile is resident at once, so a map's tiles
// must fit one wave, 132 x K3_BLOCKS_PER_SM = 1,056 on an H100. With 2
// warps and a halo of 2 a tile owns 58 x 28 cells: every map the route rule
// sends to K3 with both sides <= 16,384 fits (the most, 879 tiles, 121-128
// columns by 8,192 rows), and so does the 1280x1024 map (851). K4's 4-warp
// tile at 4 blocks an SM (528 a wave) would miss those narrow, tall maps
// (586). A halo of 2 measured faster than 1 or 4 on the 1280x800 map
// (PERF.md). kernels/unwrap_scan.py::resident_tiles counts the tiles; the
// wrapper refuses a map past one wave.
constexpr int K3_RUN = 32;
constexpr int K3_WARPS = 2;
constexpr int K3_BLOCKS_PER_SM = 8;
constexpr int K3_HALO = 2;
#define SLR_MAX_SMEM 232448  // bytes of shared memory a block may opt in to
// K5's two builds: 8 elements a thread and at most 1,024 threads a block
// (lines up to 8,192), 16 and 640 (up to 10,240); a column pass takes up to
// K5_MAX_COLUMNS adjacent columns a block
#define K5_SMALL_THREADS 1024
#define K5_LARGE_THREADS 640
#define K5_MAX_COLUMNS 8

namespace {

// float32(2 pi): torch rounds the Python constant TWO_PI to this
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float cycles(float x) {
  return rintf(__fdiv_rn(x, kTwoPi));
}

// round(x / 2pi) as cycles(x) gives it, without the division's slow path:
// q0 = x * RN(1/2pi) and one FMA correction, q0 itself where it is 0, inf
// or NaN (x = +-0, tiny, or not finite: the rounded quotient is then +-0
// of x's sign, or q0). slr_wavefront_cycles_check counts the float32
// inputs on which the two differ: 0 of 2^32.
constexpr float kInvTwoPi = 1.0f / kTwoPi;

__device__ __forceinline__ float cycles_recip(float x) {
  const float q0 = __fmul_rn(x, kInvTwoPi);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, kTwoPi, x), kInvTwoPi, q0);
  return rintf(q0 == 0.f || !isfinite(q0) ? q0 : q1);
}

// The voting kernels' round(x / 2pi): cycles_recip without its guard for
// q0 = 0 (x = +-0 or tiny, where both give a zero, perhaps of the other
// sign, and a zero vote is never counted) and NaN (q1 is NaN too).
// slr_wavefront_cycles_check counts the float32 inputs on which it differs
// from cycles(x) other than in the sign of a zero: 0 of 2^32.
__device__ __forceinline__ float vote_round(float x) {
  const float q0 = __fmul_rn(x, kInvTwoPi);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, kTwoPi, x), kInvTwoPi, q0);
  return rintf(isinf(q0) ? q0 : q1);
}

// The vote across an edge from a to b, round((b - a) / 2pi), when both are
// in the mask; NaN, which equals nothing, when either is not.
__device__ __forceinline__ float edge_vote(float b, float a, bool both) {
  return vote_round(both ? __fsub_rn(b, a) : __int_as_float(0x7fc00000));
}

// The new Phi of a pixel pc from the votes k0..k3 of its neighbours above,
// below, left and right, each NaN where the edge has an end outside the
// mask (outside the image: not in it): moved by the vote that at least 3
// share, when it is not 0. A pixel outside the mask has 4 NaN votes and
// stays. See the header for why this is the reference's first-best
// consensus.
__device__ __forceinline__ float vote_consensus(float pc, float k0, float k1, float k2,
                                                float k3) {
  const bool e01 = k0 == k1, e02 = k0 == k2, e03 = k0 == k3;
  const bool first = (e01 && e02) || (e01 && e03) || (e02 && e03);  // vote 0 and two others
  const float k = first ? k0 : k1;
  const bool take = (first || (k1 == k2 && k1 == k3)) && k != 0.f;
  return take ? __fadd_rn(pc, __fmul_rn(kTwoPi, k)) : pc;
}

// The voting kernels' register tile (K3 and K4). A thread holds a run of
// RUN rows of one column; thread (lane, warp) holds tile column 30 warp +
// lane. Lanes 1..30 own their columns; lanes 0 and 31 hold copies of the
// neighbouring warps' lanes 30 and 1, or, at the tile's outer edge, its
// halo columns.
constexpr unsigned kAllLanes = 0xffffffffu;

// A run from the map: rows r0 .. r0 + RUN - 1 of column c as P[r], the mask
// as bit r of the word returned; outside the image phi 0 and mask 0, the
// reference's zero fill.
template <int RUN>
__device__ __forceinline__ uint32_t load_run(const float* __restrict__ phi,
                                             const uint8_t* __restrict__ mask, int H, int W,
                                             int c, int r0, float (&P)[RUN]) {
  static_assert(RUN <= 32, "a run's mask bits are one word");
  const bool col_in = c >= 0 && c < W;
  uint32_t M = 0u;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int y = r0 + r;
    const bool in = col_in && y >= 0 && y < H;
    const long long g = (long long)y * W + c;
    P[r] = in ? __ldg(phi + g) : 0.f;
    M |= (in && __ldg(mask + g) != 0) ? 1u << r : 0u;
  }
  return M;
}

// A run's edges with both ends in the mask: bit r of ve the edge below row
// r, of he the edge to the right (lane 31's right neighbour is not in the
// warp: its copy's neighbour, or the region's edge; every lane takes part
// in each shuffle).
struct RunEdges {
  uint32_t ve, he;
};

__device__ __forceinline__ RunEdges run_edges(uint32_t M, int lane) {
  const uint32_t MR = __shfl_down_sync(kAllLanes, M, 1);
  return {M & (M >> 1), lane < 31 ? M & MR : 0u};
}

// One sweep of a thread's run: the edge below each row (row r + 1 still
// holds its old value) and the edge to its right, each rounded once; the
// left edge is the left lane's right one (lane 0 takes lane 31's, which is
// NaN), the edge above the row above's edge below, each negated.
template <int RUN>
__device__ __forceinline__ void sweep_run(float (&P)[RUN], RunEdges e, int lane) {
  const int from_left = (lane + 31) & 31;
  float kd_above = __int_as_float(0x7fc00000);  // the row above's edge below: none
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const float pc = P[r];
    const float kd = edge_vote(r + 1 < RUN ? P[r + 1] : 0.f, pc, (e.ve >> r) & 1u);
    const float kr = edge_vote(__shfl_down_sync(kAllLanes, pc, 1), pc, (e.he >> r) & 1u);
    const float kl = -__shfl_sync(kAllLanes, kr, from_left);
    P[r] = vote_consensus(pc, -kd_above, kd, kl, kr);
    kd_above = kd;
  }
}

// Lanes 0 and 31 from the neighbouring warps' lanes 30 and 1, through
// shared memory (edges: [warp][lane 1, lane 30][row]). Callers alternate
// two such buffers, so one barrier a sweep suffices.
template <int WARPS, int RUN>
__device__ __forceinline__ void refresh_warp_edges(float (&P)[RUN],
                                                   float (&edges)[WARPS][2][RUN], int lane,
                                                   int wx) {
  if (lane == 1 || lane == 30) {
    float* e = edges[wx][lane == 30];
#pragma unroll
    for (int r = 0; r < RUN; ++r) e[r] = P[r];
  }
  __syncthreads();
  if ((lane == 0 && wx > 0) || (lane == 31 && wx + 1 < WARPS)) {
    const float* e = edges[lane == 0 ? wx - 1 : wx + 1][lane == 0];
#pragma unroll
    for (int r = 0; r < RUN; ++r) P[r] = e[r];
  }
}

// A tile's interior out: rows and tile columns j at depth >= h from the
// edges of a tile tw columns wide, each column by its owner lane.
template <int RUN>
__device__ __forceinline__ void store_run(float* __restrict__ out, const float (&P)[RUN], int H,
                                          int W, int c, int r0, int j, int tw, int h, int lane) {
  if (lane >= 1 && lane <= 30 && j >= h && j < tw - h && c < W) {
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int y = r0 + r;
      if (r >= h && r < RUN - h && y < H) out[(long long)y * W + c] = P[r];
    }
  }
}

// K4: h sweeps of a tile with a halo of h; see the header.
__global__ void __launch_bounds__(32 * K4_WARPS, K4_BLOCKS_PER_SM)
vote_tiled_kernel(const float* __restrict__ phi, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, int H, int W, int h) {
  static_assert(K4_RUN > 2 * SLR_MAX_HALO, "a run holds its halo above and below");
  __shared__ float edges[2][K4_WARPS][2][K4_RUN];  // [buffer][warp][lane 1, lane 30][row]
  constexpr int tw = 30 * K4_WARPS + 2;
  const int lane = threadIdx.x & 31, wx = threadIdx.x >> 5, j = 30 * wx + lane;
  const int c = blockIdx.x * (tw - 2 * h) - h + j, r0 = blockIdx.y * (K4_RUN - 2 * h) - h;
  float P[K4_RUN];
  const RunEdges e = run_edges(load_run(phi, mask, H, W, c, r0, P), lane);
  for (int t = 0; t < h; ++t) {
    sweep_run(P, e, lane);
    if (t + 1 == h) break;
    refresh_warp_edges(P, edges[t & 1], lane, wx);
  }
  store_run(out, P, H, W, c, r0, j, tw, h, lane);
}

// K3's tile: K3_TW columns with the halo, K3_OW x K3_OH cells owned. Its
// exchange buffer, per tile and chunk parity, holds the K3_HALO-deep ring
// of the tile's owned cells: the top and bottom strips [h][K3_OW] (the
// corners with them), then the left and right strips [h][K3_OH].
constexpr int K3_TW = 30 * K3_WARPS + 2;
constexpr int K3_OW = K3_TW - 2 * K3_HALO, K3_OH = K3_RUN - 2 * K3_HALO;
constexpr int K3_RING = 2 * K3_HALO * (K3_OW + K3_OH);
// K3's exchange buffer, 32-bit words: a sweep counter a tile (the chunks
// it has published), then the rings, 2 a tile. Each launch has its own
// (the wrapper allocates it), and the launch zeroes its counters itself,
// so launches that overlap (CUDA graphs replayed on two streams) share no
// state and the buffer needs no set-up.
constexpr int K3_WORDS_PER_TILE = 1 + 2 * K3_RING;
// polls of one counter (each an L2 round trip) before a launch is taken to
// be hung: a legitimate wait is one chunk of sweeps, microseconds
constexpr int K3_SPIN_LIMIT = 1 << 24;

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K3: iters sweeps of the whole map, one tile a block, all resident; see
// the header. Thread (lane, warp) holds tile column j = 30 warp + lane.
// exchange: K3_WORDS_PER_TILE words a tile, of any content.
__global__ void __launch_bounds__(32 * K3_WARPS, K3_BLOCKS_PER_SM)
vote_resident_kernel(const float* __restrict__ phi, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int H, int W, int iters, unsigned* exchange) {
  constexpr int h = K3_HALO;
  static_assert(K3_RUN > 2 * h && K3_TW > 4 * h, "a tile holds its halo and its ring");
  __shared__ float edges[2][K3_WARPS][2][K3_RUN];  // [buffer][warp][lane 1, lane 30][row]
  const int lane = threadIdx.x & 31, wx = threadIdx.x >> 5, j = 30 * wx + lane;
  const int bx = blockIdx.x, by = blockIdx.y, nx = gridDim.x, ny = gridDim.y;
  const int c = bx * K3_OW - h + j, r0 = by * K3_OH - h;
  unsigned* counters = exchange;
  float* rings = reinterpret_cast<float*>(exchange + nx * ny);
  // Fresh counters on every launch: each tile zeroes its own, then arrives
  // at the grid barrier (a release), and waits on it (an acquire) only
  // before it first polls a neighbour's counter, so no tile reads a counter
  // left from before the launch and the wait hides behind the load and the
  // first chunk of sweeps. A launch of at most h sweeps never waits: the
  // barrier completes all the same, with the last tile's arrival.
  const cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) counters[by * nx + bx] = 0u;
  cg::grid_group::arrival_token zeroed = grid.barrier_arrive();
  float P[K3_RUN];
  const RunEdges e = run_edges(load_run(phi, mask, H, W, c, r0, P), lane);
  // the ring tile (tx, ty) writes after chunk k (double-buffered by the
  // chunk's parity: a tile cannot write parity p again before its
  // neighbours have read it, since it cannot finish its next chunk without
  // their next ring)
  auto ring_of = [&](int tx, int ty, int k) {
    return rings + (size_t)(2 * (ty * nx + tx) + (k & 1)) * K3_RING;
  };
  for (int t = 0; t < iters; ++t) {
    sweep_run(P, e, lane);
    if (t + 1 == iters) break;
    refresh_warp_edges(P, edges[t & 1], lane, wx);
    if ((t + 1) % h != 0) continue;
    const int k = (t + 1) / h;  // the exchange after chunk k
    // publish: the owned ring through L2 (__stcg), a barrier, then one
    // thread's release store of the tile's counter (st.release.gpu: a
    // fence and the store; after the barrier it orders the whole block's
    // ring before the counter, as a grid barrier's arrival does)
    if (lane >= 1 && lane <= 30 && j >= h && j < K3_TW - h) {
      float* own = ring_of(bx, by, k);
#pragma unroll
      for (int r = 0; r < h; ++r) {
        __stcg(own + r * K3_OW + j - h, P[h + r]);
        __stcg(own + (h + r) * K3_OW + j - h, P[K3_RUN - 2 * h + r]);
      }
      if (j < 2 * h || j >= K3_TW - 2 * h) {
        float* side = own + 2 * h * K3_OW +
                      (j < 2 * h ? j - h : h + j - (K3_TW - 2 * h)) * K3_OH - h;
#pragma unroll
        for (int r = h; r < K3_RUN - h; ++r) __stcg(side + r, P[r]);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) store_release(counters + by * nx + bx, k);
    if (k == 1) grid.barrier_wait(cg::grid_group::arrival_token(zeroed));
    // wait on the tiles that can reach this one, a thread each (the edge
    // neighbours; the diagonal ones too with h >= 2), by acquire loads.
    // Spinning is safe only because every tile is resident: the launch is
    // cooperative and refused when the tiles exceed one wave
    if (threadIdx.x < 8) {
      const int d = threadIdx.x < 4 ? threadIdx.x : threadIdx.x + 1;  // 3 x 3, not the centre
      const int dx = d % 3 - 1, dy = d / 3 - 1, tx = bx + dx, ty = by + dy;
      if ((h >= 2 || dx == 0 || dy == 0) && tx >= 0 && tx < nx && ty >= 0 && ty < ny) {
        const unsigned* p = counters + ty * nx + tx;
        for (int spins = 0; load_acquire(p) < (unsigned)k; ++spins)
          if (spins == K3_SPIN_LIMIT) __trap();
      }
    }
    __syncthreads();
    // the halo rows of each column from the tile above and below it (a
    // corner column from a diagonal tile, read only with h >= 2), by
    // __ldcg: L1 is not coherent across SMs
    const int tx = j < h ? bx - 1 : (j >= K3_TW - h ? bx + 1 : bx);
    const int jj = j < h ? K3_OW - h + j : (j >= K3_TW - h ? j - (K3_TW - h) : j - h);
    if (tx >= 0 && tx < nx && (h >= 2 || tx == bx)) {
      if (by > 0) {
        const float* s = ring_of(tx, by - 1, k) + h * K3_OW + jj;  // its bottom strip
#pragma unroll
        for (int r = 0; r < h; ++r) P[r] = __ldcg(s + r * K3_OW);
      }
      if (by + 1 < ny) {
        const float* s = ring_of(tx, by + 1, k) + jj;  // its top strip
#pragma unroll
        for (int r = 0; r < h; ++r) P[K3_RUN - h + r] = __ldcg(s + r * K3_OW);
      }
    }
    // the halo columns' owned rows from the tile beside it
    if ((j < h && bx > 0) || (j >= K3_TW - h && bx + 1 < nx)) {
      const float* s = j < h ? ring_of(bx - 1, by, k) + 2 * h * K3_OW + (h + j) * K3_OH
                             : ring_of(bx + 1, by, k) + 2 * h * K3_OW + (j - (K3_TW - h)) * K3_OH;
#pragma unroll
      for (int r = h; r < K3_RUN - h; ++r) P[r] = __ldcg(s + r - h);
    }
  }
  store_run(out, P, H, W, c, r0, j, K3_TW, h, lane);
}

cudaError_t shared_memory(const void* kernel, size_t bytes);

// K5. Tags: 2 CONST(pv) emits pv; 1 CHAIN(ps, pv) maps an arriving x to
// pv + 2pi round((x - ps) / 2pi); 0 KILL blocks. compose(x, y) is
// "x then y", x upstream; the result replaces y. A thread keeps the tags of
// its K elements as 2-bit fields of one word; element j's is at bit 2j.
__device__ __forceinline__ uint32_t tag_at(uint32_t tags, int j) {
  return (tags >> (2 * j)) & 3u;
}

// Whether any element of a tag word is still CHAIN (field 01). Only a
// CHAIN element changes in a compose, and it never becomes CHAIN again, so
// a thread without one has nothing left to compose, only to send.
__device__ __forceinline__ bool chains_left(uint32_t tags) {
  return ((tags & ~(tags >> 1)) & 0x55555555u) != 0u;
}

__device__ __forceinline__ void compose(uint32_t tx, float psx, float pvx, uint32_t& tags,
                                        int j, float& psy, float& pvy) {
  if (tag_at(tags, j) != 1u) return;
  if (tx != 0u) pvy = __fadd_rn(pvy, __fmul_rn(kTwoPi, cycles_recip(__fsub_rn(pvx, psy))));
  if (tx == 1u) psy = psx;
  tags = (tags & ~(3u << (2 * j))) | (tx << (2 * j));
}

// One scan line's share held by a thread: elements seg*K + j, j < K, in
// scan order, as registers.
template <int K>
struct Segment {
  uint32_t tags;
  float ps[K], pv[K];
};

// Where a block's threads sit: `lines` lines a block, T threads a line (a
// multiple of 32, so a warp holds one line's segments); thread tid holds
// segment seg = tid % T of line tid / T, and the segment d places upstream
// is d threads lower. Exchanges across warps go through k5_smem:
// [K][threads] ps, [K][threads] pv, [threads] tag words.
struct Layout {
  int tid, seg, segw, threads;
  bool multiwarp;  // the line spans warps
};

template <int K>
__device__ __forceinline__ float& shared_ps(const Layout& L, int j, int t) {
  return k5_smem[j * L.threads + t];
}
template <int K>
__device__ __forceinline__ float& shared_pv(const Layout& L, int j, int t) {
  return k5_smem[(K + j) * L.threads + t];
}
template <int K>
__device__ __forceinline__ uint32_t& shared_tags(const Layout& L, int t) {
  return reinterpret_cast<uint32_t*>(k5_smem)[2 * K * L.threads + t];
}

// Step s < K: element j composes with element j - s, in the thread for
// j >= s (descending j, so each reads its upstream element's old value),
// else the previous segment's element K - s + j.
template <int K, int S>
__device__ __forceinline__ void step_within(Segment<K>& a, const Layout& L) {
  const bool need = chains_left(a.tags);
  float xps[S], xpv[S];
  uint32_t xtag = 0u;
  if (__any_sync(0xffffffffu, need)) {
    xtag = __shfl_up_sync(0xffffffffu, a.tags, 1);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      xps[j] = __shfl_up_sync(0xffffffffu, a.ps[K - S + j], 1);
      xpv[j] = __shfl_up_sync(0xffffffffu, a.pv[K - S + j], 1);
    }
  }
  if (L.multiwarp) {
    if (L.segw == 31) {  // the warp's last segment, for the next warp's first
#pragma unroll
      for (int j = 0; j < S; ++j) {
        shared_ps<K>(L, K - S + j, L.tid) = a.ps[K - S + j];
        shared_pv<K>(L, K - S + j, L.tid) = a.pv[K - S + j];
      }
      shared_tags<K>(L, L.tid) = a.tags;
    }
    __syncthreads();
    if (need && L.segw == 0 && L.seg > 0) {
      const int src = L.tid - 1;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        xps[j] = shared_ps<K>(L, K - S + j, src);
        xpv[j] = shared_pv<K>(L, K - S + j, src);
      }
      xtag = shared_tags<K>(L, src);
    }
    __syncthreads();
  }
  if (!need) return;
#pragma unroll
  for (int j = K - 1; j >= S; --j)
    compose(tag_at(a.tags, j - S), a.ps[j - S], a.pv[j - S], a.tags, j, a.ps[j], a.pv[j]);
  if (L.seg > 0) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      compose(tag_at(xtag, K - S + j), xps[j], xpv[j], a.tags, j, a.ps[j], a.pv[j]);
  }
}

template <int K, int S>
__device__ __forceinline__ void steps_within(Segment<K>& a, const Layout& L, int n) {
  if constexpr (S < K) {
    if (S < n) {
      step_within<K, S>(a, L);
      steps_within<K, 2 * S>(a, L, n);
    }
  }
}

// Step s = d * K: every element composes with the same element of the
// segment d upstream, by a shuffle inside the warp, else through shared
// memory.
template <int K>
__device__ __forceinline__ void step_across(Segment<K>& a, const Layout& L, int d) {
  const bool in_warp = d < 32;
  const int src = L.tid - d;
  const bool act = L.seg >= d && chains_left(a.tags);
  const bool reader = act && L.multiwarp && (!in_warp || L.segw < d);
  const bool warp_acts = __any_sync(0xffffffffu, act);
  uint32_t xtag = a.tags;
  if (in_warp && warp_acts) xtag = __shfl_up_sync(0xffffffffu, a.tags, d);
  if (L.multiwarp) {
    if (!in_warp || L.segw >= 32 - d) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        shared_ps<K>(L, j, L.tid) = a.ps[j];
        shared_pv<K>(L, j, L.tid) = a.pv[j];
      }
      shared_tags<K>(L, L.tid) = a.tags;
    }
    __syncthreads();
    if (reader) xtag = shared_tags<K>(L, src);
  }
  if (warp_acts) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float xps = 0.f, xpv = 0.f;
      if (in_warp) {
        xps = __shfl_up_sync(0xffffffffu, a.ps[j], d);
        xpv = __shfl_up_sync(0xffffffffu, a.pv[j], d);
      }
      if (reader) {
        xps = shared_ps<K>(L, j, src);
        xpv = shared_pv<K>(L, j, src);
      }
      if (act) compose(tag_at(xtag, j), xps, xpv, a.tags, j, a.ps[j], a.pv[j]);
    }
  }
  if (L.multiwarp) __syncthreads();
}

// K consecutive floats, or K flags as bits, from an aligned address.
template <int K>
__device__ __forceinline__ void load_vec(const float* q, float (&t)[K]) {
#pragma unroll
  for (int v = 0; v < K / 4; ++v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(q) + v);
    t[4 * v] = x.x;
    t[4 * v + 1] = x.y;
    t[4 * v + 2] = x.z;
    t[4 * v + 3] = x.w;
  }
}

template <int K>
__device__ __forceinline__ uint32_t load_flags(const uint8_t* q) {
  uint32_t w[K / 4];
  if constexpr (K == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(q));
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(q));
    w[0] = x.x, w[1] = x.y;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int o = 0; o < K; ++o) bits |= ((w[o / 4] >> (8 * (o % 4))) & 0xffu) ? (1u << o) : 0u;
  return bits;
}

// K5 builds: K elements a thread, at most `threads` threads a block.
template <int K>
struct K5Build;
template <>
struct K5Build<8> {
  static constexpr int threads = K5_SMALL_THREADS;
};
template <>
struct K5Build<16> {
  static constexpr int threads = K5_LARGE_THREADS;
};

// A column pass's staged box: `lines` columns of the map, each column's
// element i (scan order) at (i % K) * (T + 1) + i / K of its slab of
// K * (T + 1): the thread of segment s reads its element j at j * (T + 1)
// + s, so a warp's reads fall in 32 banks, and so do the writes of a warp
// that covers 32 / lines rows of `lines` adjacent columns.
template <int K>
struct Box {
  int T, slab;
  __device__ __forceinline__ int at(int line, int i) const {
    return line * slab + (i % K) * (T + 1) + i / K;
  }
};

// Floats of shared memory before a column box's Phi: the larger of the
// exchanges and the box's phi and flags.
template <int K>
__host__ __device__ __forceinline__ int box_offset(int threads, int cells) {
  const int exchange = threads * (2 * K + 1), staged = cells + (cells + 3) / 4;
  return exchange > staged ? exchange : staged;
}

// One directional pass; see slr_wavefront_pass. The direction is a
// template parameter, so every register index is a constant. Flags elig
// and done ride in `flags`: bit j elig, bit 16 + j done.
template <int K, bool REV>
__global__ void __launch_bounds__(K5Build<K>::threads)
wavefront_pass_kernel(const float* __restrict__ phi, const uint8_t* __restrict__ elig,
                      const float* __restrict__ Phi, const uint8_t* __restrict__ done,
                      float* __restrict__ Phi_out, uint8_t* __restrict__ done_out, int H,
                      int W, int axis, int lines_a_block, int vec) {
  static_assert(K == 8 || K == 16, "K5 holds 8 or 16 elements a thread");
  const int n = axis == 1 ? W : H, lines = axis == 1 ? H : W;
  const int T = blockDim.x / lines_a_block;
  Layout L;
  L.tid = threadIdx.x;
  L.seg = L.tid % T;
  L.segw = L.tid % 32;
  L.threads = blockDim.x;
  L.multiwarp = T > 32;
  const int lb = L.tid / T;                      // line in the block
  const int line0 = blockIdx.x * lines_a_block;  // first line of the block
  const int line = line0 + lb;
  const bool live = line < lines;
  const int i0 = L.seg * K;  // scan index of element 0
  auto position = [&](int i) { return REV ? n - 1 - i : i; };  // along the line

  Segment<K> a;
  a.tags = 0u;
  uint32_t flags = 0u;
  auto take = [&](int j, float ph, float Ph, bool d, bool e) {
    a.ps[j] = ph;
    a.pv[j] = d ? Ph : ph;
    a.tags |= (d ? 2u : (e ? 1u : 0u)) << (2 * j);
    flags |= (e ? 1u << j : 0u) | (d ? 1u << (16 + j) : 0u);
  };
#pragma unroll
  for (int j = 0; j < K; ++j) a.ps[j] = a.pv[j] = 0.f;

  // rows: each thread loads its own K elements (vector loads where the
  // row is aligned); columns: the block stages its columns through a box
  // in shared memory, read a row of `lines_a_block` columns at a time
  // the box: phi, then the flags (elig | done << 1), in the memory the
  // exchanges use next; the map's Phi after it, kept for the output
  const Box<K> box{T, K * (T + 1)};
  const int cells = lines_a_block * box.slab;
  float* bphi = k5_smem;
  uint8_t* bflags = reinterpret_cast<uint8_t*>(k5_smem + cells);
  float* bPhi = k5_smem + box_offset<K>(L.threads, cells);
  const bool wide = axis == 1 && vec && live && i0 + K <= n;
  const long long base = (long long)line * W + (REV ? n - i0 - K : i0);
  // the box's rows: thread tid takes column tid % lines_a_block of map rows
  // tid / lines_a_block, + T, + 2T, ..., so a warp reads adjacent columns
  const int bl = L.tid % lines_a_block, br = L.tid / lines_a_block;
  const bool bcol = line0 + bl < lines;
  if (axis == 0) {
    if (bcol) {  // at most K rows a thread (T K >= n): all loads in flight at once
      float v[K], V[K];
      uint8_t e[K], d[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int r = br + m * T;
        if (r < n) {
          const long long g = (long long)r * W + line0 + bl;
          v[m] = __ldg(phi + g);
          V[m] = __ldg(Phi + g);
          e[m] = __ldg(elig + g);
          d[m] = __ldg(done + g);
        }
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int r = br + m * T;
        if (r < n) {
          const int k = box.at(bl, REV ? n - 1 - r : r);
          bphi[k] = v[m];
          bPhi[k] = V[m];
          bflags[k] = (e[m] ? 1 : 0) | (d[m] ? 2 : 0);
        }
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (i0 + j < n) {
          const int k = box.at(lb, i0 + j);
          const uint8_t f = bflags[k];
          take(j, bphi[k], bPhi[k], f & 2, f & 1);
        }
      }
    }
    __syncthreads();  // the box's memory is the exchanges' next
  } else if (wide) {
    float tphi[K], tPhi[K];
    load_vec<K>(phi + base, tphi);
    load_vec<K>(Phi + base, tPhi);
    const uint32_t eb = load_flags<K>(elig + base), db = load_flags<K>(done + base);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int o = REV ? K - 1 - j : j;
      take(j, tphi[o], tPhi[o], (db >> o) & 1u, (eb >> o) & 1u);
    }
  } else if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (i0 + j < n) {
        const long long g = (long long)line * W + position(i0 + j);
        const bool d = done[g] != 0;
        take(j, phi[g], d ? Phi[g] : 0.f, d, elig[g] != 0);
      }
    }
  }

  // the Hillis-Steele tree: s = 1, 2, 4, ... < n
  steps_within<K, 1>(a, L, n);
  for (int d = 1; d * K < n; d <<= 1) step_across<K>(a, L, d);

  // reached: eligible, not done, and a CONST arrived. A done element kept
  // its CONST, so its pv is its Phi; an element neither keeps the map's Phi.
  auto reached = [&](int j) {
    const bool d = (flags >> (16 + j)) & 1u;
    return d || (((flags >> j) & 1u) && tag_at(a.tags, j) == 2u);
  };
  if (axis == 0) {
    __syncthreads();  // every line's exchanges done: the box's memory is free
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (i0 + j < n) {
          const int k = box.at(lb, i0 + j);
          bphi[k] = a.pv[j];
          bflags[k] = reached(j) ? 1 : 0;
        }
      }
    }
    __syncthreads();
    if (bcol) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int r = br + m * T;
        if (r < n) {
          const long long g = (long long)r * W + line0 + bl;
          const int k = box.at(bl, REV ? n - 1 - r : r);
          const bool hit = bflags[k] != 0;
          Phi_out[g] = hit ? bphi[k] : bPhi[k];
          done_out[g] = hit;
        }
      }
    }
  } else if (wide) {
    float tPhi[K], o4[K];
    load_vec<K>(Phi + base, tPhi);
    uint32_t ob[K / 4];
#pragma unroll
    for (int v = 0; v < K / 4; ++v) ob[v] = 0u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int o = REV ? K - 1 - j : j;
      const bool hit = reached(j);
      o4[o] = hit ? a.pv[j] : tPhi[o];
      ob[o / 4] |= (hit ? 1u : 0u) << (8 * (o % 4));
    }
#pragma unroll
    for (int v = 0; v < K / 4; ++v)
      reinterpret_cast<float4*>(Phi_out + base)[v] =
          make_float4(o4[4 * v], o4[4 * v + 1], o4[4 * v + 2], o4[4 * v + 3]);
    if constexpr (K == 16)
      *reinterpret_cast<uint4*>(done_out + base) = make_uint4(ob[0], ob[1], ob[2], ob[3]);
    else
      *reinterpret_cast<uint2*>(done_out + base) = make_uint2(ob[0], ob[1]);
  } else if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (i0 + j < n) {
        const long long g = (long long)line * W + position(i0 + j);
        const bool hit = reached(j);
        Phi_out[g] = hit ? a.pv[j] : Phi[g];
        done_out[g] = hit;
      }
    }
  }
}

// Threads a line for lines of n elements, K a thread.
template <int K>
int wavefront_threads(int n) {
  return ((n + K - 1) / K + 31) / 32 * 32;
}

template <int K>
cudaError_t launch_wavefront(const float* phi, const uint8_t* elig, const float* Phi,
                             const uint8_t* done, float* Phi_out, uint8_t* done_out, int H,
                             int W, int axis, int reverse, int lines_a_block, int vec,
                             cudaStream_t stream) {
  const int n = axis == 1 ? W : H, lines = axis == 1 ? H : W;
  const int T = wavefront_threads<K>(n), threads = T * lines_a_block;
  const int cells = lines_a_block * K * (T + 1);
  const size_t smem = sizeof(float) * (axis == 0 ? (size_t)box_offset<K>(threads, cells) + cells
                                                 : (size_t)threads * (2 * K + 1));
  const void* kernel = reverse ? (const void*)wavefront_pass_kernel<K, true>
                               : (const void*)wavefront_pass_kernel<K, false>;
  cudaError_t err = shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (lines + lines_a_block - 1) / lines_a_block;
  if (reverse)
    wavefront_pass_kernel<K, true><<<blocks, threads, smem, stream>>>(
        phi, elig, Phi, done, Phi_out, done_out, H, W, axis, lines_a_block, vec);
  else
    wavefront_pass_kernel<K, false><<<blocks, threads, smem, stream>>>(
        phi, elig, Phi, done, Phi_out, done_out, H, W, axis, lines_a_block, vec);
  return cudaGetLastError();
}

// Over every float32 bit pattern x: mismatches[0] counts those on which
// cycles_recip(x) and cycles(x) differ in any bit (K5's rounding),
// mismatches[1] those on which vote_round(x) and cycles(x) differ other than
// in the sign of a zero (the voting kernels').
__global__ void cycles_check_kernel(unsigned long long* mismatches) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long n = 0, m = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    const float a = cycles(x), b = cycles_recip(x), c = vote_round(x);
    n += !(isnan(a) && isnan(b)) && __float_as_uint(a) != __float_as_uint(b);
    m += !(isnan(a) && isnan(c)) && !(a == 0.f && c == 0.f) &&
         __float_as_uint(a) != __float_as_uint(c);
  }
  if (n) atomicAdd(mismatches, n);
  if (m) atomicAdd(mismatches + 1, m);
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
cudaError_t shared_memory(const void* kernel, size_t bytes) {
  if (bytes > SLR_MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Make `device` current, calling cudaSetDevice only when it is not.
cudaError_t use_device(int device) {
  if (device < 0 || device >= SLR_MAX_DEVICES) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// The K3 tiles one wave holds on `device` (current), asked once a device;
// 0 if the card cannot hold one block of K3.
int resident_capacity(int device) {
  static int capacity[SLR_MAX_DEVICES];
  if (!capacity[device]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_resident_kernel,
                                                      32 * K3_WARPS, 0) == cudaSuccess)
      capacity[device] = sms * per_sm;
  }
  return capacity[device];
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Every entry point launches on `stream` (PyTorch's current stream) of
// `device` and returns the launch's error code (0: launched). None
// synchronises or allocates.

// K3's layout on `device`, into layout[0..3]: the tiles one wave holds
// (blocks an SM by the occupancy API, times the SMs; asked once a device),
// the 32-bit words of exchange buffer a tile takes, and the cells a tile
// owns across and down.
int slr_vote_resident_layout(int device, int* layout) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  layout[0] = resident_capacity(device);
  layout[1] = K3_WORDS_PER_TILE;
  layout[2] = K3_OW;
  layout[3] = K3_OH;
  return layout[0] > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// K3: iters >= 1 sweeps of the (H, W) map phi (mask: 0/1 bytes) into out,
// in one cooperative launch of one block a tile. exchange: layout[1] words
// a tile, this launch's own, of any content. Fails, and does not fall
// back, when the tiles exceed one wave (a spinning tile would wait forever
// on one that is not resident) or the card refuses the cooperative launch.
// Launched by cudaLaunchKernelEx with the cooperative attribute (which
// also gives the kernel its grid barrier), never <<<>>>, so a CUDA graph
// can capture it.
int slr_vote_resident(const float* phi, const uint8_t* mask, float* out, unsigned* exchange,
                      int H, int W, int iters, int device, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  const long long tx = (W + K3_OW - 1) / K3_OW, ty = (H + K3_OH - 1) / K3_OH;
  if (tx * ty > resident_capacity(device)) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute cooperative[1];
  cooperative[0].id = cudaLaunchAttributeCooperative;
  cooperative[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)tx, (unsigned)ty);
  config.blockDim = dim3(32 * K3_WARPS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = cooperative;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, vote_resident_kernel, phi, mask, out, H, W, iters,
                           exchange);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4: `sweeps` (1..SLR_MAX_HALO) sweeps of phi into out, tiles of
// (30 K4_WARPS + 2) x K4_RUN cells with a halo of `sweeps`.
int slr_vote_tiled(const float* phi, const uint8_t* mask, float* out, int H, int W,
                   int sweeps, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || sweeps < 1 || sweeps > SLR_MAX_HALO) return (int)cudaErrorInvalidValue;
  const int ow = 30 * K4_WARPS + 2 - 2 * sweeps, oh = K4_RUN - 2 * sweeps;
  const dim3 grid((W + ow - 1) / ow, (H + oh - 1) / oh);
  vote_tiled_kernel<<<grid, 32 * K4_WARPS, 0, stream>>>(phi, mask, out, H, W, sweeps);
  return (int)cudaGetLastError();
}

// K5: one pass along axis (1: rows, 0: columns), reversed when reverse = 1.
// phi, Phi float; elig, done 0/1 bytes; writes Phi_out and done_out. Lines
// of up to 8,192 elements take the 8-element build, up to 10,240 the
// 16-element one.
int slr_wavefront_pass(const float* phi, const uint8_t* elig, const float* Phi,
                       const uint8_t* done, float* Phi_out, uint8_t* done_out, int H,
                       int W, int axis, int reverse, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || (axis != 0 && axis != 1)) return (int)cudaErrorInvalidValue;
  const int n = axis == 1 ? W : H;
  const uintptr_t any = (uintptr_t)phi | (uintptr_t)elig | (uintptr_t)Phi | (uintptr_t)done |
                        (uintptr_t)Phi_out | (uintptr_t)done_out;
  const int vec = axis == 1 && n % 16 == 0 && (any & 15) == 0;
  // rows: one a block; columns: the most adjacent columns a block holds,
  // up to K5_MAX_COLUMNS
  const int widest = axis == 0 ? K5_MAX_COLUMNS : 1;
  if (wavefront_threads<8>(n) <= K5Build<8>::threads) {
    int c = widest;
    while (c > 1 && c * wavefront_threads<8>(n) > K5Build<8>::threads) --c;
    return (int)launch_wavefront<8>(phi, elig, Phi, done, Phi_out, done_out, H, W, axis,
                                    reverse, c, vec, stream);
  }
  if (wavefront_threads<16>(n) <= K5Build<16>::threads) {
    int c = widest;
    while (c > 1 && c * wavefront_threads<16>(n) > K5Build<16>::threads) --c;
    return (int)launch_wavefront<16>(phi, elig, Phi, done, Phi_out, done_out, H, W, axis,
                                     reverse, c, vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The counts of float32 inputs on which K5's reciprocal rounding differs
// from the IEEE division's, and on which the voting kernels' differs other
// than in the sign of a zero, into mismatches[0] and [1] (unsigned 64-bit
// ints, zeroed by the caller).
int slr_wavefront_cycles_check(unsigned long long* mismatches, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cycles_check_kernel<<<sms * 8, 256, 0, stream>>>(mismatches);
  return (int)cudaGetLastError();
}

}  // extern "C"
