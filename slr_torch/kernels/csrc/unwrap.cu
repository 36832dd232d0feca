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
// where the plain version's divisions do. So every vote is
// rintf(__fdiv_rn(d, 2pi)): an IEEE division (no fast math), rounded half
// to even as torch.round; every Phi + 2pi k is __fadd_rn(Phi,
// __fmul_rn(2pi, k)), two roundings as in the two torch ops, which nvcc
// would otherwise contract into one FMA. A vote stays a float: on a
// neighbour outside the mask it may be huge, and is never converted.
//
// Bounds and design:
// - A sweep reads 5 values per pixel and does ~4 divisions, so a sweep out
//   of device memory would be bound by bandwidth (5 B in, 4 B out per pixel
//   and sweep). The TPU kept the map in VMEM for all sweeps; here K4 keeps
//   a tile in shared memory (temporal blocking): a block loads a
//   TILE_H x 64 tile with a halo of h cells on every side, runs h sweeps in
//   shared memory (ping-pong buffers, one barrier per sweep), and writes
//   the interior. Sweep t updates only the cells at depth >= t from the
//   loaded region's edge, which read cells at depth >= t - 1: every value
//   read is exact, so h sweeps with a halo of h are exact (the reference's
//   halo >= iters argument). Cells outside the image load as mask 0, phi 0:
//   the reference's zero fill. Device traffic per launch: (4 + 1) B per
//   loaded cell (tile plus halo: 1.56x the tile at h = 8, TILE_H = 64) and
//   4 B per pixel out. More sweeps than SLR_MAX_HALO take one launch per
//   chunk, each exact.
// - K3 is the card's form of "whole map resident, one launch": a
//   cooperative launch of as many blocks as fit on the card at once sweeps
//   the whole map in global memory, with a grid-wide barrier between
//   sweeps. At config 3 (1280x1024) the input, the two Phi buffers and the
//   mask are 17 MB, inside the 50 MB L2, so the sweeps after the first run
//   out of L2. Phi is read with __ldcg (L2, not L1): it was written by
//   other SMs in the previous sweep.
// - K5 runs one block per scan line (a row, or a column when axis = 0; the
//   direction reversed when reverse = 1), loads the line's (tag, ps, pv)
//   monoid elements into shared memory in scan order and runs a
//   Hillis-Steele scan there: step s composes element i with element i - s,
//   s = 1, 2, 4, ..., the association of the plain version. ceil(log2 n)
//   steps, each reading the 24 B per element of the other buffer. Device
//   traffic per pass: phi, Phi (4 B) and elig, done (1 B) in; Phi (4 B) and
//   done (1 B) out per pixel. Column passes read with a stride of W.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SLR_MAX_HALO 8
#define SLR_TILE_W 64
#define SLR_BLOCK 256
#define SLR_MAX_SMEM 232448  // bytes of shared memory a block may opt in to

namespace {

// float32(2 pi): torch rounds the Python constant TWO_PI to this
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float cycles(float x) {
  return rintf(__fdiv_rn(x, kTwoPi));
}

// The new Phi of one pixel (phase pc, mask mc) from its neighbours above,
// below, left and right (phase nb, mask nm; outside the image: 0, false):
// the vote that most valid neighbours share, the first best in that order,
// when at least 3 share it and it is not 0.
__device__ __forceinline__ float vote(float pc, bool mc, const float nb[4],
                                      const bool nm[4]) {
  float k[4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
    k[n] = cycles(__fsub_rn(__fmul_rn(nb[n], nm[n] ? 1.f : 0.f), pc));
  float best_count = 0.f, best_k = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float count = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) count += (nm[j] && k[j] == k[i]) ? 1.f : 0.f;
    if (nm[i] && k[i] != 0.f && count > best_count) {
      best_count = count;
      best_k = k[i];
    }
  }
  return (mc && best_count >= 3.f) ? __fadd_rn(pc, __fmul_rn(kTwoPi, best_k)) : pc;
}

// K3. Sweep t reads the previous sweep's buffer and writes out or scratch,
// arranged so that the last sweep writes out.
__global__ void __launch_bounds__(SLR_BLOCK)
vote_resident_kernel(const float* phi, const uint8_t* __restrict__ mask, float* out,
                     float* scratch, int H, int W, int iters) {
  cg::grid_group grid = cg::this_grid();
  const long long n = (long long)H * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float* src = phi;
  for (int t = 0; t < iters; ++t) {
    float* dst = ((iters - 1 - t) & 1) ? scratch : out;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const int r = (int)(i / W), c = (int)(i % W);
      const bool nm[4] = {r > 0 && mask[i - W], r < H - 1 && mask[i + W],
                          c > 0 && mask[i - 1], c < W - 1 && mask[i + 1]};
      const float nb[4] = {r > 0 ? __ldcg(src + i - W) : 0.f,
                           r < H - 1 ? __ldcg(src + i + W) : 0.f,
                           c > 0 ? __ldcg(src + i - 1) : 0.f,
                           c < W - 1 ? __ldcg(src + i + 1) : 0.f};
      dst[i] = vote(__ldcg(src + i), mask[i] != 0, nb, nm);
    }
    grid.sync();
    src = dst;
  }
}

// K4: one tile of tile_h x SLR_TILE_W pixels, h sweeps, halo h.
__global__ void __launch_bounds__(SLR_BLOCK)
vote_tiled_kernel(const float* __restrict__ phi, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, int H, int W, int h, int tile_h) {
  extern __shared__ float smem[];
  const int RW = SLR_TILE_W + 2 * h, RH = tile_h + 2 * h, cells = RW * RH;
  float* src = smem;
  float* dst = smem + cells;
  uint8_t* m = reinterpret_cast<uint8_t*>(smem + 2 * cells);
  const int r0 = blockIdx.y * tile_h - h, c0 = blockIdx.x * SLR_TILE_W - h;
  for (int rr = threadIdx.y; rr < RH; rr += blockDim.y) {
    for (int cc = threadIdx.x; cc < RW; cc += blockDim.x) {
      const int r = r0 + rr, c = c0 + cc;
      const bool in = r >= 0 && r < H && c >= 0 && c < W;
      const long long g = (long long)r * W + c;
      src[rr * RW + cc] = in ? phi[g] : 0.f;
      m[rr * RW + cc] = in ? mask[g] : 0;
    }
  }
  __syncthreads();
  for (int t = 1; t <= h; ++t) {
    for (int rr = t + threadIdx.y; rr < RH - t; rr += blockDim.y) {
      for (int cc = t + threadIdx.x; cc < RW - t; cc += blockDim.x) {
        const int i = rr * RW + cc;
        const bool nm[4] = {m[i - RW] != 0, m[i + RW] != 0, m[i - 1] != 0,
                            m[i + 1] != 0};
        const float nb[4] = {src[i - RW], src[i + RW], src[i - 1], src[i + 1]};
        dst[i] = vote(src[i], m[i] != 0, nb, nm);
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  for (int rr = threadIdx.y; rr < tile_h; rr += blockDim.y) {
    for (int cc = threadIdx.x; cc < SLR_TILE_W; cc += blockDim.x) {
      const int r = r0 + h + rr, c = c0 + h + cc;
      if (r < H && c < W) out[(long long)r * W + c] = src[(rr + h) * RW + cc + h];
    }
  }
}

// K5. Tags: 2 CONST(pv) emits pv; 1 CHAIN(ps, pv) maps an arriving x to
// pv + 2pi round((x - ps) / 2pi); 0 KILL blocks. compose(x, y) is
// "x then y", x upstream; the result replaces y.
__device__ __forceinline__ void compose(int tx, float psx, float pvx, int& ty,
                                        float& psy, float& pvy) {
  if (ty != 1) return;
  if (tx != 0) pvy = __fadd_rn(pvy, __fmul_rn(kTwoPi, cycles(__fsub_rn(pvx, psy))));
  if (tx == 1) psy = psx;
  ty = tx;
}

__global__ void __launch_bounds__(SLR_BLOCK)
wavefront_pass_kernel(const float* __restrict__ phi, const uint8_t* __restrict__ elig,
                      const float* __restrict__ Phi, const uint8_t* __restrict__ done,
                      float* __restrict__ Phi_out, uint8_t* __restrict__ done_out,
                      int H, int W, int axis, int reverse) {
  extern __shared__ float smem[];
  const int n = axis == 1 ? W : H;
  const int line = blockIdx.x;
  // (tag, ps, pv) of the line in scan order, and a second buffer
  int* tag = reinterpret_cast<int*>(smem);
  float* ps = smem + n;
  float* pv = smem + 2 * n;
  int* tag2 = reinterpret_cast<int*>(smem + 3 * n);
  float* ps2 = smem + 4 * n;
  float* pv2 = smem + 5 * n;
  // element i of the line in scan order, as an offset into the maps
  auto at = [&](int i) -> long long {
    const int p = reverse ? n - 1 - i : i;
    return axis == 1 ? (long long)line * W + p : (long long)p * W + line;
  };
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long g = at(i);
    const bool d = done[g] != 0;
    const float ph = phi[g];
    tag[i] = d ? 2 : (elig[g] ? 1 : 0);
    ps[i] = ph;
    pv[i] = d ? Phi[g] : ph;
  }
  __syncthreads();
  for (int s = 1; s < n; s <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int t = tag[i];
      float p = ps[i], v = pv[i];
      if (i >= s) compose(tag[i - s], ps[i - s], pv[i - s], t, p, v);
      tag2[i] = t;
      ps2[i] = p;
      pv2[i] = v;
    }
    __syncthreads();
    int* ti = tag;
    tag = tag2;
    tag2 = ti;
    float* f = ps;
    ps = ps2;
    ps2 = f;
    f = pv;
    pv = pv2;
    pv2 = f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long g = at(i);
    const bool d = done[g] != 0;
    const bool reached = elig[g] && !d && tag[i] == 2;
    Phi_out[g] = reached ? pv[i] : Phi[g];
    done_out[g] = d || reached;
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
cudaError_t shared_memory(const void* kernel, size_t bytes) {
  if (bytes > SLR_MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Every entry point launches on `stream` (PyTorch's current stream) of
// `device` and returns the launch's error code (0: launched). None
// synchronises or allocates.

// K3: iters >= 1 sweeps of the (H, W) map phi (mask: 0/1 bytes) into out;
// scratch is a second (H, W) buffer. Fails, and does not fall back, when
// the card refuses the cooperative launch.
int slr_vote_resident(const float* phi, const uint8_t* mask, float* out, float* scratch,
                      int H, int W, int iters, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_resident_kernel,
                                                      SLR_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long need = ((long long)H * W + SLR_BLOCK - 1) / SLR_BLOCK;
  const int grid = (int)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  void* args[] = {&phi, &mask, &out, &scratch, &H, &W, &iters};
  err = cudaLaunchCooperativeKernel((const void*)vote_resident_kernel, dim3(grid),
                                    dim3(SLR_BLOCK), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4: `sweeps` (1..SLR_MAX_HALO) sweeps of phi into out, tiles of
// tile_h x SLR_TILE_W with a halo of `sweeps`.
int slr_vote_tiled(const float* phi, const uint8_t* mask, float* out, int H, int W,
                   int sweeps, int tile_h, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || sweeps < 1 || sweeps > SLR_MAX_HALO || tile_h < 1)
    return (int)cudaErrorInvalidValue;
  const size_t cells = (size_t)(SLR_TILE_W + 2 * sweeps) * (tile_h + 2 * sweeps);
  const size_t smem = cells * (2 * sizeof(float) + 1);
  err = shared_memory((const void*)vote_tiled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + SLR_TILE_W - 1) / SLR_TILE_W, (H + tile_h - 1) / tile_h);
  vote_tiled_kernel<<<grid, dim3(32, SLR_BLOCK / 32), smem, stream>>>(
      phi, mask, out, H, W, sweeps, tile_h);
  return (int)cudaGetLastError();
}

// K5: one pass along axis (1: rows, 0: columns), reversed when reverse = 1.
// phi, Phi float; elig, done 0/1 bytes; writes Phi_out and done_out.
int slr_wavefront_pass(const float* phi, const uint8_t* elig, const float* Phi,
                       const uint8_t* done, float* Phi_out, uint8_t* done_out, int H,
                       int W, int axis, int reverse, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || W < 1 || (axis != 0 && axis != 1)) return (int)cudaErrorInvalidValue;
  const int n = axis == 1 ? W : H, lines = axis == 1 ? H : W;
  const size_t smem = (size_t)6 * n * sizeof(float);
  err = shared_memory((const void*)wavefront_pass_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  wavefront_pass_kernel<<<lines, SLR_BLOCK, smem, stream>>>(
      phi, elig, Phi, done, Phi_out, done_out, H, W, axis, reverse);
  return (int)cudaGetLastError();
}

}  // extern "C"
