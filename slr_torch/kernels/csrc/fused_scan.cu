// Fused decode -> unwrap -> triangulate of one structured-light scan, for Hopper.
//
// Replaces the TPU kernel slr/kernels/fused_scan.py::_kernel (with
// _gray_phase_decode and _triangulate_write): its column-plane branch for
// float32 frames, gray_phase coding with inverse Gray patterns and an N-step
// phase shift. The plain PyTorch version of the same contract is
// slr_torch/kernels/fused_scan.py::fused_decode_triangulate_reference.
//
// Bound: device-memory bandwidth. Each pixel reads its F frames once (4 B
// each) and writes 7 floats (points x3, mask, quality, x_p, y_p):
// (4 F + 28) B/px, 141.6 MB for the config-3 scan (F = 20, 1280x1024), which
// is ~42 us at the H100 SXM's 3.35 TB/s. The arithmetic (~300 flop/px with the
// 8-step undistortion) is far under the compute roof.
//
// Design for that bound: one thread per camera pixel on a 2-D grid. A warp
// covers 32 neighbouring pixels of one row, so each frame read and each output
// write is one coalesced 128-byte transaction; frames sit H*W apart, so the
// thread walks them at that stride. Every intermediate lives in registers and
// each output is written once, so device-memory traffic is exactly the bytes
// above. The ragged edge is masked in the kernel (no padding). Parameters
// arrive by value as __grid_constant__, i.e. in the constant bank.

#include <cuda_runtime.h>
#include <stdint.h>

#define SLR_MAX_STEPS 32

// Mirrored field for field by _ScanParams in slr_torch/kernels/fused_scan.py;
// slr_fused_scan_params_size() lets the loader check the two agree.
struct SlrScanParams {
  int32_t height, width;
  int32_t bits;              // column Gray bits, each with its inverse frame
  int32_t steps;             // N-step phase frames
  int32_t undistort_iters;
  float tau_black;           // white - black > tau_black
  float tau_white;           // |pattern - inverse| > tau_white, every bit
  float tau_mod;             // modulation B > tau_mod
  float mod_scale;           // 2 / N
  float xp_scale;            // pitch / (2 pi), rounded to float
  float w_coded;             // pitch * 2^bits: the cyclic code's period
  float w_fold;              // w_coded - 0.5: top-edge fold threshold
  float zmin, zmax;          // strict depth bounds
  float fx, fy, cx, cy;      // camera intrinsics
  float k1, k2, p1, p2, k3;  // camera Brown-Conrady distortion
  float pfx, pcx;            // projector column intrinsics
  float R[9];                // projector world->proj rotation, row-major
  float C[3];                // projector centre in world, -R^T t
  float sin_d[SLR_MAX_STEPS];  // sin(2 pi k / N), rounded to float
  float cos_d[SLR_MAX_STEPS];
};

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

__global__ void __launch_bounds__(256)
fused_scan_kernel(const float* __restrict__ frames, float* __restrict__ pts,
                  float* __restrict__ mask, float* __restrict__ qual,
                  float* __restrict__ xp, float* __restrict__ yp,
                  const __grid_constant__ SlrScanParams p) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= p.width || v >= p.height) return;
  const size_t hw = (size_t)p.height * p.width;
  const size_t pix = (size_t)v * p.width + u;
  const float* f = frames + pix;

  // shadow mask: white - black contrast
  bool valid = (__ldg(f) - __ldg(f + hw)) > p.tau_black;

  // Gray bits, MSB first, against their inverses; certainty on every bit
  const float* pat = f + 2 * hw;
  const float* inv = pat + (size_t)p.bits * hw;
  int gray = 0;
  for (int b = 0; b < p.bits; ++b) {
    const float diff = __ldg(pat + b * hw) - __ldg(inv + b * hw);
    gray = (gray << 1) | (diff > 0.0f ? 1 : 0);
    valid = valid && (fabsf(diff) > p.tau_white);
  }
  int code = gray;  // prefix XOR: Gray -> binary stripe index
  for (int s = 1; s < p.bits; s <<= 1) code ^= code >> s;

  // N-step phase: wrapped phase and modulation
  const float* ph = inv + (size_t)p.bits * hw;
  float S = 0.0f, C = 0.0f;
  for (int k = 0; k < p.steps; ++k) {
    const float fk = __ldg(ph + k * hw);
    S = S + fk * p.sin_d[k];
    C = C + fk * p.cos_d[k];
  }
  float phi = atan2f(S, C);
  if (phi < 0.0f) phi += kTwoPi;
  const float quality = p.mod_scale * sqrtf(S * S + C * C);
  valid = valid && (quality > p.tau_mod);

  // cyclic half-shifted temporal unwrap: k = (code - [phi >= pi]) mod 2^bits
  int order = code - (phi >= kPi ? 1 : 0);
  if (order < 0) order += 1 << p.bits;
  float x_p = (phi + kTwoPi * (float)order) * p.xp_scale;
  if (x_p > p.w_fold) x_p -= p.w_coded;

  // camera ray by fixed-point undistortion; d = (xn, yn, 1) is left
  // unnormalized so that the ray parameter is the camera depth z
  const float xd = ((float)u - p.cx) / p.fx;
  const float yd = ((float)v - p.cy) / p.fy;
  float xn = xd, yn = yd;
  for (int it = 0; it < p.undistort_iters; ++it) {
    const float r2 = xn * xn + yn * yn;
    const float radial = 1.0f + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3));
    const float xy = xn * yn;
    const float xdd = xn * radial + 2.0f * p.p1 * xy + p.p2 * (r2 + 2.0f * xn * xn);
    const float ydd = yn * radial + p.p1 * (r2 + 2.0f * yn * yn) + 2.0f * p.p2 * xy;
    xn = xn + (xd - xdd);
    yn = yn + (yd - ydd);
  }

  // ray x projector column plane: n_p = (1, 0, -xnp), n_w = R^T n_p
  const float xnp = (x_p - p.pcx) / p.pfx;
  const float nwx = p.R[0] - p.R[6] * xnp;
  const float nwy = p.R[1] - p.R[7] * xnp;
  const float nwz = p.R[2] - p.R[8] * xnp;
  float den = nwx * xn + nwy * yn + nwz;
  if (fabsf(den) < 1e-12f) den = 1e-12f;
  const float lam = (nwx * p.C[0] + nwy * p.C[1] + nwz * p.C[2]) / den;
  valid = valid && (lam > p.zmin) && (lam < p.zmax);

  pts[pix] = valid ? xn * lam : 0.0f;
  pts[hw + pix] = valid ? yn * lam : 0.0f;
  pts[2 * hw + pix] = valid ? lam : 0.0f;
  mask[pix] = valid ? 1.0f : 0.0f;
  qual[pix] = quality;
  xp[pix] = x_p;
  yp[pix] = 0.0f;  // projector rows are not coded in this branch
}

}  // namespace

extern "C" {

int slr_fused_scan_params_size(void) { return (int)sizeof(SlrScanParams); }

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream` (PyTorch's current stream) of `device`; returns the
// launch's cudaGetLastError(). Does not synchronise and allocates nothing.
int slr_fused_scan(const float* frames, float* pts, float* mask, float* qual,
                   float* xp, float* yp, const SlrScanParams* params,
                   int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((params->width + block.x - 1) / block.x,
                  (params->height + block.y - 1) / block.y);
  fused_scan_kernel<<<grid, block, 0, stream>>>(frames, pts, mask, qual, xp,
                                                yp, *params);
  return (int)cudaGetLastError();
}

}  // extern "C"
