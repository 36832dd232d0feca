// Fused decode -> unwrap -> triangulate of one structured-light scan, for Hopper.
//
// Replaces both TPU kernels of slr/kernels/fused_scan.py:
// - K1, fused_scan_kernel: fused_decode_triangulate (_kernel with
//   _gray_decode_block, _gray_phase_decode and _triangulate_write), every
//   branch: float32 / uint8 / uint16 frames; Gray + N-step phase, Gray only
//   (steps = 0) or multi-frequency phase; projector rows, Gray or Gray +
//   phase; column-plane or midpoint triangulation, or decode only.
// - K2, fused_scan_hdr_kernel: fused_decode_triangulate_hdr (_hdr_kernel),
//   an E-exposure bracket fused by selection or by modulation-weighted
//   phase sums, then K1's decode and geometry.
// The plain PyTorch versions of the same contracts are
// slr_torch/kernels/fused_scan.py::fused_decode_triangulate_reference and
// ::fused_decode_triangulate_hdr_reference, in the same order of operations.
//
// Bound: device-memory bandwidth. K1 reads each pixel's F frames once
// (4, 1 or 2 B each) and writes 7 floats (points x3, mask, quality, x_p,
// y_p): (F b + 28) B/px. Config 3 at 1280x1024, F = 20: 141.6 MB as float32,
// 62.9 MB as uint8. K2 reads white, black and the phase frames of every
// exposure and the Gray frames of the chosen one only. The arithmetic
// (a few hundred flop/px with the 8-step undistortion) is far under the
// compute roof.
//
// Design for that bound: K1 stages a 128 x 2 pixel box of every frame in
// shared memory by 16-byte asynchronous copies, all in flight at once, then
// decodes and triangulates one pixel a thread from there; a box those
// copies cannot take whole decodes from device memory (see
// fused_scan_kernel). K2 reads its frames straight from device memory, one
// thread per camera pixel on a 2-D grid, a warp on 32 neighbouring pixels
// of one row, frames H*W apart. Integer frames are widened to int: the
// Gray bits and the contrast, certainty and saturation gates compare raw
// counts against integer thresholds (as the TPU kernel does); only phase
// frames are converted to float. Every intermediate lives in registers and
// each output is written once. The frame type, the geometry and multifreq
// are template parameters (15 K1 and 6 K2 instantiations), so each kernel
// keeps only its own registers; the bit and step counts are runtime
// fields. The ragged edge is masked in the kernel (no padding). Parameters
// arrive by value as __grid_constant__, i.e. in the constant bank.

#include <cuda_runtime.h>
#include <stdint.h>

#define SLR_MAX_STEPS 32
#define SLR_MAX_LEVELS 8

// Mirrored field for field by _ScanParams in slr_torch/kernels/fused_scan.py;
// slr_fused_scan_params_size() lets the loader check the two agree. Float
// constants are rounded to float on the host once, for the kernel and the
// plain version alike.
struct SlrScanParams {
  int32_t height, width;
  int32_t dtype;             // frames: 0 float32, 1 uint8, 2 uint16
  int32_t geometry;          // 0 column plane, 1 midpoint, 2 decode only
  int32_t multifreq;         // 1: hierarchical multi-frequency phase, no Gray
  int32_t bits, row_bits;    // column / row Gray bits, each with its inverse
  int32_t steps, row_steps;  // column / row N-step phase frames (0: none)
  int32_t mf_levels;         // multifreq pitch levels
  int32_t undistort_iters;
  int32_t exposures;         // K2: bracket size E
  int32_t fuse;              // K2: 0 modulation-weighted sums, 1 select
  int32_t tau_black_i, tau_white_i, tau_sat_i;  // integer frames, raw counts
  float tau_black, tau_white, tau_sat;          // float frames
  float tau_mod;             // modulation gate, raw units (any frames)
  float mod_scale;           // 2 / N
  float row_mod_scale;       // 2 / N_row
  float mod_out_scale;       // 1 / ADC max (1 for float): quality in [0,1] units
  float pitch, xp_scale;     // column pitch, pitch / (2 pi)
  float w_coded, w_fold;     // pitch * 2^bits and its top-edge fold threshold
  float row_pitch, yp_scale, h_coded, h_fold;  // the same for rows
  float mf_xp_scale;         // finest pitch / (2 pi)
  float mf_period, mf_fold;  // coarsest pitch and its fold threshold
  float row_offset;          // global camera row of frame row 0
  float zmin, zmax;          // strict depth bounds
  float fx, fy, cx, cy;      // camera intrinsics
  float k1, k2, p1, p2, k3;  // camera Brown-Conrady distortion
  float pfx, pfy, pcx, pcy;  // projector intrinsics
  float q1, q2, s1, s2, q3;  // projector distortion (midpoint only)
  float R[9];                // projector world->proj rotation, row-major
  float C[3];                // projector centre in world, -R^T t
  float mf_ratio[SLR_MAX_LEVELS];  // p_{l-1} / p_l (entry 0 unused)
  float sin_d[SLR_MAX_STEPS];      // sin(2 pi k / N)
  float cos_d[SLR_MAX_STEPS];
  float row_sin_d[SLR_MAX_STEPS];  // sin(2 pi k / N_row)
  float row_cos_d[SLR_MAX_STEPS];
};

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;
enum Geometry { kPlane = 0, kMidpoint = 1, kDecodeOnly = 2 };
enum Fuse { kSum = 0, kSelect = 1 };

// Frame access by container type. Integer containers widen to int and use
// the integer thresholds; float frames use the float ones.
// SH: the frames sit in shared memory (a staged box), else in global
// memory, read through the non-coherent cache.
template <typename T, bool SH = false>
struct Frame {
  using Raw = int;
  static __device__ __forceinline__ int load(const T* q) { return SH ? (int)*q : (int)__ldg(q); }
  static __device__ __forceinline__ int tau_black(const SlrScanParams& p) { return p.tau_black_i; }
  static __device__ __forceinline__ int tau_white(const SlrScanParams& p) { return p.tau_white_i; }
  static __device__ __forceinline__ int tau_sat(const SlrScanParams& p) { return p.tau_sat_i; }
};

template <bool SH>
struct Frame<float, SH> {
  using Raw = float;
  static __device__ __forceinline__ float load(const float* q) { return SH ? *q : __ldg(q); }
  static __device__ __forceinline__ float tau_black(const SlrScanParams& p) { return p.tau_black; }
  static __device__ __forceinline__ float tau_white(const SlrScanParams& p) { return p.tau_white; }
  static __device__ __forceinline__ float tau_sat(const SlrScanParams& p) { return p.tau_sat; }
};

__device__ __forceinline__ int abs_raw(int x) { return abs(x); }
__device__ __forceinline__ float abs_raw(float x) { return fabsf(x); }

struct Decoded {
  float x_p, y_p, quality;
  bool valid;
};

// MSB-first Gray bits at frames [first, first+bits) against their inverses at
// [first+bits, first+2 bits), certainty on every bit; prefix XOR -> binary.
template <typename T, bool SH = false>
__device__ __forceinline__ int gray_block(const T* f, size_t hw, int first, int bits,
                                          typename Frame<T>::Raw tau_white, bool& certain) {
  const T* pat = f + (size_t)first * hw;
  const T* inv = pat + (size_t)bits * hw;
  int g = 0;
  for (int b = 0; b < bits; ++b) {
    const auto diff = Frame<T, SH>::load(pat + b * hw) - Frame<T, SH>::load(inv + b * hw);
    g = (g << 1) | (diff > 0 ? 1 : 0);
    certain = certain && (abs_raw(diff) > tau_white);
  }
  for (int s = 1; s < bits; s <<= 1) g ^= g >> s;
  return g;
}

// N-step phase sums of frames [first, first+steps), raw units.
template <typename T, bool SH = false>
__device__ __forceinline__ void phase_sums(const T* f, size_t hw, int first, int steps,
                                           const float* sin_d, const float* cos_d,
                                           float& S, float& C) {
  const T* ph = f + (size_t)first * hw;
  S = 0.0f;
  C = 0.0f;
  for (int k = 0; k < steps; ++k) {
    const float fk = (float)Frame<T, SH>::load(ph + k * hw);
    S = S + fk * sin_d[k];
    C = C + fk * cos_d[k];
  }
}

__device__ __forceinline__ float wrapped_phase(float S, float C) {
  float phi = atan2f(S, C);
  if (phi < 0.0f) phi += kTwoPi;
  return phi;
}

// cyclic half-shifted temporal unwrap: order = (code - [phi >= pi]) mod 2^bits
__device__ __forceinline__ float unwrap_cyclic(float phi, int code, int bits, float scale,
                                               float period, float fold) {
  int order = code - (phi >= kPi ? 1 : 0);
  if (order < 0) order += 1 << bits;
  float x = (phi + kTwoPi * (float)order) * scale;
  if (x > fold) x -= period;
  return x;
}

// Gray(+inverse) decode, N-step phase (or Gray-only stripe centres) and the
// projector rows when coded. The phase sums S, C (rows: Sr, Cr) come from
// the caller: K2 fuses them over its bracket. `contrast` is read only when
// steps == 0 (Gray only), which K2 never takes.
template <typename T, bool SH = false>
__device__ __forceinline__ Decoded gray_phase_decode(const T* f, size_t hw,
                                                     const SlrScanParams& p, bool certain,
                                                     typename Frame<T>::Raw contrast,
                                                     float S, float C, float Sr, float Cr) {
  const auto tau_white = Frame<T>::tau_white(p);
  const int code = gray_block<T, SH>(f, hw, 2, p.bits, tau_white, certain);
  int row_code = 0;
  if (p.row_bits)
    row_code = gray_block<T, SH>(f, hw, 2 + 2 * p.bits, p.row_bits, tau_white, certain);
  Decoded d;
  if (p.steps) {
    const float phi = wrapped_phase(S, C);
    const float mod = p.mod_scale * sqrtf(S * S + C * C);
    d.valid = certain && (mod > p.tau_mod);
    d.quality = mod * p.mod_out_scale;
    d.x_p = unwrap_cyclic(phi, code, p.bits, p.xp_scale, p.w_coded, p.w_fold);
  } else {
    d.x_p = ((float)code + 0.5f) * p.pitch;
    d.quality = (float)contrast * p.mod_out_scale;
    d.valid = certain;
  }
  d.y_p = 0.0f;
  if (p.row_bits) {
    if (p.row_steps) {
      const float rphi = wrapped_phase(Sr, Cr);
      const float rmod = p.row_mod_scale * sqrtf(Sr * Sr + Cr * Cr);
      d.valid = d.valid && (rmod > p.tau_mod);
      d.y_p = unwrap_cyclic(rphi, row_code, p.row_bits, p.yp_scale, p.h_coded, p.h_fold);
    } else {
      d.y_p = ((float)row_code + 0.5f) * p.row_pitch;
    }
  }
  return d;
}

// Multi-frequency hierarchical unwrap: level 0 spans the projector width, each
// finer level takes its fringe order from the previous absolute phase.
template <typename T, bool SH = false>
__device__ __forceinline__ Decoded multifreq_decode(const T* f, size_t hw,
                                                    const SlrScanParams& p, bool certain) {
  float Phi = 0.0f, mod = 0.0f;
  for (int l = 0; l < p.mf_levels; ++l) {
    float S, C;
    phase_sums<T, SH>(f, hw, 2 + l * p.steps, p.steps, p.sin_d, p.cos_d, S, C);
    const float phi = wrapped_phase(S, C);
    const float B = p.mod_scale * sqrtf(S * S + C * C);
    certain = certain && (B > p.tau_mod);
    if (l == 0) {
      Phi = phi;
      mod = B;
    } else {
      const float k = rintf((Phi * p.mf_ratio[l] - phi) / kTwoPi);  // half to even
      Phi = phi + kTwoPi * k;
      mod = fminf(mod, B);
    }
  }
  Decoded d;
  d.x_p = Phi * p.mf_xp_scale;
  if (d.x_p > p.mf_fold) d.x_p -= p.mf_period;  // atan2 wrap at x = 0
  d.y_p = 0.0f;
  d.quality = mod * p.mod_out_scale;
  d.valid = certain;
  return d;
}

// fixed-point inverse of Brown-Conrady distortion
__device__ __forceinline__ void undistort(float xd, float yd, float k1, float k2, float p1,
                                          float p2, float k3, int iters, float& xn, float& yn) {
  xn = xd;
  yn = yd;
  for (int it = 0; it < iters; ++it) {
    const float r2 = xn * xn + yn * yn;
    const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
    const float xy = xn * yn;
    const float xdd = xn * radial + 2.0f * p1 * xy + p2 * (r2 + 2.0f * xn * xn);
    const float ydd = yn * radial + p1 * (r2 + 2.0f * yn * yn) + 2.0f * p2 * xy;
    xn = xn + (xd - xdd);
    yn = yn + (yd - ydd);
  }
}

// Camera ray, plane or midpoint triangulation, depth bounds and the seven
// output planes of `out` (points x3, mask, quality, x_p, y_p).
template <int G>
__device__ __forceinline__ void triangulate_write(const SlrScanParams& p, int u, int v,
                                                  size_t pix, size_t hw, const Decoded& d,
                                                  float* __restrict__ out) {
  bool valid = d.valid;
  float X = 0.0f, Y = 0.0f, Z = 0.0f;
  if (G != kDecodeOnly) {
    // camera ray d = (xn, yn, 1), unnormalized: its parameter is depth z
    float xn, yn;
    undistort(((float)u - p.cx) / p.fx, ((float)v + p.row_offset - p.cy) / p.fy, p.k1, p.k2,
              p.p1, p.p2, p.k3, p.undistort_iters, xn, yn);
    float lam;
    if (G == kPlane) {
      // ray x projector column plane: n_p = (1, 0, -xnp), n_w = R^T n_p
      const float xnp = (d.x_p - p.pcx) / p.pfx;
      const float nwx = p.R[0] - p.R[6] * xnp;
      const float nwy = p.R[1] - p.R[7] * xnp;
      const float nwz = p.R[2] - p.R[8] * xnp;
      float den = nwx * xn + nwy * yn + nwz;
      if (fabsf(den) < 1e-12f) den = 1e-12f;
      lam = (nwx * p.C[0] + nwy * p.C[1] + nwz * p.C[2]) / den;
      X = xn * lam;
      Y = yn * lam;
      Z = lam;
    } else {
      // midpoint of the common perpendicular of the camera ray and the
      // undistorted projector ray (C, R^T (xnp, ynp, 1))
      float xnp, ynp;
      undistort((d.x_p - p.pcx) / p.pfx, (d.y_p - p.pcy) / p.pfy, p.q1, p.q2, p.s1, p.s2,
                p.q3, p.undistort_iters, xnp, ynp);
      const float d2x = p.R[0] * xnp + p.R[3] * ynp + p.R[6];
      const float d2y = p.R[1] * xnp + p.R[4] * ynp + p.R[7];
      const float d2z = p.R[2] * xnp + p.R[5] * ynp + p.R[8];
      const float a = xn * xn + yn * yn + 1.0f;
      const float bb = xn * d2x + yn * d2y + d2z;
      const float cc = d2x * d2x + d2y * d2y + d2z * d2z;
      const float dd = -(xn * p.C[0] + yn * p.C[1] + p.C[2]);
      const float e = -(d2x * p.C[0] + d2y * p.C[1] + d2z * p.C[2]);
      float den = a * cc - bb * bb;
      if (fabsf(den) < 1e-12f) den = 1e-12f;
      const float s = (bb * e - cc * dd) / den;
      const float t = (a * e - bb * dd) / den;
      X = 0.5f * (s * xn + p.C[0] + t * d2x);
      Y = 0.5f * (s * yn + p.C[1] + t * d2y);
      Z = 0.5f * (s + p.C[2] + t * d2z);
      lam = Z;
    }
    valid = valid && (lam > p.zmin) && (lam < p.zmax);
  }
  out[pix] = valid ? X : 0.0f;
  out[hw + pix] = valid ? Y : 0.0f;
  out[2 * hw + pix] = valid ? Z : 0.0f;
  out[3 * hw + pix] = valid ? 1.0f : 0.0f;
  out[4 * hw + pix] = d.quality;
  out[5 * hw + pix] = d.x_p;
  out[6 * hw + pix] = d.y_p;
}

// One pixel's decode from its frames at f, f + hw, f + 2 hw, ...
template <typename T, bool MF, bool SH>
__device__ __forceinline__ Decoded decode_pixel(const T* f, size_t hw, const SlrScanParams& p) {
  // shadow mask: white - black contrast
  const auto contrast = Frame<T, SH>::load(f) - Frame<T, SH>::load(f + hw);
  const bool certain = contrast > Frame<T>::tau_black(p);
  if (MF) return multifreq_decode<T, SH>(f, hw, p, certain);
  const int base = 2 + 2 * p.bits + 2 * p.row_bits;
  float S = 0.0f, C = 0.0f, Sr = 0.0f, Cr = 0.0f;
  if (p.steps) phase_sums<T, SH>(f, hw, base, p.steps, p.sin_d, p.cos_d, S, C);
  if (p.row_steps)
    phase_sums<T, SH>(f, hw, base + p.steps, p.row_steps, p.row_sin_d, p.row_cos_d, Sr, Cr);
  return gray_phase_decode<T, SH>(f, hw, p, certain, contrast, S, C, Sr, Cr);
}

// K1: a block of BOX_W x BOX_H pixels first copies the box's F frames into
// shared memory with 16-byte cp.async copies, every one issued before any
// is awaited, then each thread decodes its pixel from shared memory and
// triangulates it, with the functions above. Loaded one frame at a time by
// each thread, a warp load carries 32 (uint8), 64 (uint16) or 128 bytes
// (float32) and a thread has one or two in flight; staged, a box of F = 20
// frames is 320 (uint8) to 1,280 (float32) copies of 16 bytes in flight at
// once. A box of 128 x 2 keeps each of its rows one 128-byte line of a
// uint8 frame. A box that a 16-byte copy cannot take whole (frames whose
// rows are not 16-byte aligned, or the map's ragged edge) is not staged:
// its threads decode straight from device memory, a frame at a time, and
// the launch reserves no shared memory when no box can be staged. A warp
// covers 32 pixels of one row either way, so each of a thread's 7 output
// stores is part of one coalesced 128-byte write of the warp; float4 stores
// would need 4 pixels a thread, whose frames would have to sit in
// registers, and those registers cost the resident warps that keep the
// loads in flight.
#define BOX_W 128
#define BOX_H 2

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

template <typename T, int G, bool MF>
__global__ void __launch_bounds__(BOX_W * BOX_H)
fused_scan_kernel(const T* __restrict__ frames, float* __restrict__ out,
                  const __grid_constant__ SlrScanParams p, int nframes, int aligned) {
  extern __shared__ __align__(16) unsigned char k1_box[];
  T* box = reinterpret_cast<T*>(k1_box);  // [frame][row][column] of the box
  constexpr int AREA = BOX_W * BOX_H;
  const int u0 = blockIdx.x * BOX_W, v0 = blockIdx.y * BOX_H;
  const size_t hw = (size_t)p.height * p.width;
  // the same for every thread of the block
  const bool staged = aligned && u0 + BOX_W <= p.width && v0 + BOX_H <= p.height;
  if (staged) {
    constexpr int PER = 16 / (int)sizeof(T);  // pixels a 16-byte copy
    constexpr int CHUNKS = BOX_W / PER;       // copies a box row
    const int total = nframes * BOX_H * CHUNKS;
    for (int c = threadIdx.y * BOX_W + threadIdx.x; c < total; c += AREA) {
      const int q = c % CHUNKS, r = (c / CHUNKS) % BOX_H, f = c / (CHUNKS * BOX_H);
      cp_async16(box + (f * BOX_H + r) * BOX_W + q * PER,
                 frames + f * hw + (size_t)(v0 + r) * p.width + u0 + q * PER);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  const int u = u0 + threadIdx.x, v = v0 + threadIdx.y;
  if (u >= p.width || v >= p.height) return;
  const size_t pix = (size_t)v * p.width + u;
  const Decoded d =
      staged ? decode_pixel<T, MF, true>(box + threadIdx.y * BOX_W + threadIdx.x, AREA, p)
             : decode_pixel<T, MF, false>(frames + pix, hw, p);
  triangulate_write<G>(p, u, v, pix, hw, d, out);
}

// K2. One pass over the exposures: each one's phase sums, modulation B and
// usability (contrast above tau_black, white below saturation); the running
// best (score = B if usable else -1, replaced only by a larger score, so the
// first exposure wins ties) with its sums, and the running sums of B*S, B*C
// and B over the usable ones. Then the Gray frames of the best exposure only.
template <typename T, int G>
__global__ void __launch_bounds__(256)
fused_scan_hdr_kernel(const T* __restrict__ stacks, float* __restrict__ out,
                      const __grid_constant__ SlrScanParams p) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= p.width || v >= p.height) return;
  const size_t hw = (size_t)p.height * p.width;
  const size_t pix = (size_t)v * p.width + u;
  const int base = 2 + 2 * p.bits + 2 * p.row_bits;
  const size_t stride = (size_t)(base + p.steps + p.row_steps) * hw;  // one exposure

  int best = 0;
  float best_score = -1.0f;
  float bS = 0.0f, bC = 0.0f, bSr = 0.0f, bCr = 0.0f;             // select
  float sw = 0.0f, sS = 0.0f, sC = 0.0f, sSr = 0.0f, sCr = 0.0f;  // sum
  for (int e = 0; e < p.exposures; ++e) {
    const T* f = stacks + e * stride + pix;
    float S, C, Sr = 0.0f, Cr = 0.0f;
    phase_sums(f, hw, base, p.steps, p.sin_d, p.cos_d, S, C);
    if (p.row_steps)
      phase_sums(f, hw, base + p.steps, p.row_steps, p.row_sin_d, p.row_cos_d, Sr, Cr);
    const float B = p.mod_scale * sqrtf(S * S + C * C);
    const auto white = Frame<T>::load(f);
    const bool usable = (white - Frame<T>::load(f + hw)) > Frame<T>::tau_black(p) &&
                        white < Frame<T>::tau_sat(p);
    const float score = usable ? B : -1.0f;
    if (e == 0 || score > best_score) {
      best = e;
      best_score = score;
      bS = S;
      bC = C;
      bSr = Sr;
      bCr = Cr;
    }
    const float w = usable ? B : 0.0f;
    sw = sw + w;
    sS = sS + w * S;
    sC = sC + w * C;
    sSr = sSr + w * Sr;
    sCr = sCr + w * Cr;
  }
  if (p.fuse == kSum) {
    const float norm = fmaxf(sw, 1e-20f);
    bS = sS / norm;
    bC = sC / norm;
    bSr = sSr / norm;
    bCr = sCr / norm;
  }
  const T* f = stacks + best * stride + pix;
  const Decoded d =
      gray_phase_decode(f, hw, p, best_score >= 0.0f, (typename Frame<T>::Raw)0, bS, bC, bSr, bCr);
  triangulate_write<G>(p, u, v, pix, hw, d, out);
}

template <typename T, int G, bool MF>
cudaError_t launch_k1_kernel(const T* f, float* out, const SlrScanParams& p,
                             cudaStream_t stream) {
  const int nframes = p.multifreq ? 2 + p.mf_levels * p.steps
                                  : 2 + 2 * p.bits + 2 * p.row_bits + p.steps + p.row_steps;
  const int aligned =
      reinterpret_cast<uintptr_t>(f) % 16 == 0 && (p.width * sizeof(T)) % 16 == 0;
  const size_t smem = aligned ? (size_t)nframes * BOX_W * BOX_H * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_scan_kernel<T, G, MF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.width + BOX_W - 1) / BOX_W, (p.height + BOX_H - 1) / BOX_H);
  fused_scan_kernel<T, G, MF><<<grid, dim3(BOX_W, BOX_H), smem, stream>>>(f, out, p, nframes,
                                                                          aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k1(const void* frames, float* out, const SlrScanParams& p,
                      cudaStream_t stream) {
  const T* f = static_cast<const T*>(frames);
  if (p.multifreq) {
    if (p.geometry == kPlane) return launch_k1_kernel<T, kPlane, true>(f, out, p, stream);
    if (p.geometry == kDecodeOnly)
      return launch_k1_kernel<T, kDecodeOnly, true>(f, out, p, stream);
    return cudaErrorInvalidValue;  // multifreq codes no rows
  }
  if (p.geometry == kPlane) return launch_k1_kernel<T, kPlane, false>(f, out, p, stream);
  if (p.geometry == kMidpoint) return launch_k1_kernel<T, kMidpoint, false>(f, out, p, stream);
  if (p.geometry == kDecodeOnly)
    return launch_k1_kernel<T, kDecodeOnly, false>(f, out, p, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_k2(const void* stacks, float* out, const SlrScanParams& p, dim3 grid,
                      dim3 block, cudaStream_t stream) {
  const T* s = static_cast<const T*>(stacks);
  if (p.multifreq || p.steps <= 0 || p.exposures <= 0) return cudaErrorInvalidValue;
  if (p.geometry == kPlane)
    fused_scan_hdr_kernel<T, kPlane><<<grid, block, 0, stream>>>(s, out, p);
  else if (p.geometry == kMidpoint)
    fused_scan_hdr_kernel<T, kMidpoint><<<grid, block, 0, stream>>>(s, out, p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int slr_fused_scan_params_size(void) { return (int)sizeof(SlrScanParams); }

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Both entry points launch on `stream` (PyTorch's current stream) of
// `device`, write the (7, H, W) float planes of `out`, and return the
// launch's error code (0: launched). They do not synchronise and allocate
// nothing.
int slr_fused_scan(const void* frames, float* out, const SlrScanParams* params, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SlrScanParams& p = *params;
  switch (p.dtype) {
    case 0: return (int)launch_k1<float>(frames, out, p, stream);
    case 1: return (int)launch_k1<uint8_t>(frames, out, p, stream);
    case 2: return (int)launch_k1<uint16_t>(frames, out, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int slr_fused_scan_hdr(const void* stacks, float* out, const SlrScanParams* params, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SlrScanParams& p = *params;
  const dim3 block(32, 8);
  const dim3 grid((p.width + block.x - 1) / block.x, (p.height + block.y - 1) / block.y);
  switch (p.dtype) {
    case 0: return (int)launch_k2<float>(stacks, out, p, grid, block, stream);
    case 1: return (int)launch_k2<uint8_t>(stacks, out, p, grid, block, stream);
    case 2: return (int)launch_k2<uint16_t>(stacks, out, p, grid, block, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
