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
// fused_scan_kernel). K2 stages its bracket the same way in two rounds: the
// frames every pixel reads, then, a warp at a time, the Gray frames of only
// the exposures the warp's pixels chose (see fused_scan_hdr_kernel).
// Integer frames are widened to int: the
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
#define SLR_MAX_SMEM 232448  // bytes of shared memory a block may opt in to
#define SLR_SM_SMEM 233472   // bytes of shared memory an SM has

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

// The camera ray d = (xn, yn, 1) of pixel (u, v), unnormalized: its
// parameter is depth z. It needs no frame, so K2 computes it while its
// copies are in flight.
__device__ __forceinline__ void camera_ray(const SlrScanParams& p, int u, int v, float& xn,
                                           float& yn) {
  undistort(((float)u - p.cx) / p.fx, ((float)v + p.row_offset - p.cy) / p.fy, p.k1, p.k2, p.p1,
            p.p2, p.k3, p.undistort_iters, xn, yn);
}

// Plane or midpoint triangulation of the camera ray (xn, yn, 1) (unread by
// decode only), depth bounds and the seven output planes of `out` (points
// x3, mask, quality, x_p, y_p).
template <int G>
__device__ __forceinline__ void triangulate_write(const SlrScanParams& p, float xn, float yn,
                                                  size_t pix, size_t hw, const Decoded& d,
                                                  float* __restrict__ out) {
  bool valid = d.valid;
  float X = 0.0f, Y = 0.0f, Z = 0.0f;
  if (G != kDecodeOnly) {
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
  float xn = 0.0f, yn = 0.0f;
  if (G != kDecodeOnly) camera_ray(p, u, v, xn, yn);
  triangulate_write<G>(p, xn, yn, pix, hw, d, out);
}

// K2's choice for one pixel: the best exposure (the first of the largest
// scores), its score, and the phase sums the decode takes.
struct HdrChoice {
  int best;
  float score, S, C, Sr, Cr;
};

// One pass over the exposures, exposure e's frames at f + e stride, f + e
// stride + hw, ...: each one's phase sums, modulation B and usability
// (contrast above tau_black, white below saturation); the running best
// (score = B if usable else -1, replaced only by a larger score, so the
// first exposure wins ties) with its sums, and the running sums of B*S, B*C
// and B over the usable ones.
template <typename T, bool SH>
__device__ __forceinline__ HdrChoice hdr_choose(const T* f, size_t hw, size_t stride,
                                                const SlrScanParams& p) {
  const int base = 2 + 2 * p.bits + 2 * p.row_bits;
  HdrChoice b{0, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f};                  // select
  float sw = 0.0f, sS = 0.0f, sC = 0.0f, sSr = 0.0f, sCr = 0.0f;  // sum
  for (int e = 0; e < p.exposures; ++e) {
    const T* fe = f + e * stride;
    float S, C, Sr = 0.0f, Cr = 0.0f;
    phase_sums<T, SH>(fe, hw, base, p.steps, p.sin_d, p.cos_d, S, C);
    if (p.row_steps)
      phase_sums<T, SH>(fe, hw, base + p.steps, p.row_steps, p.row_sin_d, p.row_cos_d, Sr, Cr);
    const float B = p.mod_scale * sqrtf(S * S + C * C);
    const auto white = Frame<T, SH>::load(fe);
    const bool usable = (white - Frame<T, SH>::load(fe + hw)) > Frame<T>::tau_black(p) &&
                        white < Frame<T>::tau_sat(p);
    const float score = usable ? B : -1.0f;
    if (e == 0 || score > b.score) b = HdrChoice{e, score, S, C, Sr, Cr};
    const float w = usable ? B : 0.0f;
    sw = sw + w;
    sS = sS + w * S;
    sC = sC + w * C;
    sSr = sSr + w * Sr;
    sCr = sCr + w * Cr;
  }
  if (p.fuse == kSum) {
    const float norm = fmaxf(sw, 1e-20f);
    b.S = sS / norm;
    b.C = sC / norm;
    b.Sr = sSr / norm;
    b.Cr = sCr / norm;
  }
  return b;
}

// K2: a block of BOX_W x BOX_H pixels, as K1's. Bound: bytes, 60 B a pixel
// at config 3 (white, black and the 4 phase frames of 3 exposures, the 14
// Gray frames of one, 28 B out). Read one frame at a time by each thread, a
// warp load of a uint8 frame is one 32-byte sector and a thread has about
// one in flight, behind its phase sums' FMA chain; and a warp's Gray reads
// split over the exposures its pixels chose. So the box is staged as K1's:
// (1) white, black and the phase frames of every exposure, E (2 + steps +
// row_steps) frames, by 16-byte cp.async copies, all in flight before any is
// awaited, while each thread computes its camera ray (the 8-step
// undistortion needs no frame); (2) each pixel's choice from shared memory;
// (3) each warp votes (__any_sync per exposure) on the exposures its 32
// pixels chose and copies those exposures' Gray frames of its own row
// segment, 32 pixels a frame, so that a warp whose pixels agree reads the
// least bytes and no warp waits on another's copies or on a block barrier;
// (4) the decode and the triangulation from shared memory. Round (3) waits
// on round (2)'s choice, so a warp has two memory latencies in series; as
// many resident blocks as the SM holds overlap them (K2Occupancy). The
// staged box keeps the stack's layout [exposure][frame][row][column], so
// the decode functions read it as they read device memory, with the box's
// area for the frame stride; the launch reserves the whole bracket's box,
// E F BOX_W BOX_H elements (15.4 KB for a uint8 bracket of 3 x 20 frames;
// 61.4 KB as float32, past the 48 KB default). A box no 16-byte copy takes
// whole (rows not a multiple of 16 bytes, a base off 16-byte alignment, the
// ragged edge), or a bracket whose box would not fit in shared memory,
// decodes from device memory. TMA would need a tensor map built on the host
// for every bracket shape and type; a box is 2 rows of 128 to 512 bytes a
// frame, which 16-byte copies move in one or two instructions a thread, so
// cp.async serves as well.
//
// The resident blocks an SM that K2's register budget is cut for: 6 (at
// most 40 registers a thread), or fewer where config 3's staged box (3
// exposures of 20 frames, and the 1 KB an SM reserves a block) lets fewer
// fit in an SM's shared memory: 6 for uint8 and uint16, 3 for float32,
// whose threads then keep up to 80 registers.
template <typename T>
struct K2Occupancy {
  static constexpr int kBox = 3 * 20 * BOX_W * BOX_H * (int)sizeof(T) + 1024;
  static constexpr int kBlocks = SLR_SM_SMEM / kBox < 6 ? SLR_SM_SMEM / kBox : 6;
};

template <typename T, int G>
__global__ void __launch_bounds__(BOX_W * BOX_H, K2Occupancy<T>::kBlocks)
fused_scan_hdr_kernel(const T* __restrict__ stacks, float* __restrict__ out,
                      const __grid_constant__ SlrScanParams p, int nframes, int aligned) {
  extern __shared__ __align__(16) unsigned char k2_box[];
  T* box = reinterpret_cast<T*>(k2_box);  // [exposure][frame][row][column] of the box
  constexpr int AREA = BOX_W * BOX_H;
  constexpr int PER = 16 / (int)sizeof(T);  // pixels a 16-byte copy
  constexpr int CHUNKS = BOX_W / PER;       // copies a box row
  const int tid = threadIdx.y * BOX_W + threadIdx.x;
  const int u0 = blockIdx.x * BOX_W, v0 = blockIdx.y * BOX_H;
  const int u = u0 + threadIdx.x, v = v0 + threadIdx.y;
  const size_t hw = (size_t)p.height * p.width;
  const size_t pix = (size_t)v * p.width + u;
  // the same for every thread of the block
  const bool staged = aligned && u0 + BOX_W <= p.width && v0 + BOX_H <= p.height;
  if (!staged) {
    if (u >= p.width || v >= p.height) return;
    const HdrChoice b = hdr_choose<T, false>(stacks + pix, hw, nframes * hw, p);
    const Decoded d = gray_phase_decode<T, false>(stacks + b.best * nframes * hw + pix, hw, p,
                                                  b.score >= 0.0f, (typename Frame<T>::Raw)0,
                                                  b.S, b.C, b.Sr, b.Cr);
    float xn, yn;
    camera_ray(p, u, v, xn, yn);
    triangulate_write<G>(p, xn, yn, pix, hw, d, out);
    return;
  }
  // (1) white, black and the phase frames of every exposure, by the block
  const int gray = 2 * p.bits + 2 * p.row_bits, base = 2 + gray;
  const int first = 2 + p.steps + p.row_steps;  // frames a pixel reads of every exposure
  for (int c = tid; c < p.exposures * first * BOX_H * CHUNKS; c += AREA) {
    const int j = c / (CHUNKS * BOX_H), e = j / first, k = j % first;
    const int slot = e * nframes + (k < 2 ? k : base + k - 2);  // e * nframes + frame
    const int q = c % CHUNKS, r = (c / CHUNKS) % BOX_H;
    cp_async16(box + (slot * BOX_H + r) * BOX_W + q * PER,
               stacks + slot * hw + (size_t)(v0 + r) * p.width + u0 + q * PER);
  }
  float xn, yn;
  camera_ray(p, u, v, xn, yn);  // while the copies fly
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // (2) the choice
  const T* f = box + threadIdx.y * BOX_W + threadIdx.x;
  const HdrChoice b = hdr_choose<T, true>(f, AREA, nframes * AREA, p);
  // (3) the Gray frames of the exposures the warp's 32 pixels chose, by
  // the warp alone: a warp's row of the box, WCH 16-byte copies a frame
  constexpr int WCH = 32 / PER;
  const int lane = threadIdx.x % 32, w0 = threadIdx.x - lane;  // the warp's first column
  for (int e = 0; e < p.exposures; ++e) {
    if (!__any_sync(0xffffffffu, b.best == e)) continue;
    for (int c = lane; c < gray * WCH; c += 32) {
      const int slot = e * nframes + 2 + c / WCH, q = c % WCH;
      cp_async16(box + (slot * BOX_H + threadIdx.y) * BOX_W + w0 + q * PER,
                 stacks + slot * hw + (size_t)v * p.width + u0 + w0 + q * PER);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  // (4) decode and triangulate
  const Decoded d = gray_phase_decode<T, true>(f + b.best * nframes * AREA, AREA, p,
                                               b.score >= 0.0f, (typename Frame<T>::Raw)0,
                                               b.S, b.C, b.Sr, b.Cr);
  triangulate_write<G>(p, xn, yn, pix, hw, d, out);
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

template <typename T, int G>
cudaError_t launch_k2_kernel(const T* s, float* out, const SlrScanParams& p,
                             cudaStream_t stream) {
  const int nframes = 2 + 2 * p.bits + 2 * p.row_bits + p.steps + p.row_steps;
  size_t smem = (size_t)p.exposures * nframes * BOX_W * BOX_H * sizeof(T);
  const int aligned = reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                      (p.width * sizeof(T)) % 16 == 0 && smem <= SLR_MAX_SMEM;
  if (!aligned) smem = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_scan_hdr_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.width + BOX_W - 1) / BOX_W, (p.height + BOX_H - 1) / BOX_H);
  fused_scan_hdr_kernel<T, G><<<grid, dim3(BOX_W, BOX_H), smem, stream>>>(s, out, p, nframes,
                                                                         aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k2(const void* stacks, float* out, const SlrScanParams& p,
                      cudaStream_t stream) {
  const T* s = static_cast<const T*>(stacks);
  if (p.multifreq || p.steps <= 0 || p.exposures <= 0) return cudaErrorInvalidValue;
  if (p.geometry == kPlane) return launch_k2_kernel<T, kPlane>(s, out, p, stream);
  if (p.geometry == kMidpoint) return launch_k2_kernel<T, kMidpoint>(s, out, p, stream);
  return cudaErrorInvalidValue;
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
  switch (p.dtype) {
    case 0: return (int)launch_k2<float>(stacks, out, p, stream);
    case 1: return (int)launch_k2<uint8_t>(stacks, out, p, stream);
    case 2: return (int)launch_k2<uint16_t>(stacks, out, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
