// Monotone-crossing inversion, for Hopper: kernels K6 and K7.
//
// K6 replaces slr/kernels/crossing.py::crossing_bin_sum (_kernel), the bare
// contraction of the tiled route:
//     out[r, n, k] = sum_u [lo[r, u] <= k < hi[r, u]] * payload[r, n, u].
// K7 replaces crossing.py::crossing_interp_fused (_fused_kernel), the whole
// inversion of one row of a code map in one launch: pair validity (both
// pixels valid, dmin < d < dmax, the carried-channel gates), the affine
// coefficients a = q_lo - lo * g, g = (q_hi - q_lo) / d of each interpolated
// channel, the per-bin sums, and the interpolation (A + k * B) / cnt.
// Their plain PyTorch versions are slr_torch/kernels/crossing.py::
// crossing_bin_sum_reference and crossing_interp_fused_reference.
//
// Design: one block per row. The row's pairs are staged in shared memory
// (K6: lo, hi; K7: lo, hi and the per-pair payload terms, built once), and
// each chunk of 32 pairs is summarised by [min lo, max hi) over its firing
// pairs. Then a thread per bin walks the chunk summaries, scans only the
// chunks that can fire its bin, and sums the crossings it finds in
// ascending pair order. A valid pair fires at most ceil(dmax) bins, so the
// useful work is O(U) a row and not the TPU's K x U one-hot product, which
// existed only because Mosaic had no scatter (and its bf16 3-split because
// Mosaic rejected bf16 dots): neither is carried over. No float atomics:
// each bin is summed by one thread in a fixed order, so two runs give the
// same bits. Every term is rounded as the plain version rounds it
// (__fsub_rn, __fdiv_rn, __fadd_rn; a = q_lo - lo * g and A + k * B as the
// reference's FMAs, the exact product summed in float64 and rounded once to
// float32 by fma_once), and a sum of one or two terms does not depend on
// its order, so the kernels equal their plain versions bit for bit wherever
// a bin has at most two crossings.
//
// Bound: both read each input once and write each output once; the
// arithmetic is a few operations per pair and per bin, so they are bound
// by bytes (K7 at config 3: ~48 MB a pass-1 launch, ~14 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SLR_XING_THREADS 256
#define SLR_XING_CHUNK 32       // pairs per chunk summary: one warp's lanes
#define SLR_XING_NGROUP 8       // K6 payload channels summed per walk of a row
#define SLR_XING_MAX_C 8        // K7 channels
#define SLR_XING_MAX_TERMS 16   // K7 payload terms: 2 per interpolated channel, 1 per nearest
#define SLR_XING_MAX_GATES 8
#define SLR_XING_SMEM_MAX 232448

namespace {

// a * b + c rounded once to float32 from the exact product (a float32
// product is exact in float64): crossing.py::_fma, bit for bit
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

struct Gates {
  int n;
  int ch[SLR_XING_MAX_GATES];
  float thr[SLR_XING_MAX_GATES];
};

// [clo[c], chi[c]) = [min lo, max hi) over the firing pairs (lo < hi) of
// chunk c; an empty chunk gets [inf, -inf) and never matches.
__device__ void chunk_bounds(const float* lo, const float* hi, int np, float* clo,
                             float* chi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (np + SLR_XING_CHUNK - 1) / SLR_XING_CHUNK;
  for (int c = warp; c < nchunks; c += blockDim.x >> 5) {
    const int u = c * SLR_XING_CHUNK + lane;
    float a = CUDART_INF_F, b = -CUDART_INF_F;
    if (u < np && lo[u] < hi[u]) {
      a = lo[u];
      b = hi[u];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (lane == 0) {
      clo[c] = a;
      chi[c] = b;
    }
  }
}

__global__ void __launch_bounds__(SLR_XING_THREADS)
bin_sum_kernel(const float* __restrict__ lo_g, const float* __restrict__ hi_g,
               const float* __restrict__ pay, int U, int N, int K, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int r = blockIdx.x;
  const int nchunks = (U + SLR_XING_CHUNK - 1) / SLR_XING_CHUNK;
  float* lo = sm;
  float* hi = lo + U;
  float* clo = hi + U;
  float* chi = clo + nchunks;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    lo[u] = lo_g[(size_t)r * U + u];
    hi[u] = hi_g[(size_t)r * U + u];
  }
  __syncthreads();
  chunk_bounds(lo, hi, U, clo, chi);
  __syncthreads();
  const float* p = pay + (size_t)r * N * U;
  float* o = out + (size_t)r * N * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float kf = (float)k;
    for (int n0 = 0; n0 < N; n0 += SLR_XING_NGROUP) {
      float acc[SLR_XING_NGROUP];
#pragma unroll
      for (int j = 0; j < SLR_XING_NGROUP; ++j) acc[j] = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        if (!(clo[c] <= kf && kf < chi[c])) continue;
        const int u1 = min((c + 1) * SLR_XING_CHUNK, U);
        for (int u = c * SLR_XING_CHUNK; u < u1; ++u) {
          if (lo[u] <= kf && kf < hi[u]) {
#pragma unroll
            for (int j = 0; j < SLR_XING_NGROUP; ++j)
              if (n0 + j < N) acc[j] = __fadd_rn(acc[j], p[(size_t)(n0 + j) * U + u]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < SLR_XING_NGROUP; ++j)
        if (n0 + j < N) o[(size_t)(n0 + j) * K + k] = acc[j];
    }
  }
}

// amask: bit t set where payload term t is the `a` of an interpolated
// channel (term t + 1 is its g); nmask: where term t is a nearest value.
// Output channel of term t: the number of a- and nearest terms before it.
__global__ void __launch_bounds__(SLR_XING_THREADS)
interp_fused_kernel(const float* __restrict__ code, const uint8_t* __restrict__ valid,
                    const float* __restrict__ chans, int R, int U, int C, int K,
                    int interp_mask, unsigned amask, unsigned nmask, int T, Gates gates,
                    float dmin, float dmax, float* __restrict__ cnt_out,
                    float* __restrict__ vals_out) {
  extern __shared__ float sm[];
  const int r = blockIdx.x;
  const int np = U - 1;
  const int nchunks = (np + SLR_XING_CHUNK - 1) / SLR_XING_CHUNK;
  float* lo = sm;
  float* hi = lo + np;
  float* terms = hi + np;
  float* clo = terms + (size_t)T * np;
  float* chi = clo + nchunks;
  const size_t cs = (size_t)R * U;  // channel stride
  const float* crow = code + (size_t)r * U;
  const uint8_t* vrow = valid + (size_t)r * U;
  const float* qrow = chans + (size_t)r * U;

  // the row's pairs: validity, codes (-1 where invalid), payload terms
  for (int u = threadIdx.x; u < np; u += blockDim.x) {
    const float cl = crow[u], ch = crow[u + 1];
    const float d = __fsub_rn(ch, cl);
    bool pv = vrow[u] != 0 && vrow[u + 1] != 0 && d > dmin && d < dmax;
    for (int i = 0; i < gates.n; ++i) {
      const float* q = qrow + gates.ch[i] * cs;
      pv = pv && fabsf(__fsub_rn(q[u + 1], q[u])) < gates.thr[i];
    }
    lo[u] = pv ? cl : -1.f;
    hi[u] = pv ? ch : -1.f;
    const float d_safe = pv ? d : 1.f;
    int t = 0;
    for (int c = 0; c < C; ++c) {
      const float q_lo = qrow[c * cs + u];
      if ((interp_mask >> c) & 1) {
        const float g = __fdiv_rn(__fsub_rn(qrow[c * cs + u + 1], q_lo), d_safe);
        const float a = fma_once(-cl, g, q_lo);
        terms[(size_t)t * np + u] = pv ? a : 0.f;
        terms[(size_t)(t + 1) * np + u] = pv ? g : 0.f;
        t += 2;
      } else {
        terms[(size_t)t * np + u] = pv ? q_lo : 0.f;
        t += 1;
      }
    }
  }
  __syncthreads();
  chunk_bounds(lo, hi, np, clo, chi);
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float kf = (float)k;
    float n = 0.f;
    float acc[SLR_XING_MAX_TERMS];
#pragma unroll
    for (int t = 0; t < SLR_XING_MAX_TERMS; ++t) acc[t] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      if (!(clo[c] <= kf && kf < chi[c])) continue;
      const int u1 = min((c + 1) * SLR_XING_CHUNK, np);
      for (int u = c * SLR_XING_CHUNK; u < u1; ++u) {
        if (lo[u] <= kf && kf < hi[u]) {
          n = __fadd_rn(n, 1.f);
#pragma unroll
          for (int t = 0; t < SLR_XING_MAX_TERMS; ++t)
            if (t < T) acc[t] = __fadd_rn(acc[t], terms[(size_t)t * np + u]);
        }
      }
    }
    const float safe = fmaxf(n, 1e-9f);
    cnt_out[(size_t)r * K + k] = n;
#pragma unroll
    for (int t = 0; t < SLR_XING_MAX_TERMS; ++t) {
      const bool is_a = (amask >> t) & 1u, is_n = (nmask >> t) & 1u;
      if (!is_a && !is_n) continue;
      const int c = __popc((amask | nmask) & ((1u << t) - 1u));
      float v;
      if (is_a && t + 1 < SLR_XING_MAX_TERMS)
        v = __fdiv_rn(fma_once(kf, acc[t + 1], acc[t]), safe);
      else
        v = __fdiv_rn(acc[t], safe);
      vals_out[(size_t)c * R * K + (size_t)r * K + k] = v;
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes > SLR_XING_SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory (bytes) a K6 block needs for U pairs.
long long slr_bin_sum_smem(int U) {
  const long long nchunks = (U + SLR_XING_CHUNK - 1) / SLR_XING_CHUNK;
  return 4LL * (2LL * U + 2LL * nchunks);
}

// Shared memory (bytes) a K7 block needs for U codes and T payload terms.
long long slr_interp_fused_smem(int U, int T) {
  const long long np = U - 1;
  const long long nchunks = (np + SLR_XING_CHUNK - 1) / SLR_XING_CHUNK;
  return 4LL * ((2LL + T) * np + 2LL * nchunks);
}

// K6: lo, hi (R, U) and payload (R, N, U), float32, contiguous -> out
// (R, N, K). Launches on `stream` of `device` and returns the launch's
// error code (0: launched); neither synchronises nor allocates.
int slr_crossing_bin_sum(const float* lo, const float* hi, const float* payload, int R,
                         int U, int N, int K, float* out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 0 || U < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || K == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)slr_bin_sum_smem(U);
  err = set_smem((const void*)bin_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bin_sum_kernel<<<R, SLR_XING_THREADS, smem, stream>>>(lo, hi, payload, U, N, K, out);
  return (int)cudaGetLastError();
}

// K7: code (R, U) float32, valid (R, U) bytes (0/1), channels (C, R, U)
// float32, contiguous; bit c of interp_mask: channel c is interpolated
// (else its left-pixel value is carried); gates: n_gates (channel, max
// jump) vetoes. Writes cnt (R, K) and vals (C, R, K). Launches on `stream`
// of `device` and returns the launch's error code (0: launched).
int slr_crossing_interp_fused(const float* code, const uint8_t* valid, const float* channels,
                              int R, int U, int C, int K, int interp_mask, int n_gates,
                              const int* gate_ch, const float* gate_thr, float dmin, float dmax,
                              float* cnt, float* vals, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 0 || U < 2 || C < 1 || C > SLR_XING_MAX_C || K < 0 || n_gates < 0 ||
      n_gates > SLR_XING_MAX_GATES)
    return (int)cudaErrorInvalidValue;
  unsigned amask = 0u, nmask = 0u;
  int T = 0;
  for (int c = 0; c < C; ++c) {
    if ((interp_mask >> c) & 1) {
      amask |= 1u << T;
      T += 2;
    } else {
      nmask |= 1u << T;
      T += 1;
    }
  }
  if (T > SLR_XING_MAX_TERMS) return (int)cudaErrorInvalidValue;
  Gates gates = {};
  gates.n = n_gates;
  for (int i = 0; i < n_gates; ++i) {
    if (gate_ch[i] < 0 || gate_ch[i] >= C) return (int)cudaErrorInvalidValue;
    gates.ch[i] = gate_ch[i];
    gates.thr[i] = gate_thr[i];
  }
  if (R == 0 || K == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)slr_interp_fused_smem(U, T);
  err = set_smem((const void*)interp_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  interp_fused_kernel<<<R, SLR_XING_THREADS, smem, stream>>>(
      code, valid, channels, R, U, C, K, interp_mask, amask, nmask, T, gates, dmin, dmax, cnt,
      vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
