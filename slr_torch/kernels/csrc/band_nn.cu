// Sorted-band nearest-neighbour search, for Hopper: kernel K8.
//
// Replaces slr/registration/band.py::band_nn_sorted (_band_kernel), the
// correspondence search of point-to-plane ICP on dense clouds. The plain
// PyTorch version is slr_torch/kernels/band_nn.py::band_nn_sorted_reference.
//
// Contract: queries and targets are sorted along one axis; block b takes
// the SLR_BAND_QT consecutive queries of tile b and scans every target
// position of its band [jstart[b] * tt, jend[b] * tt), which holds every
// target within r of any of its queries. Each thread keeps its query's
// best (d2, sorted position); positions are walked in ascending order and
// a candidate replaces the best only when strictly closer, so ties go to
// the lowest sorted position (the reference's rule). Then the thread reads
// its winner's point, normal and original index from the sorted arrays.
// d2 = (dx*dx + dy*dy) + dz*dz, every product and sum rounded once
// (__fmul_rn / __fadd_rn: nvcc would contract them into FMAs), so the
// result equals the plain version's bit for bit. The band is walked to its
// end: nothing is truncated.
//
// Bounds and design: at 256k x 256k scan points and r = 8 mm a query meets
// ~1e4 band targets, ~3e9 pair evaluations per search, each 3 subtractions,
// 3 products, 2 sums, a compare and two selects on the CUDA cores, and one
// broadcast shared-memory read: the kernel is bound by instruction issue,
// not memory (each band target is read from device memory once per block,
// 12 B, then broadcast from shared memory to the 128 threads). The TPU
// kernel's bf16 3-split payload, one-hot extraction matmul and static
// (tiles x b_max) grid were workarounds for the MXU and are not carried
// over; wgmma, TMA and pruning inside the band are left for later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SLR_BAND_QT 128     // queries per block, one per thread
#define SLR_BAND_CHUNK 512  // band targets staged in shared memory per step

namespace {

__global__ void __launch_bounds__(SLR_BAND_QT)
band_nn_kernel(const float* __restrict__ qc, const uint8_t* __restrict__ qvalid,
               const float* __restrict__ tc, const float* __restrict__ tn,
               const long long* __restrict__ tidx, const long long* __restrict__ jstart,
               const long long* __restrict__ jend, int Q, int Tp, int tt, float r2,
               float* __restrict__ d2_out, float* __restrict__ pts_out,
               float* __restrict__ nrm_out, long long* __restrict__ idx_out) {
  __shared__ float4 st[SLR_BAND_CHUNK];
  const int tile = blockIdx.x;
  const int q = tile * SLR_BAND_QT + threadIdx.x;
  const bool active = q < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qc[q];
    qy = qc[(size_t)Q + q];
    qz = qc[2 * (size_t)Q + q];
  }
  long long lo = jstart[tile] * tt;
  long long hi = jend[tile] * tt;
  if (hi > Tp) hi = Tp;
  float best = CUDART_INF_F;
  int best_pos = -1;
  for (long long base = lo; base < hi; base += SLR_BAND_CHUNK) {
    const int n = (int)(hi - base < SLR_BAND_CHUNK ? hi - base : SLR_BAND_CHUNK);
    __syncthreads();  // the previous chunk is read by every thread
    for (int i = threadIdx.x; i < n; i += SLR_BAND_QT) {
      const size_t p = (size_t)base + i;
      st[i] = make_float4(tc[p], tc[(size_t)Tp + p], tc[2 * (size_t)Tp + p], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float4 t = st[i];
      const float dx = qx - t.x, dy = qy - t.y, dz = qz - t.z;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_pos = (int)base + i;
      }
    }
  }
  if (!active) return;
  const bool hit = qvalid[q] != 0 && best <= r2;  // best finite: best_pos >= 0
  d2_out[q] = hit ? best : CUDART_INF_F;
  idx_out[q] = hit ? tidx[best_pos] : -1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pts_out[3 * (size_t)q + c] = hit ? tc[(size_t)c * Tp + best_pos] : 0.f;
    nrm_out[3 * (size_t)q + c] = hit ? tn[(size_t)c * Tp + best_pos] : 0.f;
  }
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K8: Q sorted queries qc (3, Q) with qvalid (0/1 bytes) against Tp sorted
// targets tc, tn (3, Tp) with original indices tidx, in tiles of tt; the
// band of query tile b is [jstart[b], jend[b]) in target tiles (one entry
// per tile of SLR_BAND_QT queries). Writes d2 (Q), pts, nrm (Q, 3) and idx
// (Q); a query with no valid target within sqrt(r2) gets d2 = inf,
// idx = -1, pts = nrm = 0. Launches on `stream` of `device` and returns
// the launch's error code (0: launched); neither synchronises nor
// allocates.
int slr_band_nn(const float* qc, const uint8_t* qvalid, const float* tc, const float* tn,
                const long long* tidx, const long long* jstart, const long long* jend,
                int Q, int Tp, int tt, float r2, float* d2, float* pts, float* nrm,
                long long* idx, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 0 || Tp < 1 || tt < 1) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const int blocks = (Q + SLR_BAND_QT - 1) / SLR_BAND_QT;
  band_nn_kernel<<<blocks, SLR_BAND_QT, 0, stream>>>(qc, qvalid, tc, tn, tidx, jstart, jend,
                                                     Q, Tp, tt, r2, d2, pts, nrm, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
