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
// Bound: both read each input at most once and write each output once, and
// do a few operations per pair and per bin, so they are bound by bytes: K7
// on the merge's pass 1 moves at most 48.5 MB (14.5 us at 3.35 TB/s); K6
// needs a pair's payload only where the pair crosses a bin. The TPU's K x U
// one-hot product existed only because Mosaic had no scatter (and its bf16
// 3-split because Mosaic rejected bf16 dots): neither is carried over.
//
// Design (both kernels):
// - A persistent grid: as many blocks as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, at most R), each
//   walking rows r, r + gridDim.x, ...
// - Rows are staged in shared memory, double-buffered: row r + gridDim.x is
//   in flight while row r is worked on. A staged row lands at the same
//   address modulo 16 as in device memory; its 16-byte-aligned core goes by
//   one bulk copy (TMA, cp.async.bulk) completing on the buffer's mbarrier,
//   and its ragged head and tail (< 16 bytes each, none where a row's
//   length and address are multiples of 16, as in the merge) are copied by
//   threads. A row too wide for two buffers takes one (no prefetch).
// - Per-bin pair ranges: every firing pair u (lo < hi; NaN fails) visits the
//   integer bins k in [0, K) with lo <= k < hi, by the same float comparison
//   the sum uses, and records u in first[k] = min u and last[k] = max u with
//   shared integer atomics. Integer min and max do not depend on the order of
//   the atomics, so the ranges are the same in every run. Then a thread per
//   bin walks u = first[k] .. last[k] in ascending order, tests each pair
//   (inside the range a pair need not fire k, in a wiggly row) and sums the
//   crossings. The work is O(range) a bin: 1-3 pairs on the merge's rows,
//   where a scan of the row's 32-pair chunk summaries took 40-77 tests a bin.
// - No float atomics: each bin is summed by one thread in ascending pair
//   order, so two runs give the same bits; every term is rounded as the
//   plain version rounds it (__fsub_rn, __fdiv_rn, __fadd_rn; a = q_lo - lo *
//   g and A + k * B as the reference's FMAs, the exact product summed in
//   float64 and rounded once to float32 by fma_once). The plain versions sum
//   each bin in the same ascending pair order, so the kernels equal them bit
//   for bit however many crossings a bin has.
// - K7 builds a pair's payload terms only where the pair crosses a bin, from
//   the staged channel rows, into accumulators sized to the channel layout
//   (a template on the channel count and interpolation mask: the merge's
//   layout has T = 6 terms, 45 registers), and divides a bin's sums only
//   where it has two crossings or more (by 1 the division is exact). Once
//   the chunk scan was gone it was bound by instruction issue, not by
//   occupancy: blocks of 512 threads, two an SM (registers); three an SM,
//   forced to 40 registers, were no faster.
// - K6 stages only lo and hi and reads the payload from device memory along
//   the bins' ranges, so the payload of pairs that cross no bin is never
//   read; 4 blocks an SM. Staging each row's payload in shared memory with lo
//   and hi (one block an SM at 5 MP) took 0.1015 ms of device time on the
//   5 MP pass on an H100, against 0.0635 ms for this route (PERF.md), and
//   was dropped.
// - A row too wide for one block's shared memory (about 28,000 pairs at
//   1,024 bins) takes K6 over chunks of its pairs, in order, one launch a
//   chunk of its own build (bin_sum_kernel<true>), each reading its chunk
//   in place (rows ld floats apart). Every chunk after the first starts
//   each bin's sum from the previous chunk's output, so a bin is still one
//   ascending chain of __fadd_rn: the bits of one launch over the row.
//   (Adding the chunks' totals afterwards would round differently.)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SLR_XING_THREADS 256    // K6 block
#define SLR_XING_K6_BLOCKS_PER_SM 4  // K6 at <= 64 registers: 4 blocks an SM
#define SLR_XING_K7_THREADS 512 // K7 block
#define SLR_XING_NGROUP 8       // K6 payload channels summed per walk of a range
#define SLR_XING_MAX_C 8        // K7 channels
#define SLR_XING_MAX_GATES 8
#define SLR_XING_SMEM_MAX 232448
#define SLR_XING_MAX_DEVICES 16

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

// ------------------------------------------------------------ staging

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
// a region that holds a row of `bytes` at any address offset modulo 16
__host__ __device__ inline size_t region(size_t bytes) { return align16(bytes) + 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "SLR_XING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra SLR_XING_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One staged array: a row of `bytes` bytes at `src` in device memory, to the
// 16-byte-aligned region `dst` of shared memory; byte x of device memory
// lands at dst + (x - floor16(src)).
struct Row {
  const char* src;
  char* dst;
  size_t bytes;
};

__device__ __forceinline__ void row_core(const Row& a, uintptr_t* c0, uintptr_t* c1) {
  const uintptr_t s = (uintptr_t)a.src, e = s + a.bytes;
  *c0 = (s + 15) & ~(uintptr_t)15;
  *c1 = e & ~(uintptr_t)15;
  if (*c1 < *c0) *c1 = *c0;
}

// Stage arrays 0 .. n-1 of one row (rows(i): its Row). Thread 0: the
// aligned cores by bulk copy on `bar`, their byte count announced first;
// every thread: its share of the heads and tails, byte by byte (visible to
// the block after its next __syncthreads).
template <typename F>
__device__ void stage_rows(const F& rows, int n, uint64_t* bar) {
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) {
      uintptr_t c0, c1;
      row_core(rows(i), &c0, &c1);
      total += (uint32_t)(c1 - c0);
    }
    mbar_arrive_expect(bar, total);
    for (int i = 0; i < n; ++i) {
      const Row a = rows(i);
      uintptr_t c0, c1;
      row_core(a, &c0, &c1);
      if (c1 > c0) {
        const uintptr_t base = (uintptr_t)a.src & ~(uintptr_t)15;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(a.dst + (c0 - base))),
            "l"((const void*)c0), "r"((uint32_t)(c1 - c0)), "r"(smem_addr(bar))
            : "memory");
      }
    }
  }
  // lanes 0-31 of array i: its head [src, c0); lanes 32-63: its tail [c1, end)
  for (int j = threadIdx.x; j < n * 64; j += blockDim.x) {
    const Row a = rows(j >> 6);
    uintptr_t c0, c1;
    row_core(a, &c0, &c1);
    const uintptr_t s = (uintptr_t)a.src, e = s + a.bytes;
    const int lane = j & 63;
    const uintptr_t x = lane < 32 ? s + lane : c1 + (lane - 32);
    const bool in = lane < 32 ? x < (c0 < e ? c0 : e) : x < e;
    if (in) a.dst[x - (s & ~(uintptr_t)15)] = *(const char*)x;
  }
}

// the arrays of row r in buffer `buf`, for stage_rows
template <typename Rows>
struct RowsAt {
  Rows rows;
  int r;
  char* buf;
  __device__ Row operator()(int i) const { return rows(i, r, buf); }
};

// the staged copy of a row, as an element pointer
template <typename T>
__device__ __forceinline__ const T* staged(const Row& a) {
  return (const T*)(a.dst + ((uintptr_t)a.src & 15));
}

// Record the integer bins pair u fires (lo <= k < hi, k in [0, K)) in
// first[k] = min u, last[k] = max u.
__device__ __forceinline__ void mark_range(float lo, float hi, int u, int K, int* first,
                                           int* last) {
  if (!(lo < hi) || !(lo < (float)K)) return;
  for (int k = lo <= 0.f ? 0 : (int)ceilf(lo); k < K && (float)k < hi; ++k) {
    atomicMin(&first[k], u);
    atomicMax(&last[k], u);
  }
}

// Start a block: first/last empty, the two mbarriers initialised.
__device__ void block_start(char* sm, int* first, int* last, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    first[k] = INT_MAX;
    last[k] = -1;
  }
  if (threadIdx.x == 0) {
    uint64_t* bars = (uint64_t*)sm;
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------ layouts

// Shared memory: two mbarriers, first[K], last[K], then the kernel's own
// arrays, then nbuf row buffers of `stride` bytes.
struct Layout {
  size_t first, last, lo, hi, buf, stride, total;
};

__host__ __device__ inline Layout k7_layout(int U, int C, int K, int nbuf) {
  Layout L;
  size_t o = 16;
  L.first = o;
  o += align16(4 * (size_t)K);
  L.last = o;
  o += align16(4 * (size_t)K);
  L.lo = o;
  o += align16(4 * (size_t)(U - 1));
  L.hi = o;
  o += align16(4 * (size_t)(U - 1));
  L.buf = o;
  // code, valid, C channels
  L.stride = region(4 * (size_t)U) + region((size_t)U) + C * region(4 * (size_t)U);
  L.total = o + nbuf * L.stride;
  return L;
}

__host__ __device__ inline Layout k6_layout(int U, int K, int nbuf) {
  Layout L;
  size_t o = 16;
  L.first = o;
  o += align16(4 * (size_t)K);
  L.last = o;
  o += align16(4 * (size_t)K);
  L.lo = L.hi = 0;
  L.buf = o;
  // lo, hi
  L.stride = 2 * region(4 * (size_t)U);
  L.total = o + nbuf * L.stride;
  return L;
}

// ------------------------------------------------------------ K6

// K6's staged arrays of row r in buffer `buf`: 0 lo, 1 hi; U pairs of a
// row, rows ld floats apart.
struct K6Rows {
  const float *lo, *hi;
  int U, ld;
  __device__ Row operator()(int i, int r, char* buf) const {
    const size_t bytes = 4 * (size_t)U;
    return {(const char*)((i == 0 ? lo : hi) + (size_t)r * ld), buf + i * region(bytes), bytes};
  }
};

// CHUNKED: a chunk of U pairs of rows ld floats apart, each bin's sum
// started from out's value where accumulate is set; else whole contiguous
// rows (ld == U) summed from 0, the one-launch build, whose registers the
// chunking leaves as they were (64, no spills).
template <bool CHUNKED>
__global__ void __launch_bounds__(SLR_XING_THREADS, SLR_XING_K6_BLOCKS_PER_SM)
bin_sum_kernel(const float* __restrict__ lo_g, const float* __restrict__ hi_g,
               const float* __restrict__ pay, int R, int U, int ld_arg, int N, int K, int nbuf,
               int accumulate_arg, float* __restrict__ out) {
  const int ld = CHUNKED ? ld_arg : U;
  const bool accumulate = CHUNKED && accumulate_arg;
  extern __shared__ __align__(16) char sm[];
  const Layout L = k6_layout(U, K, nbuf);
  uint64_t* bars = (uint64_t*)sm;
  int* first = (int*)(sm + L.first);
  int* last = (int*)(sm + L.last);
  block_start(sm, first, last, K);
  const K6Rows rows{lo_g, hi_g, U, ld};
  const int na = 2;
  char* const buf0 = sm + L.buf;
  const size_t stride = L.stride;
  stage_rows(RowsAt<K6Rows>{rows, (int)blockIdx.x, buf0}, na, &bars[0]);
  int it = 0;
  for (int r = blockIdx.x; r < R; r += gridDim.x, ++it) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    const uint32_t parity = nbuf == 2 ? ((it >> 1) & 1) : (it & 1);
    if (nbuf == 2 && r + (int)gridDim.x < R)
      stage_rows(RowsAt<K6Rows>{rows, r + (int)gridDim.x, buf0 + (b ^ 1) * stride}, na,
                 &bars[b ^ 1]);
    char* buf = buf0 + b * stride;
    mbar_wait(&bars[b], parity);
    __syncthreads();
    const float* lo = staged<float>(rows(0, r, buf));
    const float* hi = staged<float>(rows(1, r, buf));

    for (int u = threadIdx.x; u < U; u += blockDim.x) mark_range(lo[u], hi[u], u, K, first, last);
    __syncthreads();

    float* o = out + (size_t)r * N * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float kf = (float)k;
      const int u0 = first[k], u1 = last[k];
      first[k] = INT_MAX;
      last[k] = -1;
      for (int n0 = 0; n0 < N; n0 += SLR_XING_NGROUP) {
        const float* p[SLR_XING_NGROUP];
        float acc[SLR_XING_NGROUP];
#pragma unroll
        for (int j = 0; j < SLR_XING_NGROUP; ++j) {
          const int n = n0 + j < N ? n0 + j : N - 1;
          acc[j] = accumulate ? o[(size_t)n * K + k] : 0.f;
          p[j] = pay + ((size_t)r * N + n) * ld;
        }
        for (int u = u0; u <= u1; ++u) {
          if (lo[u] <= kf && kf < hi[u]) {
#pragma unroll
            for (int j = 0; j < SLR_XING_NGROUP; ++j)
              if (n0 + j < N) acc[j] = __fadd_rn(acc[j], p[j][u]);
          }
        }
#pragma unroll
        for (int j = 0; j < SLR_XING_NGROUP; ++j)
          if (n0 + j < N) o[(size_t)(n0 + j) * K + k] = acc[j];
      }
    }
    __syncthreads();
    if (nbuf == 1 && r + (int)gridDim.x < R)
      stage_rows(RowsAt<K6Rows>{rows, r + (int)gridDim.x, buf0}, na, &bars[0]);
  }
}

// ------------------------------------------------------------ K7

// K7's staged arrays of row r in buffer `buf`: 0 code, 1 valid, 2 + c
// channel c.
struct K7Rows {
  const float* code;
  const uint8_t* valid;
  const float* chans;
  int R, U;
  __device__ Row operator()(int i, int r, char* buf) const {
    const size_t cb = region(4 * (size_t)U), vb = region((size_t)U);
    const size_t row = (size_t)r * U;
    if (i == 0) return {(const char*)(code + row), buf, 4 * (size_t)U};
    if (i == 1) return {(const char*)(valid + row), buf + cb, (size_t)U};
    return {(const char*)(chans + (size_t)(i - 2) * R * U + row), buf + cb + vb + (i - 2) * cb,
            4 * (size_t)U};
  }
};

// C channels, bit c of MASK: channel c is interpolated (else its left
// pixel's value is carried). MASK < 0: C is an upper bound, and the runtime
// (nc_rt, interp_mask) hold the layout.
template <int C, int MASK>
__global__ void __launch_bounds__(SLR_XING_K7_THREADS)
interp_fused_kernel(const float* __restrict__ code, const uint8_t* __restrict__ valid,
                    const float* __restrict__ chans, int R, int U, int nc_rt, int K,
                    int interp_mask, Gates gates, float dmin, float dmax, int nbuf,
                    float* __restrict__ cnt_out, float* __restrict__ vals_out) {
  extern __shared__ __align__(16) char sm[];
  const int nc = MASK >= 0 ? C : nc_rt;
  const int im = MASK >= 0 ? MASK : interp_mask;
  const int np = U - 1;
  const Layout L = k7_layout(U, nc, K, nbuf);
  uint64_t* bars = (uint64_t*)sm;
  int* first = (int*)(sm + L.first);
  int* last = (int*)(sm + L.last);
  float* lo = (float*)(sm + L.lo);
  float* hi = (float*)(sm + L.hi);
  block_start(sm, first, last, K);
  const K7Rows rows{code, valid, chans, R, U};
  char* const buf0 = sm + L.buf;
  const size_t stride = L.stride;
  stage_rows(RowsAt<K7Rows>{rows, (int)blockIdx.x, buf0}, 2 + nc, &bars[0]);
  int it = 0;
  for (int r = blockIdx.x; r < R; r += gridDim.x, ++it) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    const uint32_t parity = nbuf == 2 ? ((it >> 1) & 1) : (it & 1);
    if (nbuf == 2 && r + (int)gridDim.x < R)
      stage_rows(RowsAt<K7Rows>{rows, r + (int)gridDim.x, buf0 + (b ^ 1) * stride}, 2 + nc,
                 &bars[b ^ 1]);
    char* buf = buf0 + b * stride;
    mbar_wait(&bars[b], parity);
    __syncthreads();
    const float* crow = staged<float>(rows(0, r, buf));
    const uint8_t* vrow = staged<uint8_t>(rows(1, r, buf));

    // the row's pairs: validity, codes (-1 where invalid), bin ranges
    for (int u = threadIdx.x; u < np; u += blockDim.x) {
      const float cl = crow[u], ch = crow[u + 1];
      const float d = __fsub_rn(ch, cl);
      bool pv = vrow[u] != 0 && vrow[u + 1] != 0 && d > dmin && d < dmax;
#pragma unroll
      for (int i = 0; i < SLR_XING_MAX_GATES; ++i) {
        if (i >= gates.n) break;
        const float* q = staged<float>(rows(2 + gates.ch[i], r, buf));
        pv = pv && fabsf(__fsub_rn(q[u + 1], q[u])) < gates.thr[i];
      }
      lo[u] = pv ? cl : -1.f;
      hi[u] = pv ? ch : -1.f;
      if (pv) mark_range(cl, ch, u, K, first, last);
    }
    __syncthreads();

    const float* q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = staged<float>(rows(2 + (c < nc ? c : 0), r, buf));
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float kf = (float)k;
      const int u0 = first[k], u1 = last[k];
      first[k] = INT_MAX;
      last[k] = -1;
      float n = 0.f, acc_a[C], acc_g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc_a[c] = acc_g[c] = 0.f;
      for (int u = u0; u <= u1; ++u) {
        const float cl = lo[u], ch = hi[u];
        if (!(cl <= kf && kf < ch)) continue;
        n = __fadd_rn(n, 1.f);
        const float d = __fsub_rn(ch, cl);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c >= nc) break;
          const float q_lo = q[c][u];
          if ((im >> c) & 1) {
            const float g = __fdiv_rn(__fsub_rn(q[c][u + 1], q_lo), d);
            acc_a[c] = __fadd_rn(acc_a[c], fma_once(-cl, g, q_lo));
            acc_g[c] = __fadd_rn(acc_g[c], g);
          } else {
            acc_a[c] = __fadd_rn(acc_a[c], q_lo);
          }
        }
      }
      cnt_out[(size_t)r * K + k] = n;
      // (A + k B) / max(n, 1e-9): with no crossing every sum is +0 and so is
      // the value; with one, the division by 1 is exact and is skipped
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        float v = 0.f;
        if (n > 0.f) {
          v = ((im >> c) & 1) ? fma_once(kf, acc_g[c], acc_a[c]) : acc_a[c];
          if (n > 1.f) v = __fdiv_rn(v, n);
        }
        vals_out[(size_t)c * R * K + (size_t)r * K + k] = v;
      }
    }
    __syncthreads();
    if (nbuf == 1 && r + (int)gridDim.x < R)
      stage_rows(RowsAt<K7Rows>{rows, r + (int)gridDim.x, buf0}, 2 + nc, &bars[0]);
  }
}

// ------------------------------------------------------------ launching

int sm_count(int device) {
  static int sms[SLR_XING_MAX_DEVICES];
  if (!sms[device]) cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  return sms[device];
}

// Make `device` current, calling cudaSetDevice only when it is not.
cudaError_t use_device(int device) {
  if (device < 0 || device >= SLR_XING_MAX_DEVICES) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// One launch: the kernel, its row buffers, shared memory and grid.
struct Plan {
  const void* fn;
  int threads, nbuf, grid, per_sm;
  size_t smem;
};

// The dynamic shared memory each kernel build was granted so far, per device.
size_t k6_granted[2][SLR_XING_MAX_DEVICES], k7_granted[2][SLR_XING_MAX_DEVICES];

// Blocks an SM of the plans asked so far, by kernel build, device, block and
// shared memory: asked of the runtime once, not at every launch (the query
// cost a K6 build with a stack frame measurable host time a launch;
// PERF.md).
struct Occupancy {
  const void* fn;
  int device, threads;
  size_t smem;
  int per_sm;
};
Occupancy occupancy_seen[64];
int n_occupancy_seen = 0;

cudaError_t blocks_per_sm(Plan* p, int device) {
  for (int i = 0; i < n_occupancy_seen; ++i) {
    const Occupancy& o = occupancy_seen[i];
    if (o.fn == p->fn && o.device == device && o.threads == p->threads && o.smem == p->smem) {
      p->per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, p->fn, p->threads, p->smem);
  if (err == cudaSuccess && n_occupancy_seen < 64)
    occupancy_seen[n_occupancy_seen++] = {p->fn, device, p->threads, p->smem, p->per_sm};
  return err;
}

// Grid of a persistent launch: the blocks that fit on the card at once, at
// most R. Sets the kernel's shared-memory attribute only when a size above
// what it was granted is asked for.
cudaError_t persistent_grid(Plan* p, size_t* granted, int device, int R) {
  if (p->smem > SLR_XING_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (p->smem > 48 * 1024 && p->smem > granted[device]) {
    err = cudaFuncSetAttribute(p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p->smem);
    if (err != cudaSuccess) return err;
    granted[device] = p->smem;
  }
  err = blocks_per_sm(p, device);
  if (err != cudaSuccess) return err;
  if (p->per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long g = (long long)p->per_sm * sm_count(device);
  p->grid = (int)(g < R ? g : R);
  return cudaSuccess;
}

// One buffer (no prefetch) when two do not fit a block.
int k7_buffers(int U, int C, int K) {
  return k7_layout(U, C, K, 2).total <= SLR_XING_SMEM_MAX ? 2 : 1;
}

int k6_buffers(int U, int K) { return k6_layout(U, K, 2).total <= SLR_XING_SMEM_MAX ? 2 : 1; }

cudaError_t k6_plan(int R, int U, int K, bool chunked, int device, Plan* p) {
  p->fn = chunked ? (const void*)bin_sum_kernel<true> : (const void*)bin_sum_kernel<false>;
  p->threads = SLR_XING_THREADS;
  p->nbuf = k6_buffers(U, K);
  p->smem = k6_layout(U, K, p->nbuf).total;
  return persistent_grid(p, k6_granted[chunked ? 1 : 0], device, R);
}

// the merge's layout (u, y interpolated; quality, white carried: T = 6
// terms) has its own instantiation; any other takes the general one
bool merge_layout(int C, int interp_mask) { return C == 4 && interp_mask == 3; }

cudaError_t k7_plan(int R, int U, int C, int K, int interp_mask, int device, Plan* p) {
  const bool merge = merge_layout(C, interp_mask);
  p->fn = merge ? (const void*)interp_fused_kernel<4, 3>
                : (const void*)interp_fused_kernel<SLR_XING_MAX_C, -1>;
  p->threads = SLR_XING_K7_THREADS;
  p->nbuf = k7_buffers(U, C, K);
  p->smem = k7_layout(U, C, K, p->nbuf).total;
  return persistent_grid(p, k7_granted[merge ? 1 : 0], device, R);
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory (bytes) a K6 block needs for U pairs and K bins; two row
// buffers where they fit.
long long slr_bin_sum_smem(int U, int K) {
  return (long long)k6_layout(U, K, k6_buffers(U, K)).total;
}

// Shared memory (bytes) a K7 block needs for U codes, C channels and K bins.
long long slr_interp_fused_smem(int U, int C, int K) {
  return (long long)k7_layout(U, C, K, k7_buffers(U, C, K)).total;
}

// The grid and the blocks an SM of a launch of K6 (kernel 6; n, interp_mask
// unused) or K7 (kernel 7: n channels, interp_mask) at these sizes on
// `device`, to *grid and *per_sm. Returns an error code (0: success).
int slr_crossing_launch_shape(int kernel, int R, int U, int n, int K, int interp_mask,
                              int device, int* grid, int* per_sm) {
  if (R < 1 || U < 1 || K < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err;
  if (kernel == 6)
    err = k6_plan(R, U, K, false, device, &p);
  else if (kernel == 7 && U >= 2 && n >= 1 && n <= SLR_XING_MAX_C)
    err = k7_plan(R, U, n, K, interp_mask, device, &p);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  *grid = p.grid;
  *per_sm = p.per_sm;
  return (int)cudaSuccess;
}

// K6: lo, hi (R, U) and payload (R, N, U), float32, rows ld >= U floats
// apart (ld == U: contiguous; ld > U: a chunk of U pairs of wider rows) ->
// out (R, N, K), contiguous. accumulate: each bin's sum starts from out's
// value (the previous chunk's sum, so a row's chunks in order make the one
// ascending chain of float adds that one launch over the row makes), else
// from 0. Launches on `stream` of `device` and returns the launch's error
// code (0: launched); neither synchronises nor allocates.
int slr_crossing_bin_sum(const float* lo, const float* hi, const float* payload, int R, int U,
                         int ld, int N, int K, int accumulate, float* out, int device,
                         cudaStream_t stream) {
  if (R < 0 || U < 1 || ld < U || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || K == 0) return (int)cudaSuccess;
  const bool chunked = ld != U || accumulate;
  Plan p;
  cudaError_t err = k6_plan(R, U, K, chunked, device, &p);
  if (err != cudaSuccess) return (int)err;
  if (chunked)
    bin_sum_kernel<true><<<p.grid, p.threads, p.smem, stream>>>(lo, hi, payload, R, U, ld, N, K,
                                                                p.nbuf, accumulate, out);
  else
    bin_sum_kernel<false><<<p.grid, p.threads, p.smem, stream>>>(lo, hi, payload, R, U, ld, N, K,
                                                                 p.nbuf, accumulate, out);
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
  if (R < 0 || U < 2 || C < 1 || C > SLR_XING_MAX_C || K < 0 || n_gates < 0 ||
      n_gates > SLR_XING_MAX_GATES)
    return (int)cudaErrorInvalidValue;
  Gates gates = {};
  gates.n = n_gates;
  for (int i = 0; i < n_gates; ++i) {
    if (gate_ch[i] < 0 || gate_ch[i] >= C) return (int)cudaErrorInvalidValue;
    gates.ch[i] = gate_ch[i];
    gates.thr[i] = gate_thr[i];
  }
  if (R == 0 || K == 0) return (int)cudaSuccess;
  Plan p;
  cudaError_t err = k7_plan(R, U, C, K, interp_mask, device, &p);
  if (err != cudaSuccess) return (int)err;
  if (merge_layout(C, interp_mask))
    interp_fused_kernel<4, 3><<<p.grid, p.threads, p.smem, stream>>>(
        code, valid, channels, R, U, C, K, interp_mask, gates, dmin, dmax, p.nbuf, cnt, vals);
  else
    interp_fused_kernel<SLR_XING_MAX_C, -1><<<p.grid, p.threads, p.smem, stream>>>(
        code, valid, channels, R, U, C, K, interp_mask, gates, dmin, dmax, p.nbuf, cnt, vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
