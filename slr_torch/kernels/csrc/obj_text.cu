// The OBJ text of a triangle mesh, formatted on the card.
//
// Replaces no TPU kernel: the JAX package formats its OBJ in Python on the
// host (slr/pipeline/tsdf.py::write_tsdf_mesh_obj), as the port did before
// this kernel. The plain PyTorch version, the same integer arithmetic in
// int64 tensor ops, is slr_torch/kernels/obj_text.py::line_ends_reference
// and write_text_reference.
//
// Contract: N vertices (verts (N, 3) float32, cols (N,) float32 or null)
// and M faces (faces (M, 3) int32) make L = N + M lines, the vertices'
// first:
//   "v {x:.6f} {y:.6f} {z:.6f} {c:.4f} {c:.4f} {c:.4f}\n"  (without cols:
//   "v {x:.6f} {y:.6f} {z:.6f}\n"), then "f {a+1} {b+1} {c+1}\n",
// byte for byte what Python's format(float(x), ".6f") / ".4f" and str()
// print. Two launches: obj_lengths_kernel writes each line's byte count to
// lens[0, L) and stores 1 to lens[L] (zeroed by the caller) when a number
// lies outside the domain below; the caller scans lens into inclusive ends
// and reads the total, and obj_write_kernel writes line i at
// [ends[i - 1], ends[i]) of the text.
//
// Exactness: a float32 x is m * 2^e exactly (m < 2^24). |x| * 10^k is then
// the integer P = m * 10^k (< 2^44) shifted by e: left for e >= 0, exact;
// right for e < 0, rounded half to even on the remainder of the shift, as
// Python rounds the exact binary value; a shift of 63 or more leaves less
// than a half, so 0. No float arithmetic touches a digit. The sign is
// printed whenever the sign bit is set ("-0.000000" for -0.0 and tiny
// negatives, as Python); NaN prints "nan" whatever its sign, infinities
// "inf" / "-inf". Domain: |x| * 10^k < 2^63 (|x| < 9.2e12 at 6 decimals),
// where every step fits in 64 bits; outside it the length pass raises the
// flag and the caller refuses the mesh, so no wrong digit is ever written.
//
// Bounds and design: config 5's mesh (300,618 vertices, 100,206 faces)
// makes ~19 MB of text from ~6.8 MB of inputs, ~26 MB of device traffic,
// 0.008 ms at 3.35 TB/s. The work is ~1.2 M numbers (a vertex's colour
// formatted once and copied), ~11 M digits, each a divide by 10 of a
// 32-bit value (a multiply-high and a shift) unless the value needs more
// bits: tens of millions of instructions, a few microseconds over the
// card's 132 SMs. A thread formats one line into
// shared memory, at its offset within its block's 256 lines (at most
// SLR_OBJ_MAX_LINE bytes each), then the block copies its contiguous run
// of text to device memory with consecutive threads on consecutive bytes,
// so the stores coalesce although lines have ragged lengths. The length
// pass only counts digits, with compares against powers of ten.

#include <cuda_runtime.h>
#include <stdint.h>

#define SLR_OBJ_THREADS 256   // lines per block, one per thread
// the longest line: "v " + 3 * (sign + 13 digits + "." + 6) + 2 spaces
// + 3 * (" " + sign + 15 digits + "." + 4) + "\n"
#define SLR_OBJ_MAX_LINE 134

namespace {

typedef unsigned long long u64;

__host__ __device__ constexpr u64 pow10c(int k) { return k ? 10ull * pow10c(k - 1) : 1ull; }

// |x| * 10^K rounded half to even, exact, with the sign bit and the kind
struct Fixed {
  u64 n;
  int kind;  // 0 finite, 1 nan, 2 inf
  bool neg;
  bool ok;   // inside the domain
};

template <int K>
__device__ __forceinline__ Fixed to_fixed(float x) {
  const unsigned b = __float_as_uint(x);
  Fixed f;
  f.n = 0;
  f.neg = (b >> 31) != 0;
  f.ok = true;
  const int ex = (b >> 23) & 0xff;
  const unsigned man = b & 0x7fffffu;
  if (ex == 0xff) {
    f.kind = man ? 1 : 2;
    return f;
  }
  f.kind = 0;
  const u64 m = ex ? (man | 0x800000u) : man;
  const int e = ex ? ex - 150 : -149;
  const u64 p = m * pow10c(K);
  if (e >= 0) {
    if (e > 62 || p > (0x7fffffffffffffffull >> e)) {
      f.ok = false;
      return f;
    }
    f.n = p << e;
  } else if (e >= -62) {
    const int s = -e;
    const u64 q = p >> s, r = p & ((1ull << s) - 1), half = 1ull << (s - 1);
    f.n = q + ((r > half || (r == half && (q & 1))) ? 1 : 0);
  }
  return f;
}

__device__ __forceinline__ int n_digits(u64 v) {
  int d = 1;
  u64 t = 10;
  while (d < 19 && v >= t) {
    ++d;
    t *= 10;
  }
  return d;
}

template <int K>
__device__ __forceinline__ int fixed_len(const Fixed& f) {
  if (f.kind == 1) return 3;
  if (f.kind == 2) return 3 + f.neg;
  return f.neg + n_digits(f.n / pow10c(K)) + 1 + K;
}

// the d lowest decimal digits of v, the last at o[d - 1]; 64-bit divides
// only while v needs more than 32 bits (an integer part past 4.29e9: a
// fraction, a face index and a millimetre coordinate never do)
__device__ __forceinline__ char* put_digits(char* o, u64 v, int d) {
  int j = d - 1;
  for (; v >> 32; --j) {
    o[j] = (char)('0' + v % 10);
    v /= 10;
  }
  for (unsigned w = (unsigned)v; j >= 0; --j) {
    o[j] = (char)('0' + w % 10);
    w /= 10;
  }
  return o + d;
}

template <int K>
__device__ __forceinline__ char* put_fixed(char* o, const Fixed& f) {
  if (f.kind == 1) {
    o[0] = 'n', o[1] = 'a', o[2] = 'n';
    return o + 3;
  }
  if (f.neg) *o++ = '-';
  if (f.kind == 2) {
    o[0] = 'i', o[1] = 'n', o[2] = 'f';
    return o + 3;
  }
  const u64 ip = f.n / pow10c(K);
  o = put_digits(o, ip, n_digits(ip));
  *o++ = '.';
  return put_digits(o, f.n % pow10c(K), K);
}

// a face's 1-based index a + 1, with its sign
__device__ __forceinline__ int index_len(int a) {
  const long long v = (long long)a + 1;
  return (v < 0) + n_digits(v < 0 ? (u64)(-v) : (u64)v);
}

__device__ __forceinline__ char* put_index(char* o, int a) {
  const long long v = (long long)a + 1;
  if (v < 0) *o++ = '-';
  const u64 mag = v < 0 ? (u64)(-v) : (u64)v;
  return put_digits(o, mag, n_digits(mag));
}

// line i's byte count; *ok false when a number lies outside the domain
__device__ int line_len(const float* __restrict__ verts, const float* __restrict__ cols,
                        const int* __restrict__ faces, long long nv, long long i, bool* ok) {
  if (i < nv) {
    int len = 2 + 2 + 1;  // "v ", two spaces, "\n"
    for (int c = 0; c < 3; ++c) {
      const Fixed f = to_fixed<6>(verts[3 * i + c]);
      *ok = *ok && f.ok;
      len += fixed_len<6>(f);
    }
    if (cols) {
      const Fixed f = to_fixed<4>(cols[i]);
      *ok = *ok && f.ok;
      len += 3 * (1 + fixed_len<4>(f));
    }
    return len;
  }
  const long long j = i - nv;
  int len = 2 + 2 + 1;  // "f ", two spaces, "\n"
  for (int c = 0; c < 3; ++c) len += index_len(faces[3 * j + c]);
  return len;
}

__device__ void put_line(const float* __restrict__ verts, const float* __restrict__ cols,
                         const int* __restrict__ faces, long long nv, long long i, char* o) {
  if (i < nv) {
    *o++ = 'v';
    for (int c = 0; c < 3; ++c) {
      *o++ = ' ';
      o = put_fixed<6>(o, to_fixed<6>(verts[3 * i + c]));
    }
    if (cols) {  // one colour formatted once, then copied twice
      char* c0 = o;
      *o++ = ' ';
      o = put_fixed<4>(o, to_fixed<4>(cols[i]));
      const int n = (int)(o - c0);
      for (int j = 0; j < 2 * n; ++j) o[j] = c0[j % n];
      o += 2 * n;
    }
  } else {
    const long long j = i - nv;
    *o++ = 'f';
    for (int c = 0; c < 3; ++c) {
      *o++ = ' ';
      o = put_index(o, faces[3 * j + c]);
    }
  }
  *o = '\n';
}

__global__ void __launch_bounds__(SLR_OBJ_THREADS)
obj_lengths_kernel(const float* __restrict__ verts, const float* __restrict__ cols,
                   const int* __restrict__ faces, long long nv, long long nf,
                   long long* __restrict__ lens) {
  const long long i = (long long)blockIdx.x * SLR_OBJ_THREADS + threadIdx.x;
  if (i >= nv + nf) return;
  bool ok = true;
  lens[i] = line_len(verts, cols, faces, nv, i, &ok);
  if (!ok) lens[nv + nf] = 1;  // every writer stores the same value
}

__global__ void __launch_bounds__(SLR_OBJ_THREADS)
obj_write_kernel(const float* __restrict__ verts, const float* __restrict__ cols,
                 const int* __restrict__ faces, long long nv, long long nf,
                 const long long* __restrict__ ends, uint8_t* __restrict__ text) {
  __shared__ char buf[SLR_OBJ_THREADS * SLR_OBJ_MAX_LINE];
  const long long first = (long long)blockIdx.x * SLR_OBJ_THREADS;
  const long long last = min(first + SLR_OBJ_THREADS, nv + nf);  // exclusive
  const long long base = first ? ends[first - 1] : 0;
  const long long i = first + threadIdx.x;
  if (i < last) put_line(verts, cols, faces, nv, i, buf + ((i ? ends[i - 1] : 0) - base));
  __syncthreads();
  const int n = (int)(ends[last - 1] - base);
  for (int j = threadIdx.x; j < n; j += SLR_OBJ_THREADS) text[base + j] = (uint8_t)buf[j];
}

}  // namespace

extern "C" {

const char* slr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The length pass: lens[i] for each of the nv + nf lines; lens[nv + nf],
// zeroed by the caller, becomes 1 when a number lies outside the domain.
// cols may be null (no colours). Launches on `stream` of `device` and
// returns the launch's error code (0: launched); neither synchronises nor
// allocates.
int slr_obj_lengths(const float* verts, const float* cols, const int* faces, long long nv,
                    long long nf, long long* lens, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nv < 0 || nf < 0) return (int)cudaErrorInvalidValue;
  const long long L = nv + nf;
  if (L == 0) return (int)cudaSuccess;
  const long long blocks = (L + SLR_OBJ_THREADS - 1) / SLR_OBJ_THREADS;
  obj_lengths_kernel<<<(unsigned)blocks, SLR_OBJ_THREADS, 0, stream>>>(verts, cols, faces, nv,
                                                                        nf, lens);
  return (int)cudaGetLastError();
}

// The write pass: line i at [ends[i - 1], ends[i]) of text (ends: the
// inclusive scan of the length pass's counts). Same launch rules.
int slr_obj_write(const float* verts, const float* cols, const int* faces, long long nv,
                  long long nf, const long long* ends, uint8_t* text, int device,
                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nv < 0 || nf < 0) return (int)cudaErrorInvalidValue;
  const long long L = nv + nf;
  if (L == 0) return (int)cudaSuccess;
  const long long blocks = (L + SLR_OBJ_THREADS - 1) / SLR_OBJ_THREADS;
  obj_write_kernel<<<(unsigned)blocks, SLR_OBJ_THREADS, 0, stream>>>(verts, cols, faces, nv, nf,
                                                                      ends, text);
  return (int)cudaGetLastError();
}

}  // extern "C"
