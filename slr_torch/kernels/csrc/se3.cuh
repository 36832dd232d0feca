// 3 x 3 rotations on the card, shared by the kernels that update poses
// (pose_graph.cu, icp.cu): row-major 3 x 3 products, the cross-product
// matrix, and so3_exp with the Taylor branch of slr_torch/geom/se3.py.
// Each function is templated on the scalar where pose_graph.cu also runs it
// on dual numbers.

#pragma once

#include <math.h>

namespace slr {

// C = A B, 3 x 3 row-major; T is float or a dual number
template <typename T>
__device__ __forceinline__ void matmul(const T* A, const T* B, T* C) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c];
}

// y = A x
template <typename T>
__device__ __forceinline__ void matvec(const T* A, const T* x, T* y) {
  for (int r = 0; r < 3; ++r) y[r] = A[3 * r] * x[0] + A[3 * r + 1] * x[1] + A[3 * r + 2] * x[2];
}

// K = hat(w), the cross-product matrix: K x = w x x
template <typename T>
__device__ __forceinline__ void hat(const T* w, T* K, T zero) {
  K[0] = zero, K[1] = -w[2], K[2] = w[1];
  K[3] = w[2], K[4] = zero, K[5] = -w[0];
  K[6] = -w[1], K[7] = w[0], K[8] = zero;
}

// Rodrigues' coefficients of a rotation vector phi, as geom/se3.py's
// so3_exp: theta^2 = |phi|^2, theta = sqrt(theta^2 + 1e-16), a = sin(theta)
// / theta and b = (1 - cos(theta)) / theta^2, each by its Taylor series
// below theta^2 = 1e-8 (`small`).
struct So3Coeffs {
  float theta2, theta, a, b;
  bool small;
};

__device__ __forceinline__ So3Coeffs so3_coeffs(const float* phi) {
  So3Coeffs s;
  s.theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  s.theta = sqrtf(s.theta2 + 1e-16f);
  s.small = s.theta2 < 1e-8f;
  s.a = s.small ? 1.0f - s.theta2 / 6.0f : sinf(s.theta) / s.theta;
  s.b = s.small ? 0.5f - s.theta2 / 24.0f : (1.0f - cosf(s.theta)) / s.theta2;
  return s;
}

// R = so3_exp(phi) = I + a K + b K^2, K = hat(phi)
__device__ __forceinline__ void so3_exp(const float* phi, float* R) {
  const So3Coeffs s = so3_coeffs(phi);
  float K[9], K2[9];
  hat(phi, K, 0.0f);
  matmul(K, K, K2);
  for (int k = 0; k < 9; ++k) R[k] = (k % 4 == 0 ? 1.0f : 0.0f) + s.a * K[k] + s.b * K2[k];
}

}  // namespace slr
