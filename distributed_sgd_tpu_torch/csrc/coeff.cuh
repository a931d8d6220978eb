// Per-sample gradient coefficient of the linear models, the one device
// definition shared by worker_grads.cu and sync_epoch.cu.
//
// coeff_kind: 0 hinge, 1 logistic, 2 least squares.  Each matches the
// port's plain rule in ops/worker_grads.py::grad_coeff.

#pragma once

__device__ __forceinline__ float grad_coeff(int kind, float m, float y) {
  if (kind == 0) {
    // backward = 0 if y*(x.w) < 0 else y  (reference hinge subgradient)
    return (y * m < 0.f) ? 0.f : y;
  }
  if (kind == 1) {
    // -y * sigmoid(-y m) = -y / (1 + exp(y m))
    return -y / (1.f + expf(y * m));
  }
  return 2.f * (m - y);
}
