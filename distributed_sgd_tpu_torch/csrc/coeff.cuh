// Per-sample gradient coefficient of the linear models, the one device
// definition shared by worker_grads.cu and sync_epoch.cu.
//
// coeff_kind: 0 hinge, 1 logistic, 2 least squares.  Each matches the
// port's plain rule in ops/coeff.py::builtin_rule.
//
// A model's own rule (ops/coeff.py, kind 3) is compiled into a variant of
// each kernel: ops/_build.py defines DSGD_USER_COEFF and puts the header
// generated from the model's coeff_cuda on the include path.  Its
// dsgd_user_coeff(m, y) is then the only rule of that library, whatever
// the kind.  Without the macro the built-in kinds compile as before.

#pragma once

constexpr int kUserCoeff = 3;  // ops/coeff.py::USER

#ifdef DSGD_USER_COEFF
#include "dsgd_user_coeff.cuh"

__device__ __forceinline__ float grad_coeff(int, float m, float y) {
  return dsgd_user_coeff(m, y);
}
#else
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
#endif
