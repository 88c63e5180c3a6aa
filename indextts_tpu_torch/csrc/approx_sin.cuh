// approx_sin of the JAX package (indextts_tpu/ops/activations.py; the port's
// copy is ops/activations.py:approx_sin): round-half-even range reduction to
// [-pi, pi], then an odd degree-9 polynomial, max abs error 3.6e-5. The one
// definition the activation kernels (K1, K2, K3) share.
#pragma once

__device__ __forceinline__ float poly_sin(float u) {
  const float k = rintf(u * 0.15915494309189535f);
  const float r = u - k * 6.283185307179586f;
  const float r2 = r * r;
  const float p = 9.9999728997e-01f +
                  r2 * (-1.6665146137e-01f +
                        r2 * (8.3198438631e-03f + r2 * (-1.9424185428e-04f + r2 * 2.2248903691e-06f)));
  return r * p;
}
