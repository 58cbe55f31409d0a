"""MRI noise simulation (sum-of-squares multi-coil / non-central chi).

Counterpart of ``microstructure_fingerprinting_tpu/ops/noise.py``
(reference ``gen_SoS_MRI``, mf_utils.py:2303-2354). Two entry points:
  - ``gen_SoS_MRI``: NumPy RNG, the JAX package's code (global
    ``np.random`` state, same noiseless shortcut);
  - ``gen_sos_mri_torch``: the counterpart of ``gen_sos_mri_jax``. It
    draws from an explicit ``torch.Generator`` where JAX takes a key,
    on the generator's device, which must be ``S0``'s.
"""

import numpy as np
import torch


def _check_sigma(S0_shape, sigma_shape):
    if (len(sigma_shape) > 0 and int(np.prod(sigma_shape)) > 1
            and tuple(S0_shape) != tuple(sigma_shape)):
        raise ValueError('sigma_g should either be a scalar or have '
                         'the shape (%s) of S0 for 1-to-1 '
                         'correspondance. Detected (%s) instead.'
                         % (", ".join("%d" % s for s in S0_shape),
                            ", ".join("%d" % s for s in sigma_shape)))


def gen_SoS_MRI(S0, sigma_g, N=1):
    """Sum-of-squares multi-coil signal: sqrt(sum_i |S0 + eps1 + i eps2|^2).

    ``eps1, eps2 ~ N(0, sigma_g^2)`` independent per coil/channel. The output
    follows a non-central chi distribution (Rician for N=1). ``sigma_g`` can
    be a scalar or an array matching ``S0``; all-zero ``sigma_g`` returns the
    noiseless ``sqrt(N) * S0``.
    """
    if np.all(sigma_g == 0):
        return np.sqrt(N) * S0

    _check_sigma(np.shape(S0), np.shape(sigma_g))

    Y = np.zeros(S0.shape, dtype=np.float64)
    for _ in range(N):
        noise_in_phase = sigma_g * np.random.randn(*S0.shape)
        noise_in_quadrature = sigma_g * np.random.randn(*S0.shape)
        Y = Y + (S0 + noise_in_phase) ** 2 + noise_in_quadrature ** 2
    # reshape guards against broadcasting surprises when sigma_g is (1, 1)
    return np.reshape(np.sqrt(Y), S0.shape)


def gen_sos_mri_torch(generator, S0, sigma_g, N=1):
    """:func:`gen_SoS_MRI` drawing from ``generator``, in ``S0``'s dtype
    on ``S0``'s device (the generator's). Returns a tensor of S0's shape;
    all-zero ``sigma_g`` returns the noiseless ``sqrt(N) * S0``.
    Reproducible for a seeded generator; the draws are not JAX's."""
    S0 = torch.as_tensor(S0)
    sigma_g = torch.as_tensor(sigma_g, dtype=S0.dtype, device=S0.device)
    _check_sigma(S0.shape, sigma_g.shape)
    noise = torch.randn((2, N) + tuple(S0.shape), generator=generator,
                        dtype=S0.dtype, device=S0.device)
    in_phase = S0[None] + sigma_g * noise[0]
    in_quad = sigma_g * noise[1]
    Y = torch.sum(in_phase ** 2 + in_quad ** 2, dim=0)
    noiseless = np.sqrt(float(N)) * S0
    return torch.where(torch.all(sigma_g == 0), noiseless, torch.sqrt(Y))
