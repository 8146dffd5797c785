"""optax's Adam (``optax.adam``: ``scale_by_adam``, then the learning rate)
in float32 numpy, one step at a time, with its bias corrections in float32
as optax computes them. The port's Adam on the card (capturable: its step
count and bias corrections on the device, in float32) is held to it in
``test_torch_port_cuda.py``, which imports no JAX;
``test_torch_port_graph.py`` holds it against optax itself.
"""

import numpy as np

F32 = np.float32


def optax_adam(params, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The parameters after each step of Adam from ``params`` over
    ``grads`` (one float32 array a step)."""
    p = np.asarray(params, F32).copy()
    mu, nu = np.zeros_like(p), np.zeros_like(p)
    out = []
    for count, g in enumerate(grads, 1):
        g = np.asarray(g, F32)
        mu = F32(1 - b1) * g + F32(b1) * mu
        nu = F32(1 - b2) * (g * g) + F32(b2) * nu
        mu_hat = mu / (F32(1) - F32(b1) ** F32(count))
        nu_hat = nu / (F32(1) - F32(b2) ** F32(count))
        p = p + F32(-lr) * (mu_hat / (np.sqrt(nu_hat) + F32(eps)))
        out.append(p.copy())
    return out
