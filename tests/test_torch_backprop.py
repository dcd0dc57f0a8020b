"""The port's `backprop_prev_frame` held against the JAX package's train
step on the CPU: the three-frame step of `test_torch_train_extras.py`
(the same tiny flagship, weights, frames and pinned draws) with the
gradient through the previous frames' forwards, their features and their
track queries' embeddings and boxes, as JAX's gradient goes where
`tracking_train_forward` does not stop it. The losses and `grad_norm`
within 1e-4; the gradients against the port's own float64 step by
`gradient_misses` (`test_torch_train_step.py`)."""
import numpy as np
import torch

from test_torch_train_extras import jax_step, port_step, setup  # noqa: F401
from test_torch_train_step import gradient_misses

torch.set_num_threads(1)


def test_backprop_step_matches_jax(setup):  # noqa: F811
    jmetrics, jgrads = jax_step(setup, True)
    metrics, grads = port_step(setup, True)
    _, ref = port_step(setup, True, torch.float64)
    assert set(metrics) == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(metrics[key], want, rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert set(grads) == set(jgrads) == set(ref)
    misses = gradient_misses(grads, jgrads, ref)
    assert misses == [], misses[:5]
