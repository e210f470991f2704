"""Port parity for the Rprop optimizer (fit/rprop.py) against the JAX
package's, exactly, in float64: fixed random gradient sequences whose signs
persist long enough to reach the step-size ceiling, flip often enough to
reach the floor, and hit zero, with an untrainable parameter."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.fit import rprop as tr  # noqa: E402
from fastgaussianprocesses_tpu.fit import rprop as jr  # noqa: E402

SHAPES = {"scale": (1,), "lengthscales": (5,), "noise": (1,), "factor_task_kernel": (2, 3)}


def _grads(rng, step):
    """Gradient dict for one step: lengthscale 0 keeps its sign (step size up
    to 50), lengthscale 1 alternates (down to 1e-6), some entries are 0."""
    g = {k: rng.standard_normal(s) for k, s in SHAPES.items()}
    g["lengthscales"][0] = abs(g["lengthscales"][0]) + 0.1
    g["lengthscales"][1] = (-1.0) ** step * (abs(g["lengthscales"][1]) + 0.1)
    g["lengthscales"][2] *= rng.random() < 0.5
    g["factor_task_kernel"][0, 0] = 0.0
    return g


@pytest.mark.parametrize("seed", [0, 1])
def test_rprop_update_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s) for k, s in SHAPES.items()}
    trainable = {"scale": True, "lengthscales": True, "noise": False, "factor_task_kernel": True}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    st, sj = tr.rprop_init(pt, lr=0.1), jr.rprop_init(pj, lr=0.1)
    for step in range(60):
        g = _grads(rng, step)
        pt, st = tr.rprop_update({k: torch.from_numpy(v) for k, v in g.items()}, st, pt,
                                 trainable)
        pj, sj = jr.rprop_update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj, trainable)
        for k in SHAPES:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]), err_msg=k)
            np.testing.assert_array_equal(st.step_sizes[k].numpy(),
                                          np.asarray(sj.step_sizes[k]), err_msg=k)
            np.testing.assert_array_equal(st.prev_grad[k].numpy(),
                                          np.asarray(sj.prev_grad[k]), err_msg=k)
    ss = st.step_sizes["lengthscales"].numpy()
    assert ss[0] == 50.0 and ss[1] == 1e-6
    np.testing.assert_array_equal(pt["noise"].numpy(), params["noise"])
