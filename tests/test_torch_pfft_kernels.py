"""Port parity for kernels K1 and K2's two-launch algorithm (ops/perm_fft
``pfft_emulate``, ``pifft_real_emulate`` and ``pifft_emulate``: pass A as a
length-A FFT, the
slab DFT as Stockham passes, and the scatter from the kernels' split to the
permuted bin order, ``slab_scatter_index``) against float64 numpy and the
JAX package's ``pallas_fft.pfft`` / ``pifft_real`` (interpret mode), with
the JAX package's tolerance (3e-6 of the max, tests/test_pallas_fft.py).
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_perm_fft.py) and, below, against numpy with the
plain versions and the emulation made to raise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.ops import perm_fft as tp  # noqa: E402
from fastgaussianprocesses_tpu.ops import pallas_fft as pf  # noqa: E402

torch.set_num_threads(2)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _rows(n, R, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, n)) + 2.0
    if kind == "complex":
        x = x + 1j * rng.standard_normal((R, n))
    return x


def _torch(a, dtype):
    """numpy -> torch in ``dtype`` (float32/float64), complex where ``a`` is."""
    t = torch.from_numpy(a)
    if t.is_complex():
        return t.to(torch.complex64 if dtype == torch.float32 else torch.complex128)
    return t.to(dtype)


@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-6), (torch.float64, 1e-12)])
def test_emulation_matches_numpy_and_jax(n, kind, dtype, tol):
    """K1's and K2's algorithms against float64 numpy: float32 at the JAX
    package's tolerance, float64 to 1e-12; in float32 also against the JAX
    package's Pallas ``pfft`` and ``pifft_real`` on the same inputs.  K2 runs
    on the exact spectrum, so its output is the row's real part, or with
    complex output (``pifft_emulate``) the row itself."""
    x = _rows(n, 3, kind)
    perm = tp.spectrum_perm(n)
    spec = np.fft.fft(x, axis=-1)[:, perm]
    got = tp.pfft_emulate(_torch(x, dtype), n).numpy()
    assert got.shape == (3, n) and _rel(got, spec) < tol
    back = tp.pifft_real_emulate(_torch(spec, dtype), n).numpy()
    assert back.shape == (3, n) and back.dtype == (np.float32 if dtype == torch.float32 else np.float64)
    assert _rel(back, x.real) < tol
    assert _rel(tp.pifft_emulate(_torch(spec, dtype), n).numpy(), x) < tol
    if dtype == torch.float32:
        x32 = x.astype(np.complex64 if kind == "complex" else np.float32)
        assert _rel(got, np.asarray(pf.pfft(jnp.asarray(x32), n))) < 3e-6
        ref = np.asarray(pf.pifft_real(jnp.asarray(spec.astype(np.complex64)), n))
        assert _rel(back, ref) < 3e-6


@pytest.mark.parametrize("n", [1 << 19, 1 << 20, 1 << 21])
def test_emulation_where_splits_differ(n):
    """One float32 row at the sizes where the kernels' split (A = 128, 256,
    256) is not ``_plan``'s (A = 64, 64, 128), so the scatter between the
    two matters: K1 on a real row and K2 on its exact spectrum against
    float64 numpy."""
    x = _rows(n, 1, "real", seed=1)
    spec = np.fft.fft(x, axis=-1)[:, tp.spectrum_perm(n)]
    assert tp._slab_plan(n)[0] > tp._plan(n)[0]
    assert _rel(tp.pfft_emulate(_torch(x, torch.float32), n).numpy(), spec) < 3e-6
    assert _rel(tp.pifft_real_emulate(_torch(spec, torch.float32), n).numpy(), x) < 3e-6


@pytest.mark.parametrize("m", range(14, 23))
def test_scatter_index_matches_spectrum_perm(m):
    """The kernels' scatter (bin k1 + A*k2 of their split to its permuted
    position) is the inverse of ``spectrum_perm`` in the kernels' bin order,
    at every supported n; and every slab's bins fall into runs of 128
    contiguous positions (kl = 0..127 at k2 = g + G*kl), which K1 writes and
    K2 reads whole."""
    n = 1 << m
    A, B = tp._slab_plan(n)
    k = np.arange(A)[:, None] + A * np.arange(B)[None, :]
    idx = tp.slab_scatter_index(n)
    assert np.array_equal(idx, np.argsort(tp.spectrum_perm(n))[k.reshape(-1)])
    runs = idx.reshape(A, 128, B // 128)                    # [k1, kl, g]
    assert (np.diff(runs, axis=1) == 1).all()
    assert (runs[:, 0, :] % 128 == 0).all()


@pytest.mark.cuda
def test_card_ops_never_reach_plain_or_emulation(monkeypatch):
    """On the card ``pfft``, ``pifft_real`` and ``pifft`` are the kernels'
    launches alone: with the plain versions and the emulation made to raise,
    and every PyTorch operator of the call recorded, no matmul, einsum or FFT
    runs, and the ops agree with float64 numpy (3e-6 of the max; the round
    trip within 2e-5) at n = 2^15, 2^20 and 2^21, on real and complex rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    def refuse(*a, **k):
        raise AssertionError("the card path reached a plain version of K1/K2")

    for name in ("pfft_plain", "pifft_real_plain", "pifft_plain", "passb_plain",
                 "passb_inv_plain", "_pass_a", "pfft_emulate", "pifft_real_emulate",
                 "pifft_emulate", "pass_a_emulate", "slab_dft"):
        monkeypatch.setattr(tp, name, refuse)
    tp.reset_launches()
    calls = 0
    for n, R in [(1 << 15, 2), (1 << 20, 1), (1 << 21, 1)]:
        for kind in ("real", "complex"):
            x = _rows(n, R, kind)
            xt = _torch(x, torch.float32).cuda()
            with Ops() as ops:
                got = tp.pfft(xt, n)
                back = tp.pifft_real(got, n)
                back_c = tp.pifft(got, n)
            torch.cuda.synchronize()
            calls += 1
            bad = [o for o in ops.names if o.split(".")[1] in ("mm", "bmm", "addmm", "matmul", "einsum")
                   or "fft" in o]
            assert not bad, bad
            spec = np.fft.fft(x, axis=-1)[:, tp.spectrum_perm(n)]
            assert _rel(got.cpu().numpy(), spec) < 3e-6
            if kind == "real":
                assert np.abs(back.cpu().numpy() - x).max() < 2e-5
            else:
                assert _rel(back.cpu().numpy(), x.real) < 3e-6
            assert np.abs(back_c.cpu().numpy() - x).max() < 2e-5
    assert tp.launches["pfft"] == calls and tp.launches["pifft_real"] == calls
    assert tp.launches["pifft"] == calls
