"""Port parity for the fast Walsh-Hadamard transform (ops/fwht, kernel K4):
the plain version, which the wrapper runs for CPU tensors, against a dense
Hadamard matrix, the JAX package's contraction and its Pallas kernel in
interpret mode; the stabilized transform and the doubling merge against the
JAX package's.  The CUDA kernel itself is held against the plain version on
the card (``-m cuda``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fastgaussianprocesses_torch.ops import fwht as tf  # noqa: E402
from fastgaussianprocesses_torch.ops import transforms as ttr  # noqa: E402
from fastgaussianprocesses_tpu.ops import transforms as jtr  # noqa: E402
from fastgaussianprocesses_tpu.ops.pallas_fwht import fwht_pallas  # noqa: E402

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _hadamard(m):
    h = np.array([[1.0]])
    for _ in range(m):
        h = np.block([[h, h], [h, -h]])
    return h


@pytest.mark.parametrize("m", [0, 1, 3, 7, 10])
def test_plain_matches_dense_hadamard_f64(m):
    """Float64 against the dense Sylvester-order matrix: only rounding
    differs, rtol 1e-12 of the max."""
    x = np.random.default_rng(m).standard_normal((3, 1 << m))
    got = tf.fwht(torch.from_numpy(x)).numpy()
    assert _rel(got, x @ _hadamard(m) / math.sqrt(1 << m)) < 1e-12
    # self-inverse
    assert _rel(tf.fwht(tf.fwht(torch.from_numpy(x))).numpy(), x) < 1e-12


@pytest.mark.parametrize("m,R", [(14, 1), (15, 3)])
def test_plain_matches_jax_contraction_and_pallas_f32(m, R):
    """Float32: three evaluations of the same transform that sum in other
    orders (the plain contraction, JAX's XLA contraction and the TPU kernel's
    two +/-1 matmuls in interpret mode), each against float64: within
    8 ulps of the max; the plain version against JAX's also within 8 ulps."""
    n = 1 << m
    x = np.random.default_rng(m).standard_normal((R, n)).astype(np.float32)
    want = np.asarray(jtr.fwht(jnp.asarray(x.astype(np.float64))))
    got = tf.fwht_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    ref = np.asarray(jtr.fwht(jnp.asarray(x)))
    pal = np.asarray(fwht_pallas(jnp.asarray(x), interpret=True))
    for a in (got, ref, pal):
        assert _rel(a, want) < 8 * EPS32
    assert _rel(got, ref) < 8 * EPS32
    # self-inverse in float32: a few ulps of the max
    back = tf.fwht_plain(torch.from_numpy(got)).numpy()
    assert _rel(back, x) < 8 * EPS32


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 8 * EPS32)])
def test_ft_stable_fwht_matches_jax(dtype, tol):
    """The mean-centred transform on rows with a large mean (the DC bin
    carries it back exactly); batch dims are kept."""
    x = (np.random.default_rng(1).standard_normal((2, 3, 1 << 12)) + 5.0).astype(dtype)
    got = ttr.ft_stable_fwht(torch.from_numpy(x)).numpy()
    want = np.asarray(jtr.ft_stable_fwht(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) < tol


def test_merge_doubling_matches_full_transform():
    """[ft(v[:n]), ft(v[n:2n])] merged with omega = 1 equals ft(v[:2n]),
    and equals the JAX package's merge."""
    v = np.random.default_rng(2).standard_normal(1 << 11)
    vt = torch.from_numpy(v)
    n = v.size // 2
    prev, half = ttr.ft_stable_fwht(vt[:n]), ttr.ft_stable_fwht(vt[n:])
    got = ttr.merge_doubling(prev, half, 1.0).numpy()
    assert _rel(got, ttr.ft_stable_fwht(vt).numpy()) < 1e-12
    want = np.asarray(jtr.merge_doubling(jnp.asarray(prev.numpy()), jnp.asarray(half.numpy()),
                                         1.0))
    assert _rel(got, want) < 1e-15


def test_wrapper_takes_plain_path_only_on_cpu():
    """CPU tensors run the plain version and count no launch; a tensor on
    any other non-CUDA device is refused rather than moved; n must be a
    power of two."""
    tf.reset_launches()
    tf.fwht(torch.ones(2, 1 << 10))
    assert tf.launches == {"fwht": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf.fwht(torch.empty(2, 1 << 10, device="meta"))
    with pytest.raises(ValueError, match="power-of-two"):
        tf.fwht(torch.ones(3, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("m", range(0, 23))
def test_kernel_matches_plain_on_card(m):
    """K4 on the card against its plain version at every n = 2^0..2^22 and
    several row counts: float32 within 16 ulps of the max (the butterflies
    sum in another order than the contraction; on the CPU one row differed
    by up to 5.7 ulps at n = 2^16..2^22, and many rows reach further into
    the tail), float64 within 1e-12; repeated launches are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(m)
    for R in ((1, 3) if m > 18 else (1, 3, 37)):
        x = torch.randn(R, 1 << m, generator=g, dtype=torch.float64)
        for dt, tol in ((torch.float32, 16 * EPS32), (torch.float64, 1e-12)):
            xd = x.to(dev, dt)
            tf.reset_launches()
            got = tf.fwht(xd)
            assert tf.launches == {"fwht": 1}
            assert torch.equal(got, tf.fwht(xd))
            assert _rel(got.cpu().numpy(), tf.fwht_plain(x.to(dt)).numpy()) < tol
    # leading batch dims
    x3 = torch.randn(2, 3, 1 << m, generator=g).to(dev)
    assert _rel(tf.fwht(x3).cpu().numpy(), tf.fwht_plain(x3.cpu()).numpy()) < 16 * EPS32


def _np_fwht_inplace(x):
    """Float32 (or float64) radix-2 butterflies, the lowest index bit first,
    then 1/sqrt(n): the order K4 adds in, computed in place."""
    R, n = x.shape
    y, h = x.copy(), 1
    while h < n:
        v = y.reshape(R, -1, 2, h)
        u = v[:, :, 0].copy()
        v[:, :, 0] += v[:, :, 1]
        np.subtract(u, v[:, :, 1], out=v[:, :, 1])
        h *= 2
    return y * x.dtype.type(1.0 / math.sqrt(n))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m", range(0, 23))
def test_kernel_bitwise_equals_numpy_butterflies_on_card(m):
    """Float32 K4 equals the float32 numpy butterfly network bit for bit,
    R = 1, 3 and 37 rows (and 119 at n = 2^20, the query chunk), also when it
    subtracts the row means as it loads (against numpy centring first), and
    on rows that are not 16-byte aligned; float64 within 1e-13 of float64
    numpy."""
    _needs_card()
    g = np.random.default_rng(m)
    for R in (1, 3, 37) + ((119,) if m == 20 else ()):
        x = (g.standard_normal((R, 1 << m)) + 1.5).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        assert np.array_equal(tf.fwht(xd).cpu().numpy(), _np_fwht_inplace(x))
        mu = xd.mean(-1)
        xm = x - mu.cpu().numpy()[:, None]
        assert np.array_equal(tf.fwht(xd, mu).cpu().numpy(), _np_fwht_inplace(xm))
        if R == 3:
            big = torch.from_numpy(np.concatenate([[0.0], x.reshape(-1)]).astype(np.float32))
            xu = big.cuda()[1:].view(R, -1)
            assert np.array_equal(tf.fwht(xu).cpu().numpy(), _np_fwht_inplace(x))
            x64 = x.astype(np.float64)
            got = tf.fwht(torch.from_numpy(x64).cuda()).cpu().numpy()
            assert _rel(got, _np_fwht_inplace(x64)) < 1e-13


@pytest.mark.cuda
def test_card_launch_count_and_graph_replays():
    """One wrapper call is one launch; a CUDA graph that captures ``fwht``
    (two passes at n = 2^20, R = 5) gives the eager call's bits on three
    replays, so the entry point resets its counters each time."""
    _needs_card()
    x = torch.randn(5, 1 << 20, device="cuda")
    tf.reset_launches()
    want = tf.fwht(x)
    assert tf.launches == {"fwht": 1}
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tf.fwht(x)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tf.fwht(x)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_card_path_reaches_neither_plain_nor_emulation(monkeypatch):
    """With the plain version and the emulation made to raise, ``fwht`` and
    ``ft_stable_fwht`` run on the card (one launch each)."""
    _needs_card()

    def refuse(*a, **k):
        raise AssertionError("the card path reached a plain version of K4")

    monkeypatch.setattr(tf, "fwht_plain", refuse)
    monkeypatch.setattr(tf, "fwht_emulate", refuse)
    x = torch.randn(3, 1 << 16, device="cuda")
    tf.reset_launches()
    tf.fwht(x)
    ttr.ft_stable_fwht(x)
    torch.cuda.synchronize()
    assert tf.launches == {"fwht": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("m,R", [(12, 3), (16, 5), (20, 7)])
def test_card_ft_stable_fwht_centres_on_load(m, R):
    """On the card ``ft_stable_fwht`` equals ``fwht(x - mean)`` plus the DC
    bump bit for bit, and no PyTorch subtraction runs over the rows: K4
    subtracts the means as it loads."""
    _needs_card()
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls.append((str(func), [tuple(a.shape) for a in args
                                           if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    x = torch.randn(R, 1 << m, device="cuda") + 3.0
    with Ops() as ops:
        got = ttr.ft_stable_fwht(x)
    xmean = x.mean(-1, keepdim=True)
    want = tf.fwht(x - xmean)
    want[..., 0] += (xmean[..., 0] * math.sqrt(1 << m)).to(want.dtype)
    assert torch.equal(got, want)
    subs = [c for c in ops.calls if "sub" in c[0] and (R, 1 << m) in c[1]]
    assert not subs, subs
