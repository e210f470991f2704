"""Device meshes, sharding descriptors, the data-parallel fleet step and the
sequence-sharded transforms (counterpart of
``fastgaussianprocesses_tpu/parallel/mesh.py``).

One process a card: a mesh is a ``torch.distributed`` ``DeviceMesh`` over
the ranks, and a tensor sharded over one of its axes is held by each rank as
a plain local tensor, its own block.  Where the JAX package lets GSPMD insert
the collectives, the code here says where each one goes (``parallel/comm``):

* ``batch``  -- data parallelism over the members of a ``shape_batch``
  fleet: every rank fits its own members, and only the gradients of the
  replicated parameters and the loss's value cross ranks
  (:func:`make_sharded_fit_step`), also beside ``seq`` in a 2-D mesh;
* ``chains`` -- HMC chains (``fit/hmc.hmc(chain_sharding=...)``), also
  beside ``seq`` in a 2-D mesh (``sample_gp_hyperposterior``);
* ``seq``    -- the transform axis n (``use_sequence_sharding`` on the fast
  models): rank c holds points ``[c L, (c + 1) L)``, L = n / D, and the
  transforms below return its block of the output, one ``reduce_scatter`` a
  transform.
"""

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.bitops import bit_reverse_permutation, log2_int
from . import comm


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


_MESHES = {}


def make_mesh(axis_sizes: dict, devices=None):
    """A ``DeviceMesh`` from ``{axis_name: size}`` over the ranks ``devices``
    (default: every rank of the default group); ``-1`` means "the remaining
    ranks".  Every rank of the default group must call it (it creates
    process groups); over a subset, the ranks outside it get a mesh whose
    groups they are not in.  Meshes are cached per default group, axes and
    ranks, so that a repeated call makes no new communicators."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    total = dist.get_world_size() if devices is None else len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = total // known
    used = int(np.prod(sizes))
    ranks = tuple(range(total)) if devices is None else tuple(int(r) for r in devices)
    key = (id(dist.group.WORLD), names, tuple(sizes), ranks[:used])
    if key not in _MESHES:
        if devices is None and used == total:
            mesh = init_device_mesh(_device_type(), tuple(sizes), mesh_dim_names=names)
        else:
            mesh = DeviceMesh(_device_type(), torch.tensor(ranks[:used]).reshape(sizes),
                              mesh_dim_names=names)
        _MESHES[key] = mesh
    return _MESHES[key]


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_rank(mesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank along ``axis`` (None for a size-1 axis:
    no collective is then needed)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


class Sharding(NamedTuple):
    """Where a tensor lives: split along ``dim`` over the mesh axis ``axis``,
    or replicated (``axis`` None).  The counterpart of a NamedSharding."""
    mesh: object
    axis: str = None
    dim: int = 0

    @property
    def size(self) -> int:
        return 1 if self.axis is None else axis_size(self.mesh, self.axis)

    @property
    def rank(self) -> int:
        return 0 if self.axis is None else axis_rank(self.mesh, self.axis)

    @property
    def group(self):
        return None if self.axis is None else axis_group(self.mesh, self.axis)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x``."""
        if self.axis is None:
            return x
        n = x.shape[self.dim]
        if n % self.size:
            raise ValueError(f"dimension {n} does not split over {self.size} ranks")
        L = n // self.size
        return x.narrow(self.dim, self.rank * L, L)


def batch_sharding(mesh, axis: str = "batch") -> Sharding:
    """Split the leading axis over ``axis``."""
    return Sharding(mesh, axis, 0)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def seq_sharding_for(x_ndim: int, mesh, axis: str = "seq") -> Sharding:
    """Split the LAST axis of an ndim-``x_ndim`` tensor over ``axis``."""
    return Sharding(mesh, axis, x_ndim - 1)


def shard_leading(tree: dict, mesh, size: int, axis: str = "batch") -> dict:
    """This rank's row block of every leaf whose leading dimension equals
    ``size``; every other leaf as it is (replicated)."""
    sh = batch_sharding(mesh, axis)

    def place(v):
        if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == size:
            return sh.block(v)
        return v

    return {k: place(v) for k, v in tree.items()}


# trailing dims of each hyperparameter's own value (the leading ones are batch)
_VALUE_NDIM = {"factor_task_kernel": 2}


def make_sharded_fit_step(model, mesh, axis: str = "batch", loss_metric: str = "MLL",
                          lr: float = 1e-1):
    """The data-parallel fit step of a ``shape_batch`` fleet over ``axis``.

    Each rank holds the rows of its B / D members of every per-member raw
    leaf, of the Rprop state and of the ytildes; the point geometry
    (``k1parts``) and the parameters the members share are replicated.  No
    collective sits inside the loss: each rank's loss covers its own
    members (``d_out`` is its member count, ``mll_const`` is added on rank 0
    only), its backward is seeded with 1, the shared parameters' gradients
    are summed over the group, and the loss's value is all-reduced only to
    report it.  Returns ``(step, raw, opt_state, data)`` with
    ``step(raw, opt_state, data) -> (loss, raw, opt_state)``.

    A sequence-sharded fleet (``use_sequence_sharding(mesh, "seq")`` on the
    same ``mesh``, e.g. ``make_mesh({"batch": 2, "seq": 2})``) runs on a 2-D
    mesh: rank (b, s) holds batch block b's members on sequence block s.
    The loss function's sums are all-reduced over the sequence group, which
    also sums every gradient once (``_make_loss_fn``), so a rank's loss
    and gradients are its batch block's whole ones; the step then sums the
    shared parameters' gradients and the loss over the batch group alone,
    and ``mll_const`` enters on batch block 0.  A sequence mesh other than
    ``mesh``, or one whose sequence axis is ``axis``, raises ``ValueError``.
    """
    from ..fit.rprop import rprop_init, rprop_update

    if not model.shape_batch:
        raise ValueError("the sharded fit step needs a shape_batch fleet")
    if model._seq_mesh is not None and (model._seq_mesh != mesh or model._seq_axis == axis):
        raise ValueError("the batch and the sequence must be two axes of one mesh: the "
                         f"fleet's sequence mesh must be the step's, with its sequence axis "
                         f"{model._seq_axis!r} other than the batch axis {axis!r}")
    B, nb = model.shape_batch[0], len(model.shape_batch)
    sh = batch_sharding(mesh, axis)
    D, group = sh.size, sh.group
    if B % D:
        raise ValueError(f"the leading batch {B} does not split over {D} ranks")
    d_out = int(np.prod(model.shape_batch))
    mll_const = d_out * float(model.n.sum()) * math.log(2 * math.pi) if sh.rank == 0 else 0.0
    loss_and_grad = model._make_loss_fn(loss_metric, None, d_out // D, mll_const, 1)
    trainable = {k: p.trainable for k, p in model.params.items()}

    raw_full = model._raw_dict()
    member = {k: v.ndim - _VALUE_NDIM.get(k, 1) == nb and v.shape[0] == B
              for k, v in raw_full.items()}
    raw = {k: sh.block(v) if member[k] else v for k, v in raw_full.items()}
    opt_state = rprop_init(raw, lr=lr)
    k1parts, ytildes = model._fit_data()
    data = (k1parts, tuple(sh.block(y) if y.ndim > 1 and y.shape[0] == B else y
                           for y in ytildes))

    def step(raw, opt_state, data):
        loss, _, grads = loss_and_grad(raw, data)
        grads = {k: g if member[k] else comm.sum_(g, group) for k, g in grads.items()}
        with torch.no_grad():
            raw, opt_state = rprop_update(grads, opt_state, raw, trainable)
        return comm.sum_(loss, group), raw, opt_state

    return step, raw, opt_state, data


# ---------------------------------------------------------------------------
# sequence-sharded transforms (the n axis over a mesh axis)
# ---------------------------------------------------------------------------

def _seq(mesh, axis):
    return axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)


@lru_cache(maxsize=32)
def _fwht_column(D: int, c: int, dtype, device):
    """Column c of the orthonormal D x D Hadamard matrix, shaped (D, 1)."""
    from ..ops.fwht import _hadamard_np
    return torch.as_tensor(_hadamard_np(log2_int(D))[:, c] / math.sqrt(D),
                           dtype=dtype, device=device)[:, None]


@lru_cache(maxsize=32)
def _twiddles(n: int, D: int, c: int, cdtype, device):
    """Block c's twiddles ``TW[c, r] = exp(-2 pi i rho_D(c) r / n)``, r < n / D
    (computed in float64)."""
    rho = int(bit_reverse_permutation(log2_int(D))[c])
    tw = np.exp(-2j * np.pi * rho * np.arange(n // D) / n)
    return torch.as_tensor(tw, device=device).to(cdtype)


@lru_cache(maxsize=32)
def _cross_dft(D: int, cdtype, device):
    """``W[j, c] / sqrt(D) = exp(-2 pi i j rho_D(c) / D) / sqrt(D)``, (D, D)."""
    rho = bit_reverse_permutation(log2_int(D))
    w = np.exp(-2j * np.pi * np.outer(np.arange(D), rho) / D) / math.sqrt(D)
    return torch.as_tensor(w, device=device).to(cdtype)


def _expand(col, x):
    """(D, 1) column against (..., L) rows -> (D, ..., L)."""
    return col.reshape((col.shape[0],) + (1,) * x.ndim) * x[None]


def sharded_fwht(x: torch.Tensor, mesh, axis: str = "seq", mean=None) -> torch.Tensor:
    """Orthonormal FWHT of a length-n axis held as blocks: ``x`` is this
    rank's block ``[..., c L:(c + 1) L]`` (L = n / D, c the rank on
    ``axis``), and so is the result.

    Kronecker split ``H_n = H_D (x) H_L``: the local factor is ``ops/fwht``
    on the block (kernel K4 on the card, which subtracts ``mean`` -- the
    global row means, shape ``x.shape[:-1]`` -- as it loads), then each rank
    forms ``H[j, c] / sqrt(D) * local`` for every block j and one
    ``reduce_scatter`` sums them into rank j's block.  A block of length 1
    (n = D) is the D-point contraction alone; D = 1 is the plain transform.
    """
    from ..ops.fwht import fwht

    D, c, group = _seq(mesh, axis)
    local = fwht(x, mean)
    if D == 1:
        return local
    return comm.reduce_scatter(_expand(_fwht_column(D, c, x.dtype, x.device), local), group)


def sharded_fftbr(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """Orthonormal bit-reversed FFT (``ops/transforms.fftbr``) of a length-n
    axis held as blocks, as :func:`sharded_fwht`.  With i = c L + l the
    n-bit reversal splits as ``rho_n(i) = rho_L(l) D + rho_D(c)``, so

        fftbr(v)[j L + r] = sum_c W[j, c] TW[c, r] fftbr_L(v_c)[r] / sqrt(D),

    ``TW[c, r] = exp(-2 pi i rho_D(c) r / n)``, ``W[j, c] = exp(-2 pi i j
    rho_D(c) / D)``: the local factor is ``fftbr`` on the block
    (``torch.fft``, as in the JAX package), then the twiddles, then the
    D-point DFT across blocks as one ``reduce_scatter``."""
    from ..ops import transforms as tr

    D, c, group = _seq(mesh, axis)
    local = tr.fftbr(x)
    if D == 1:
        return local
    tw = _twiddles(x.shape[-1] * D, D, c, local.dtype, x.device)
    w = _cross_dft(D, local.dtype, x.device)[:, c:c + 1]
    return comm.reduce_scatter(_expand(w, local * tw), group)


def sharded_ifftbr(x: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """Inverse of :func:`sharded_fftbr`, same block layout in and out: the
    inverse D-point DFT across blocks (``conj(W)^T``, one
    ``reduce_scatter``), the conjugate twiddles, then ``ifftbr`` on the
    block."""
    from ..ops import transforms as tr
    from ..ops.perm_fft import _cdtype

    D, c, group = _seq(mesh, axis)
    if D == 1:
        return tr.ifftbr(x)
    cdt = x.dtype if x.is_complex() else _cdtype(x.dtype)
    # this rank j sends conj(W[j, c']) x_j / sqrt(D) to every block c'
    w = _cross_dft(D, cdt, x.device)[c, :].conj()[:, None]
    inner = comm.reduce_scatter(_expand(w, x.to(cdt)), group)
    return tr.ifftbr(inner * _twiddles(x.shape[-1] * D, D, c, cdt, x.device).conj())
