"""Hamiltonian Monte Carlo over GP hyperparameters (counterpart of
``fastgaussianprocesses_tpu/fit/hmc.py``).

The arithmetic is the JAX package's, step for step: dual averaging with
``mu = log(10 eps0)`` fixed, the doubly windowed mass moments (late start,
exponential forgetting) behind a readiness gate, a diagonal or dense
inverse mass with a trace-relative ridge, ChEES trajectory-time adaptation
or fixed (optionally jittered) trajectory lengths, split-R-hat and
rank-normalized bulk ESS.

What differs, by design:

* **Chains are a leading batch axis**, not a ``vmap``: ``logprob_fn`` maps a
  dict of ``(C, ...)`` leaves to ``(C,)`` log-densities, and one
  ``torch.autograd.grad`` of their sum gives every chain's gradient (the
  chains do not interact).  For a fast GP the chains are rows of the
  eigenvalue transforms: one K1 / K2 (lattice) or K4 (digital net) launch
  carries all C chains.
* **Randomness** comes from one private function of the step index, which
  draws on a CPU ``torch.Generator`` seeded from ``(seed, t)`` and moves the
  draws to the device: the card and the CPU run on the same draws, and a
  resumed run continues bit for bit.  The JAX package's threefry stream
  cannot be reproduced; ``hmc``'s private ``_draw_fn`` replaces the draws
  (the tests feed it the JAX key schedule's).
* **Chains over devices** (``chain_sharding``): each rank of the mesh
  axis runs ``C / D`` of the chains, drawing the global random numbers and
  taking its own rows; the cross-chain reductions gather every chain's
  inputs (one ``all_gather`` an iteration, two with ChEES) and reduce them
  in the unsharded order, so that a sharded run reproduces the unsharded run
  on the same seed bit for bit where the log-density is row-independent;
  every rank returns the whole result.  On a sequence-sharded model the
  chains axis and the model's sequence axis are two axes of one mesh (a 2-D
  mesh): rank (c, s) runs chains ``[c C / Dc, (c + 1) C / Dc)`` as rows of
  its sequence block s, the log-density's sums run over the sequence group
  and the gathers over the chains group.
* **The leapfrog count is fetched** once an iteration (ChEES's
  ``clip(ceil(t / eps), 1, Lmax)`` is data-dependent), and each leapfrog
  step evaluates the gradient once: the JAX body's first evaluation repeats
  the previous step's position, so its value is reused.  An iteration costs
  L gradients (``HMCResult.num_grad_evals`` counts them) where the JAX
  package computes 2 L + 2.
"""

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..parallel import comm


class HMCResult(NamedTuple):
    samples: dict           # each leaf: (num_samples, chains, *param_shape)
    log_prob: torch.Tensor  # (num_samples, chains)
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    mass_diag: dict
    state: tuple = None     # (carry, next_t): resume token for hmc(init_state=...)
    mean_leapfrog: float = None   # mean leapfrog steps an iteration (whole run)
    num_grad_evals: int = None    # gradient evaluations of this call (all chains at once)


def _flatten(tree):
    """Concatenate a dict's leaves in sorted key order (the order of
    ``jax.tree.flatten`` on a dict)."""
    keys = sorted(tree)
    shapes = [tuple(tree[k].shape) for k in keys]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    return flat, (keys, shapes, sizes)


def _unflatten(flat, spec):
    """``(..., dim)`` -> dict of ``(..., *shape)`` leaves."""
    keys, shapes, sizes = spec
    out, off = {}, 0
    for k, shape, size in zip(keys, shapes, sizes):
        out[k] = flat[..., off:off + size].reshape(flat.shape[:-1] + shape)
        off += size
    return out


def _step_seed(seed: int, t: int) -> int:
    """64-bit seed of step ``t``'s CPU generator (``t = -1``: the start)."""
    return int(np.random.SeedSequence([int(seed), int(t) + 1]).generate_state(1, np.uint64)[0])


def _draws(seed, t, num_chains, dim, dtype, traj):
    """The random numbers of step ``t`` on a CPU generator seeded from
    ``(seed, t)``: for ``t = -1`` the initial jitter ``{"init": (C, dim)}``;
    else the momentum normals ``"z"`` (C, dim), the trajectory draw
    ``"traj"`` (a uniform 0-d tensor for ``traj == "uniform"``, an int in
    ``[lo, hi]`` for ``traj == (lo, hi)``, None for ``traj is None``) and the
    acceptance uniforms ``"accept_u"`` (C,)."""
    g = torch.Generator().manual_seed(_step_seed(seed, t))
    if t < 0:
        return {"init": torch.randn((num_chains, dim), generator=g, dtype=dtype)}
    z = torch.randn((num_chains, dim), generator=g, dtype=dtype)
    if traj == "uniform":
        tr = torch.rand((), generator=g, dtype=dtype)
    elif traj is None:
        tr = None
    else:
        tr = int(torch.randint(traj[0], traj[1] + 1, (), generator=g))
    return {"z": z, "traj": tr, "accept_u": torch.rand((num_chains,), generator=g, dtype=dtype)}


def hmc(logprob_fn: Callable, init_params, key,
        num_samples: int = 500, num_warmup: int = 500, num_chains: int = 8,
        num_leapfrog: int = 32, trajectory_jitter: float = 0.0,
        mass_decay: float = 0.99, mass_warmup_start_frac: float = 0.25,
        mass_matrix: str = "diag", target_accept: float = 0.8,
        init_jitter: float = 0.5, chain_sharding=None,
        trajectory_adapt: str = "fixed", max_leapfrog: int = None,
        init_state=None, _draw_fn=None) -> HMCResult:
    """Sample ``logprob_fn`` starting near ``init_params``.

    ``logprob_fn`` is BATCHED over chains, the one deliberate difference from
    the JAX package's ``hmc`` (which vmaps an unbatched function): it maps a
    dict of ``(C, *shape)`` leaves to ``(C,)`` log-densities, and must not
    couple the chains.  ``init_params`` is a dict of unbatched tensors; the
    sampler runs on their device and dtype.  ``key`` is an int seed.

    Returns samples stacked as ``(num_samples, chains, ...)``.  The options
    are the JAX package's (its docstring gives the reasoning):

    * ``num_leapfrog`` steps a trajectory; ``trajectory_jitter`` in (0, 1]
      draws each length uniformly from
      ``[num_leapfrog (1 - jitter), num_leapfrog]``;
    * ``trajectory_adapt="chees"``: trajectory time ``t = 2 u T`` with
      ``u ~ U(0, 1)``, ``T`` adapted by RMSProp on the ChEES criterion's
      cross-chain gradient during warmup, ``ceil(t / eps)`` leapfrog steps
      clipped to ``[1, max_leapfrog]`` (default ``4 num_leapfrog``);
    * ``mass_matrix`` "diag" or "dense" (the full windowed posterior
      covariance, ridged by ``1e-6 (tr / dim + 1)``); moments accumulate
      from step ``mass_warmup_start_frac * num_warmup`` with the forgetting
      factor ``mass_decay``;
    * dual averaging of the step size towards ``target_accept``.

    ``result.state = (carry, next_t)`` passed back as ``init_state`` with the
    same ``key`` continues bit for bit on the same device (the draws are
    functions of the global step).  The carry is the JAX package's ten
    entries, so a token moves between the packages (``utils/checkpoint``).

    ``chain_sharding``: ``parallel.mesh.batch_sharding(mesh, "chains")`` to
    split the chains over that mesh axis, ``C / D`` a rank (every rank of
    the axis calls ``hmc`` with the same arguments).  A gradient is then one
    evaluation of ``logprob_fn`` on the rank's rows; the cross-chain means
    (ChEES's centre and criterion, dual averaging's acceptance, the mass
    moments, the acceptance rate) are taken over every chain's gathered
    rows; the samples, log-densities and the carry's positions are
    gathered, so every rank returns the whole result and a resume token of
    any layout.
    """
    from ..parallel.mesh import Sharding

    if chain_sharding is not None and not isinstance(chain_sharding, Sharding):
        raise TypeError("chain_sharding must be a parallel.mesh.Sharding "
                        f"(batch_sharding(mesh, 'chains')), got {type(chain_sharding).__name__}")
    group = None if chain_sharding is None else chain_sharding.group
    D = 1 if group is None else chain_sharding.size
    if num_chains % D:
        raise ValueError(f"{num_chains} chains do not split over {D} ranks")
    C = num_chains // D
    r0 = 0 if group is None else chain_sharding.rank * C
    rows = slice(r0, r0 + C)
    if mass_matrix not in ("diag", "dense"):
        raise ValueError(f"mass_matrix must be 'diag' or 'dense', got {mass_matrix!r}")
    if trajectory_adapt not in ("fixed", "chees"):
        raise ValueError(f"trajectory_adapt must be 'fixed' or 'chees', got {trajectory_adapt!r}")
    flat0, spec = _flatten(init_params)
    dim = flat0.shape[0]
    dtype, device = flat0.dtype, flat0.device
    eps0 = 0.1  # initial step size; dual averaging shrinks toward 10 * eps0
    dense = mass_matrix == "dense"
    chees = trajectory_adapt == "chees"
    Lmax = int(max_leapfrog) if max_leapfrog else 4 * num_leapfrog
    lo = max(1, int(round(num_leapfrog * (1.0 - trajectory_jitter))))
    traj = "uniform" if chees else (None if lo >= num_leapfrog else (lo, num_leapfrog))
    if _draw_fn is None:
        def _draw_fn(t):
            return _draws(key, t, num_chains, dim, dtype, traj)

    def draws(t):
        # every rank draws the global numbers and keeps its chains' rows
        dr = _draw_fn(t)
        return {k: v[rows] if k in ("init", "z", "accept_u") else v for k, v in dr.items()}

    def every_chain(*xs):
        """Each x (leading chain axis) over all C chains: under chain sharding
        one all_gather for all of them, so that every cross-chain reduction
        runs on the same rows in the same order as the unsharded sampler's
        (an all-reduce of partial sums would round differently, and dual
        averaging amplifies every difference)."""
        if group is None:
            return xs
        flat = [x.reshape(x.shape[0], -1).to(dtype) for x in xs]
        every = comm.all_gather_cat(torch.cat(flat, -1), group, 0)
        out, off = [], 0
        for x, f in zip(xs, flat):
            out.append(every[:, off:off + f.shape[1]].reshape((num_chains,) + x.shape[1:]))
            off += f.shape[1]
        return out

    def dev(x):
        # a step's draws go to the card from pinned memory without a stream sync
        if device.type == "cuda":
            return x.to(dtype=dtype).pin_memory().to(device, non_blocking=True)
        return x.to(device=device, dtype=dtype)

    n_grads = 0

    def v_and_g(q):
        nonlocal n_grads
        n_grads += 1
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            lp = logprob_fn(_unflatten(qq, spec))
            g, = torch.autograd.grad(lp.sum(), qq)
        return lp.detach(), g

    def apply_inv_mass(inv_mass, p):
        # inv_mass: (dim,) in diag mode, symmetric (dim, dim) in dense mode
        return p @ inv_mass if dense else inv_mass * p

    def kinetic(p, inv_mass):
        return 0.5 * (p * apply_inv_mass(inv_mass, p)).sum(-1)

    # readiness gate: ``count`` is an exponentially decayed counter with
    # supremum 1/(1 - mass_decay); half the window, capped at 10 steps
    count_sup = 1.0 / (1.0 - mass_decay) if mass_decay < 1.0 else math.inf
    mass_ready_count = min(10.0, 0.5 * count_sup)
    eye = torch.eye(dim, dtype=dtype, device=device)

    def estimate_inv_mass(mass_mean, mass_sq, count):
        cm = torch.clamp(count, min=1.0)
        mean_est = mass_mean / cm
        ready = count > mass_ready_count
        if dense:
            cov = mass_sq / cm - mean_est[:, None] * mean_est[None, :]
            # trace-relative ridge keeps the windowed estimate PSD
            ridge = 1e-6 * (torch.trace(cov) / dim + 1.0)
            cov = cov + ridge * eye
            return torch.where(ready, cov, eye)
        var = torch.clamp(mass_sq / cm - mean_est ** 2, min=1e-6)
        return torch.where(ready, var, torch.ones_like(var))

    def sample_momentum(z, inv_mass):
        if dense:
            # p ~ N(0, cov^-1): with cov = L L^T, p = L^-T z
            L = torch.linalg.cholesky(inv_mass)
            return torch.linalg.solve_triangular(L.mT, z.mT, upper=True).mT
        return z / torch.sqrt(inv_mass)

    log2 = torch.tensor(math.log(2.0), dtype=dtype, device=device)
    log_half_lmax = torch.tensor(math.log(0.5 * Lmax), dtype=dtype, device=device)
    mu = math.log(10.0 * eps0)

    def step(carry, lp0, g0, t_i, tw, adapting, mass_adapting):
        (q, log_eps, h_bar, log_eps_bar, mass_mean, mass_sq, count,
         log_T, rms_v, _) = carry
        dr = draws(t_i)
        inv_mass = estimate_inv_mass(mass_mean, mass_sq, count)
        eps = torch.exp(log_eps)
        p = sample_momentum(dev(dr["z"]), inv_mass)
        if chees:
            # trajectory time t = u 2T; the leapfrog count from the current
            # step size, clipped to [1, Lmax] (the one host fetch an iteration)
            t_traj = 2.0 * dev(dr["traj"]) * torch.exp(log_T)
            steps = float(torch.ceil(t_traj / eps))
            n_steps = 1 if math.isnan(steps) else int(min(max(steps, 1.0), Lmax))
        else:
            n_steps = num_leapfrog if dr["traj"] is None else int(dr["traj"])
        h0 = lp0 - kinetic(p, inv_mass)
        q_new, p_new, g = q, p, g0
        lp1 = lp0
        for _ in range(n_steps):
            p_new = p_new + 0.5 * eps * g
            q_new = q_new + eps * apply_inv_mass(inv_mass, p_new)
            lp1, g = v_and_g(q_new)
            p_new = p_new + 0.5 * eps * g
        h1 = lp1 - kinetic(p_new, inv_mass)
        log_alpha = torch.clamp(h1 - h0, max=0.0)
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        accept = torch.log(dev(dr["accept_u"])) < log_alpha
        if chees:
            # the ChEES criterion's per-chain terms over the proposed end states
            qbar = every_chain(q_new)[0].mean(0)
            dq_new = q_new - qbar
            dq_old = q - qbar
            crit = (dq_new ** 2).sum(-1) - (dq_old ** 2).sum(-1)
            vel = apply_inv_mass(inv_mass, p_new)
            g_c = crit * (dq_new * vel).sum(-1)
        acc2 = accept[:, None]
        q = torch.where(acc2, q_new, q)
        lp = torch.where(accept, lp1, lp0)
        g_next = torch.where(acc2, g, g0)
        # the cross-chain inputs of the adaptation, every chain's
        log_alpha_c, accept_c, q_c, *g_c = every_chain(log_alpha, accept, q,
                                                       *([g_c] if chees else []))
        if chees:
            # ChEES criterion gradient wrt log T, acceptance-weighted;
            # RMSProp ascent during warmup only
            w_a = torch.exp(log_alpha_c)
            grad = (w_a * g_c[0]).sum() / torch.clamp(w_a.sum(), min=1e-6) * t_traj
            grad = torch.where(torch.isfinite(grad), grad, 0.0)
            if adapting:
                rms_v = 0.9 * rms_v + 0.1 * grad * grad
                log_T = log_T + 0.025 * grad / torch.sqrt(rms_v + 1e-10)
            # keep 2T/eps inside [1, Lmax] steps
            log_T = torch.minimum(torch.maximum(log_T, log_eps - log2), log_eps + log_half_lmax)
        # dual averaging on the cross-chain mean acceptance, mu fixed
        if adapting:
            alpha_mean = torch.exp(log_alpha_c).mean()
            h_bar = (1 - 1 / (tw + 10.0)) * h_bar + (target_accept - alpha_mean) / (tw + 10.0)
            log_eps_prop = mu - torch.sqrt(tw) / 0.05 * h_bar
            w = tw ** -0.75
            log_eps_bar = w * log_eps_prop + (1 - w) * log_eps_bar
            log_eps = log_eps_prop
        else:
            log_eps = log_eps_bar
        # mass moments across chains, doubly windowed in time
        if adapting and mass_adapting:
            sq_upd = (q_c[:, :, None] * q_c[:, None, :]).mean(0) if dense else (q_c * q_c).mean(0)
            mass_mean = mass_decay * mass_mean + q_c.mean(0)
            mass_sq = mass_decay * mass_sq + sq_upd
            count = mass_decay * count + 1.0
        new_carry = (q, log_eps, h_bar, log_eps_bar, mass_mean, mass_sq, count,
                     log_T, rms_v, flags[adapting])
        return new_carry, lp, g_next, accept_c.to(dtype).mean(), n_steps

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    flags = {True: torch.tensor(True, device=device), False: torch.tensor(False, device=device)}

    if init_state is None:
        start_t = 0
        q0 = flat0[None, :] + init_jitter * dev(draws(-1)["init"])
        # T0: mean trajectory time eps0 * num_leapfrog
        carry = (q0, scalar(math.log(0.1)), scalar(0.0), scalar(math.log(0.1)),
                 torch.zeros(dim, dtype=dtype, device=device),
                 torch.zeros((dim, dim) if dense else (dim,), dtype=dtype, device=device),
                 scalar(0.0), scalar(math.log(eps0 * num_leapfrog)), scalar(0.0),
                 torch.tensor(True, device=device))
        total = num_warmup + num_samples
    else:
        carry, start_t = init_state
        carry = tuple(torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v), device=device)
                      for v in carry)
        carry = (carry[0][rows],) + carry[1:]
        start_t = int(start_t)
        total = max(0, num_warmup - start_t) + num_samples
    mass_start = int(round(mass_warmup_start_frac * num_warmup))
    # step counters t + 1 as device scalars, made once (no copy an iteration)
    tws = torch.arange(start_t, start_t + total, dtype=dtype, device=device) + 1.0
    lp_cur, g_cur = v_and_g(carry[0])
    qs, lps, accs, nsts = [], [], [], []
    for i, t_i in enumerate(range(start_t, start_t + total)):
        carry, lp_cur, g_cur, acc_rate, n_steps = step(
            carry, lp_cur, g_cur, t_i, tws[i], t_i < num_warmup, t_i >= mass_start)
        if t_i >= num_warmup:
            qs.append(carry[0])
            lps.append(lp_cur)
            accs.append(acc_rate)
        nsts.append(n_steps)
    mean_leapfrog = float(torch.tensor(nsts, dtype=dtype).mean()) if nsts else math.nan
    # the adapted inverse-mass ESTIMATE; dense mode reports the covariance diagonal
    inv_mass_final = estimate_inv_mass(carry[4], carry[5], carry[6])
    if dense:
        inv_mass_final = torch.diagonal(inv_mass_final)
    qs = torch.stack(qs) if qs else torch.zeros((0, C, dim), dtype=dtype, device=device)
    lps = torch.stack(lps) if lps else torch.zeros((0, C), dtype=dtype, device=device)
    acc = torch.stack(accs).mean() if accs else scalar(math.nan)
    if group is not None:
        # every rank returns every chain (rank order is chain order)
        qs, lps = comm.all_gather_cat(qs, group, 1), comm.all_gather_cat(lps, group, 1)
        carry = (comm.all_gather_cat(carry[0], group, 0),) + carry[1:]
    return HMCResult(samples=_unflatten(qs, spec), log_prob=lps, accept_rate=acc,
                     step_size=torch.exp(carry[3]), mass_diag=_unflatten(inv_mass_final, spec),
                     state=(carry, start_t + total), mean_leapfrog=mean_leapfrog,
                     num_grad_evals=n_grads)


# ---------------------------------------------------------------------------
# diagnostics (numpy/scipy on the host, the JAX package's)
# ---------------------------------------------------------------------------

def split_rhat(x):
    """Split-R-hat for draws shaped (num_samples, chains)."""
    x = np.asarray(x)
    n, m = x.shape
    half = n // 2
    splits = np.concatenate([x[:half], x[half:2 * half]], axis=1)  # (half, 2m)
    w = splits.var(0, ddof=1).mean()
    b = half * splits.mean(0).var(ddof=1)
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def _rank_normalize(x):
    """Replace draws by normal quantiles of their fractional ranks
    (Vehtari et al. 2021 eq. 14: z = Phi^-1((r - 3/8) / (S + 1/4)))."""
    from scipy.special import ndtri

    flat = x.ravel()
    ranks = np.empty(flat.shape, dtype=np.float64)
    ranks[np.argsort(flat, kind="stable")] = np.arange(1, flat.size + 1)
    return ndtri((ranks - 0.375) / (flat.size + 0.25)).reshape(x.shape)


def effective_sample_size(x, rank_normalized=True):
    """Bulk ESS for draws shaped (num_samples, chains): split chains,
    rank-normalized (Vehtari et al. 2021), the combined autocorrelation
    normalized by ``var_plus``, Geyer's initial monotone sequence."""
    x = np.asarray(x, dtype=np.float64)
    n, m = x.shape
    half = n // 2
    if half < 2:
        return float(n * m)
    x = np.concatenate([x[:half], x[half:2 * half]], axis=1)  # split chains
    n, m = x.shape
    if rank_normalized:
        x = _rank_normalize(x)
    chain_var = x.var(0, ddof=1)
    w = chain_var.mean()
    b_over_n = x.mean(0).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b_over_n
    if var_plus <= 0:
        return float(n * m)
    xc = x - x.mean(0)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real / n
    rho = 1.0 - (w - acov.mean(1)) / var_plus
    # Geyer initial monotone positive sequence
    s = 0.0
    prev_pair = np.inf
    t = 0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        s += pair
        prev_pair = pair
        t += 2
    tau = max(-1.0 + 2.0 * s, 1.0 / np.log10(max(n * m, 10)))
    return float(n * m / tau)


def gp_log_density(model, include=("scale", "lengthscales"), prior_std=3.0):
    """``(logprob, sampled0)``: the batched log-density of a GP model's raw
    hyperparameters ``include`` (the others fixed at the model's values),

        log p(theta | y) = -MLL_loss(theta) + log N(raw; raw_init, prior_std^2),

    taking a dict of ``(C, *shape)`` leaves to ``(C,)``, and the leaves'
    current (unbatched) values.  Every reduction is per chain: the norm term,
    ``d_out / prod(logdet.shape[1:]) * logdet[c].sum()`` and the prior.

    Under a sequence mesh (``use_sequence_sharding``) every chain is a row of
    the rank's block of the transforms, the solver all-reduces the norm and
    the log-determinant, so every rank holds the same values, and the sampled
    leaves enter through ``comm.shared_input``, whose backward averages the
    ranks' gradients: seeded with 1 (as ``hmc`` seeds it), each rank then
    holds the whole gradient, the same on every rank.  So every rank makes
    the same accept decisions and leapfrog counts, and issues the same
    collectives.  Every rank of the mesh calls the sampler with the same
    arguments.  On a 2-D mesh of chains and sequence
    (``sample_gp_hyperposterior(chain_sharding=...)``) a rank is given its
    chain block's rows; the sums and the mean run over the sequence group
    alone, so the rank holds its chains' whole values and gradients."""
    group = model._seq_group
    model._warm_for_fit()
    d_out = int(np.prod(model.shape_batch)) if model.shape_batch else 1
    mll_const = d_out * float(model.n.sum()) * math.log(2 * math.pi)
    raw_full = model._raw_dict()
    sampled0 = {k: raw_full[k] for k in include}
    data = model._fit_data()

    def per_chain(x, C):
        if x.ndim == 0 or x.shape[0] != C:
            raise ValueError(f"expected a leading chain axis of {C}, got {tuple(x.shape)}")
        return x.reshape(C, -1)

    def logprob(sampled):
        C = next(iter(sampled.values())).shape[0]
        raw = dict(raw_full)
        raw.update({k: comm.shared_input(v, group) for k, v in sampled.items()})
        solver = model._solver_pure(raw, data)
        norm, logdet = solver.norm_logdet_terms()
        logdet = per_chain(logdet, C)
        term2 = d_out / float(logdet.shape[1]) * logdet.sum(-1)
        nll = 0.5 * (per_chain(norm, C).sum(-1) + term2 + mll_const)
        prior = sum(((v - sampled0[k]) ** 2).reshape(C, -1).sum(-1) for k, v in sampled.items())
        return -nll - prior / (2.0 * prior_std**2)

    return logprob, sampled0


def sample_gp_hyperposterior(model, num_samples=500, num_warmup=500,
                             num_chains=8, seed=0, prior_std=3.0,
                             include=("scale", "lengthscales"),
                             num_leapfrog=32, trajectory_jitter=0.5,
                             mass_decay=0.99, mass_warmup_start_frac=0.25,
                             mass_matrix="dense", target_accept=None,
                             trajectory_adapt="chees", max_leapfrog=None,
                             chain_sharding=None, resume_state=None):
    """Sample the hyperposterior of a GP model's raw hyperparameters
    (:func:`gp_log_density`) with :func:`hmc`, all chains as rows of one
    solver: ``model._solver_pure`` runs once a gradient on raw leaves of
    shape ``(chains,) + param_shape``.

    Returns ``(HMCResult, diagnostics)``, the diagnostics per parameter: the
    worst split-R-hat and least ESS over its components, and both per
    component.  The defaults are the JAX package's measured GP defaults:
    dense mass, ChEES seeded at T0 = eps0 * 32, and a dtype-aware acceptance
    target (``target_accept=None``): 0.9 in float64, 0.8 in float32, whose
    MLL surface is too rough for 0.9.  ``trajectory_jitter`` applies only
    with ``trajectory_adapt="fixed"``.

    A sequence-sharded model (``use_sequence_sharding``) samples with all
    chains on every rank of its mesh (see :func:`gp_log_density`).  With
    ``chain_sharding`` on top of it, the chains and the sequence are two
    distinct axes of the model's mesh, a 2-D mesh::

        mesh = make_mesh({"chains": 2, "seq": 2})
        model.use_sequence_sharding(mesh, "seq")
        sample_gp_hyperposterior(model, chain_sharding=batch_sharding(mesh, "chains"))

    Rank (c, s) then samples chains ``[c C / Dc, (c + 1) C / Dc)`` as rows
    of its sequence block s: the log-density's sums and ``shared_input``'s
    mean run over the sequence group, ``hmc``'s gathers over the chains
    group.  A rank holds the same values of its chains as the rest of its
    sequence group, so every rank makes the same decisions, issues the same
    collectives on both groups in the same order, and returns the whole
    result.  A ``chain_sharding`` on another mesh, or on the sequence axis
    itself, raises ``ValueError``.
    """
    if chain_sharding is not None and model._seq_mesh is not None and (
            chain_sharding.mesh != model._seq_mesh or chain_sharding.axis == model._seq_axis):
        raise ValueError("the chains and the sequence must be two axes of one mesh: "
                         "chain_sharding must be batch_sharding(mesh, axis) on the mesh of "
                         "use_sequence_sharding(mesh, seq_axis), with axis != seq_axis")
    if target_accept is None:
        target_accept = 0.9 if model.dtype == torch.float64 else 0.8
    logprob, sampled0 = gp_log_density(model, include=include, prior_std=prior_std)
    result = hmc(logprob, sampled0, seed, num_samples=num_samples,
                 num_warmup=num_warmup, num_chains=num_chains,
                 num_leapfrog=num_leapfrog, trajectory_jitter=trajectory_jitter,
                 mass_decay=mass_decay,
                 mass_warmup_start_frac=mass_warmup_start_frac,
                 mass_matrix=mass_matrix, target_accept=target_accept,
                 trajectory_adapt=trajectory_adapt, max_leapfrog=max_leapfrog,
                 chain_sharding=chain_sharding, init_state=resume_state)
    diagnostics = {}
    for k, v in result.samples.items():
        flat = v.detach().cpu().numpy().reshape(v.shape[0], v.shape[1], -1)
        rhats = [split_rhat(flat[..., c]) for c in range(flat.shape[-1])]
        esss = [effective_sample_size(flat[..., c]) for c in range(flat.shape[-1])]
        diagnostics[k] = {"rhat": float(np.max(rhats)), "ess": float(np.min(esss)),
                          "rhat_per_component": rhats, "ess_per_component": esss}
    return result, diagnostics
