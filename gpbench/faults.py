"""Faults planted underneath a cell's timed path, each of a kind that the
cell can have, for the check that ``correct`` then comes out false: on the
CPU in ``tests/test_gpbench_faults.py`` and at the cell's own size on the
card through ``calibrate.py --fault``.  ``patch(owner, name, value)`` sets
an attribute (pytest's ``monkeypatch.setattr`` in the tests)."""

import torch


def _program():
    from fastgaussianprocesses_torch.fit import hmc
    from fastgaussianprocesses_torch.models import abstract, fast
    return abstract, fast, hmc


def answer_altered(patch):
    abstract, _, _ = _program()
    orig = abstract.AbstractGP.post_mean_var

    def altered(self, x, *a, **k):
        pm, pv = orig(self, x, *a, **k)
        pm = pm.clone()
        pm[0] += 0.1 * pm.abs().max()
        return pm, pv
    patch(abstract.AbstractGP, "post_mean_var", altered)


def half_of_the_queries(patch):
    abstract, _, _ = _program()
    orig = abstract.AbstractGP.post_mean_var

    def half(self, x, *a, **k):
        pm, pv = orig(self, x[: x.shape[0] // 2], *a, **k)
        return torch.cat([pm, pm]), torch.cat([pv, pv])
    patch(abstract.AbstractGP, "post_mean_var", half)


def step_unchanged(patch):
    abstract, _, _ = _program()
    patch(abstract, "rprop_update",
          lambda grads, state, params, trainable=None, **k: (params, state))


def half_of_the_data(patch):
    _, fast, _ = _program()

    def half(self):
        yts = self._ytildes()
        yt = torch.cat(yts, -1)
        zt = torch.cat(fast.fs.solve_tilde(self.factor, yts), -1)
        h = yt.shape[-1] // 2
        norm = 2.0 * torch.real(yt[..., :h].conj() * zt[..., :h]).sum(-1, keepdim=True)
        return norm, self.factor.logdet[..., None]
    patch(fast._FastSolver, "norm_logdet_terms", half)


def loss_altered(patch):
    abstract, _, _ = _program()
    orig = abstract.AbstractGP._fit_steps

    def altered(*a, **k):
        steps, stats = orig(*a, **k)
        stats[0][0] *= 1.1
        return steps, stats
    patch(abstract.AbstractGP, "_fit_steps", staticmethod(altered))


def late_loss_altered(patch):
    """A later dispatch's loss altered: the fit's last step, which runs in a
    dispatch of its own after the first block of steps."""
    abstract, _, _ = _program()
    orig = abstract.AbstractGP._fit_steps

    def altered(*a, **k):
        steps, stats = orig(*a, **k)
        if len(stats) == 1:
            stats[0][0] *= 1.1
        return steps, stats
    patch(abstract.AbstractGP, "_fit_steps", staticmethod(altered))


def fit_leaves_the_start(patch):
    """``fit`` leaves the parameters it started from behind, not its best."""
    abstract, _, _ = _program()
    orig = abstract.AbstractGP.fit

    def leaves_start(self, *a, **k):
        start = self._raw_dict()
        out = orig(self, *a, **k)
        self._set_raw(start)
        return out
    patch(abstract.AbstractGP, "fit", leaves_start)


def sampler_state_unchanged(patch):
    _, _, hmc_mod = _program()
    orig = hmc_mod.hmc

    def unchanged(logprob_fn, init_params, key, **k):
        res = orig(logprob_fn, init_params, key, **k)
        if k.get("init_state") is None:
            return res
        q0 = k["init_state"][0][0]
        S = res.log_prob.shape[0]
        flat, spec = hmc_mod._flatten(init_params)
        lp0 = logprob_fn(hmc_mod._unflatten(q0, spec)).detach()
        return res._replace(samples=hmc_mod._unflatten(q0.expand((S,) + q0.shape), spec),
                            log_prob=lp0.expand(S, -1), state=k["init_state"])
    patch(hmc_mod, "hmc", unchanged)


def half_of_the_chains(patch):
    """The sampler runs half of the chains and hands their rows out twice."""
    _, _, hmc_mod = _program()
    orig = hmc_mod.hmc

    def half(*a, **k):
        res = orig(*a, **k)
        lp = res.log_prob.clone()
        C = lp.shape[1]
        h = C - C // 2
        lp[:, h:] = lp[:, : C // 2]
        samples = {}
        for key, v in res.samples.items():
            v = v.clone()
            v[:, h:] = v[:, : C // 2]
            samples[key] = v
        return res._replace(log_prob=lp, samples=samples)
    patch(hmc_mod, "hmc", half)


def log_density_altered(patch):
    _, _, hmc_mod = _program()
    orig = hmc_mod.hmc

    def altered(*a, **k):
        res = orig(*a, **k)
        lp = res.log_prob.clone()
        lp[0, 0] *= 2.0
        return res._replace(log_prob=lp)
    patch(hmc_mod, "hmc", altered)


def gradient_zeroed(patch):
    """The log-density's gradient comes out zero (its value is kept), in the
    sampler and wherever else the log-density is built."""
    _, _, hmc_mod = _program()
    orig = hmc_mod.gp_log_density

    def zeroed(*a, **k):
        logprob, sampled0 = orig(*a, **k)

        def lp(params):
            v = logprob(params)
            return v.detach() + 0.0 * sum(p.reshape(p.shape[0], -1).sum(-1)
                                          for p in params.values())
        return lp, sampled0
    patch(hmc_mod, "gp_log_density", zeroed)


def proposals_rejected(patch):
    """Every proposal is rejected: the acceptance uniforms are drawn as
    infinity, whose log no acceptance ratio exceeds."""
    _, _, hmc_mod = _program()
    orig = hmc_mod._draws

    def never(*a, **k):
        dr = orig(*a, **k)
        if "accept_u" in dr:
            dr["accept_u"] = torch.full_like(dr["accept_u"], float("inf"))
        return dr
    patch(hmc_mod, "_draws", never)


FAULTS = {
    "serve": [answer_altered, half_of_the_queries],
    "fit": [step_unchanged, half_of_the_data, loss_altered, late_loss_altered,
            fit_leaves_the_start],
    "hmc": [sampler_state_unchanged, half_of_the_chains, log_density_altered, gradient_zeroed,
            proposals_rejected],
}
BY_NAME = {f.__name__: f for fs in FAULTS.values() for f in fs}
