"""The multitask solver's share of the device's busy time: the device time
of the kernels launched inside ranges around the module-level functions of
``linalg/fast_solver`` that the model calls, over the window's busy time.
The backward's kernels run under ``torch.autograd.grad``, outside the
ranges, so this is the forward's share."""

_MOD = "fastgaussianprocesses_torch.linalg.fast_solver"
SPANS = [(_MOD, fn, "gpbench.solver")
         for fn in ("effective_lams", "factorize", "solve_tilde", "trace_inverse",
                    "inv_diag_pointspace", "dc_block")]


def read(ctx):
    t = ctx.trace
    dev = t.span_device_s.get("gpbench.solver", 0.0) if t else 0.0
    return 100.0 * dev / t.busy_s if dev > 0 and t.busy_s > 0 else None
