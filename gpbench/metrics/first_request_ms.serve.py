"""The process's first request (``post_mean_var``), by the host clock and
ended by ``torch.cuda.synchronize()``, taken in set-up: what a first query
pays beyond a steady one."""


def read(ctx):
    return ctx.run.setup.get("first_request_ms")
