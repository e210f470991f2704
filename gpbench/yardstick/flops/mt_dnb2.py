"""FLOPs of the steps of ``mt_dnb2``, the three-task digital net: a fit
step."""

from gpbench.yardstick import steps

fit_step_flops = steps.fit_step_flops
