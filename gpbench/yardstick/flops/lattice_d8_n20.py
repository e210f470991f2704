"""FLOPs of the steps of ``lattice_d8_n20``, the one-task lattice: a
request, a fit step and a gradient of the hyperposterior."""

from gpbench.yardstick import steps

serve_request_flops = steps.lattice_request_flops
fit_step_flops = steps.fit_step_flops
hmc_gradient_flops = steps.hmc_gradient_flops
