"""``ros2_sweep``: one request is a fixed-step two-stage Rosenbrock LRSIF
sweep through ``solve_gdre_ros2_compiled`` from
``X0 = lowrank(E⁻¹Cᵀ, x0_scale·I)`` (`requests.Sweep`)."""

from pbench import control, faults, requests


def make(config, traffic, inputs, dtype, device):
    return requests.Sweep("ros2", config, traffic, inputs, dtype, device)


tiny = requests.two_steps
reference_f32 = control.sweep_reference_f32
FAULTS = faults.sweep("ros2_step_compiled")
