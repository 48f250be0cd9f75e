"""K1's share of its roofline (%): the least time of every K1 launch of
the profiled steps (roofline.spd_solve_bound_s by launch shape) over the
device time of K1's kernels there."""
from perfbench.roofline import spd_solve_bound_s


def read(t):
    if not t.profiled_steps or t.k1_kernel_s <= 0.0 or not t.k1_by_shape:
        return None
    bound = sum(n * spd_solve_bound_s(*shape) for shape, n in t.k1_by_shape.items())
    return 100.0 * bound / t.k1_kernel_s
