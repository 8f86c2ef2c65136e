"""The res stack's least time from the features (``reference.work.forward_bound`` in the port's
``bfloat16_activations`` mode, at the cell's batch) over the mean device time of ``res_stack_kernel``, in %."""

from kwsbench.reference import res, work


def read(r):
    times = r.trace.kernels("res_stack_kernel")
    if not times:
        return None
    C, H, W, L, n_lab, pool = res.stack_geometry(r.config)
    bound_ms, _ = work.forward_bound(r.counters["res_forward_batch"], C, H, W, L, n_lab, pool, r.device_name,
                                     "bfloat16_activations")
    return 100.0 * bound_ms / (sum(times) / len(times))
