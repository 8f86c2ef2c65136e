"""The MFCC's least time at the size of each launch (``reference.work.mfcc_work``'s bytes or operations over
the peaks) over the mean device time of ``mfcc_kernel``, in %. Every ``mfcc_roofline.<what>`` reads this
file."""

from kwsbench.reference import work


def read(r):
    times = r.trace.kernels("mfcc_kernel")
    if not times:
        return None
    bound_ms, _ = work.bound(*work.mfcc_work(*r.counters["mfcc_launch"]), r.device_name)
    return 100.0 * bound_ms / (sum(times) / len(times))
