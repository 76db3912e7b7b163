"""The instance-norm kernel's share of its roofline over the traced engine
calls: the bytes its sites must move (one read and one write of each
input, at the shapes the reference's encode has at each call's batch
bucket) at the card's published bandwidth, over the kernels' device time
in the trace. Bound by bytes: the kernel does a few operations a byte."""


def read(run):
    if run.trace is None or not run.work.get("instance_norm_bytes"):
        return None
    seconds, count = run.trace.device_time_s(lambda name: "instance_norm_kernel" in name)
    if not count:
        return None
    bound = run.work["instance_norm_bytes"] / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
