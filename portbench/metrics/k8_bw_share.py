"""k8_bw_share: the least time K8's launches in the traced window could
take at the card's memory bandwidth, each launch reading its operand
once and writing its output once (the entry's `kernel_bytes["k8"]` a
call, twiddle tables not counted), over the summed device time of the
trace's K8 kernels (merge_u64_large::row_mat), in percent.  None where
the entry counts no K8 bytes or the trace holds no K8 kernel."""

from portbench.metrics_lib import HBM_BYTES_PER_S

KERNEL, OPS = "k8", "merge_u64_large::row_mat"


def read(rec):
    t, nbytes = rec.get("trace"), rec.get("kernel_bytes", {}).get(KERNEL)
    op_s = sum(s for name, s in t["device_ops"] if name.startswith(OPS)) if t else 0.0
    if not nbytes or not op_s:
        return None
    return 100.0 * t["calls"] * nbytes / HBM_BYTES_PER_S / op_s
