"""k7_bw_share: the least time K7's launches in the traced window could
take at the card's memory bandwidth, each launch reading its operand
once and writing its output once (the entry's `kernel_bytes["k7"]` a
call, twiddle tables not counted), over the summed device time of the
trace's K7 kernels (merge_u64_large::col_mat), in percent.  None where
the entry counts no K7 bytes or the trace holds no K7 kernel."""

from portbench.metrics_lib import HBM_BYTES_PER_S

KERNEL, OPS = "k7", "merge_u64_large::col_mat"


def read(rec):
    t, nbytes = rec.get("trace"), rec.get("kernel_bytes", {}).get(KERNEL)
    op_s = sum(s for name, s in t["device_ops"] if name.startswith(OPS)) if t else 0.0
    if not nbytes or not op_s:
        return None
    return 100.0 * t["calls"] * nbytes / HBM_BYTES_PER_S / op_s
