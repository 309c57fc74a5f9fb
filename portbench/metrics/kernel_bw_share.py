"""kernel_bw_share: the least time the calls of the traced window could
take at the card's memory bandwidth, each call's operands read once and
its output written once (int64 lanes, no twiddle table counted), over the
summed time of the device operations in the window, in percent.  Bytes
alone bound it: with operands drawn from a pool of four times the L2 no
implementation moves them faster, while a count of operations would
depend on how the products are implemented."""

from portbench.metrics_lib import HBM_BYTES_PER_S


def read(rec):
    t = rec.get("trace")
    if not t or not t["op_s"]:
        return None
    return 100.0 * t["calls"] * rec["bytes"] / HBM_BYTES_PER_S / t["op_s"]
