"""device_idle.single: the share of the traced window in which no device
operation ran, in the synchronous cells."""

from portbench.metrics_lib import idle_share as read  # noqa: F401
