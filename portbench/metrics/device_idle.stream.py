"""device_idle.stream: the share of the traced window in which no device
operation ran, in the streamed cells."""

from portbench.metrics_lib import idle_share as read  # noqa: F401
