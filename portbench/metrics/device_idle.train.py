"""Share of the traced slice in which no operation ran on the device, in %:
1 − (union of device event intervals ÷ the slice's length)."""

from portbench.trace import idle_percent as read  # noqa: F401
