"""From the start of the process to the first timed chunk: loading,
calibration, rendering and uploading the clip, the warm-up chunks (which
build the kernels on a checkout's first run)."""
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
