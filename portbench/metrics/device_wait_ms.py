"""device_wait_ms: the mean over the window's queries of the
milliseconds in their `deviceWait` spans: the device-to-host copies that
wait for the card to finish the query's queued kernels, from the
program's spans."""

from portbench.metrics._spans import mean_ms, wall_ns


def read(ctx):
    return mean_ms(ctx, lambda svc, trace: wall_ns(trace, ("deviceWait",)))
