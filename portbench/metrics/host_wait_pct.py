"""host_wait_pct: the share of the window's queries' `service` time in
which their thread neither ran nor waited for the card, in %, from the
program's spans: over the window's `service` spans,
100 x sum(wall - cpu - (deviceWait wall - deviceWait cpu)) / sum(wall).
That is the time off the CPU outside a device wait: the GIL, locks and
the pool. A device wait's own CPU counts once, as running: CUDA's
default synchronisation spins on a core while it waits."""

from portbench.metrics._spans import window_queries


def read(ctx):
    qs = window_queries(ctx)
    if qs is None:
        return None
    wall = off = 0
    for svc, trace in qs:
        if svc.cpu is None:
            continue
        waits = [s for s in trace if s.name == "deviceWait"
                 and s.thread == svc.thread and s.cpu is not None]
        waited = sum(s.end - s.start - s.cpu for s in waits)
        wall += svc.end - svc.start
        off += svc.end - svc.start - svc.cpu - waited
    return 100.0 * off / wall if wall > 0 else None
