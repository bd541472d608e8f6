"""Share of the traced slice in which no operation ran on the card (%):
one minus the union of the profiler's device intervals over the slice's
length."""


def read(ctx):
    busy = ctx.device_busy_s()
    if busy is None:
        return None
    span = ctx.slice.t1 - ctx.slice.t0
    return 100.0 * (1.0 - busy / span)
