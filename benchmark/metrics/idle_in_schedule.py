"""The card's idle time under the schedule, as a share of the traced slice
(%): the stretches of the slice in which no device operation ran
(``gen/busy.py`` ``gaps`` of the slice's operations) that fall inside the
union of the program's ``schedule.*`` spans, over the slice's length.

The spans are host spans on ``time.time()``, and the device operations
are on the same clock through the slice's ``bench.anchor`` range
(``harness/trace.py``): the reading holds to that alignment."""

from benchmark.gen.busy import gaps, merge


def idle_inside(ctx, keep):
    """Percent of the slice idle on the card and inside the union of the
    program spans whose name ``keep`` accepts; None without a slice or
    without such spans."""
    if ctx.slice is None:
        return None
    spans = merge([(a, b) for n, a, b in ctx.program_spans if keep(n)])
    if not spans:
        return None
    t0, t1 = ctx.slice.t0, ctx.slice.t1
    idle = gaps([(a, b) for _, a, b in ctx.slice.kernels], t0, t1)
    # both lists are sorted and disjoint: one pass intersects them
    i = j = 0
    inside = 0.0
    while i < len(idle) and j < len(spans):
        a, b = max(idle[i][0], spans[j][0]), min(idle[i][1], spans[j][1])
        inside += max(0.0, b - a)
        if idle[i][1] < spans[j][1]:
            i += 1
        else:
            j += 1
    return 100.0 * inside / (t1 - t0)


def read(ctx):
    return idle_inside(ctx, lambda name: name.startswith("schedule."))
