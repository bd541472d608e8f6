"""The card's idle time under the digest's host walks, as a share of the
traced slice (%): the stretches of the slice in which no device operation
ran (``gen/busy.py`` ``gaps`` of the slice's operations) that fall inside
the union of the program's ``digest.masks`` and ``digest.tables`` spans,
over the slice's length.

The spans are host spans on ``time.time()``, and the device operations
are on the same clock through the slice's ``bench.anchor`` range
(``harness/trace.py``): the reading holds to that alignment."""

from benchmark.metrics.idle_in_schedule import idle_inside


def read(ctx):
    return idle_inside(ctx, lambda name: name in ("digest.masks", "digest.tables"))
