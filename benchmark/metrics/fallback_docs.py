"""Documents the card could not hold, read by the host's replay instead:
those demoted to fallback and those that overflowed a capacity, in the
session the window ended on.  The configurations are sized for 0."""


def read(ctx):
    return float(ctx.fallback_docs)
