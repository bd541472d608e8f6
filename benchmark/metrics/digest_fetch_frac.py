"""The digest's fetch's share of the window (%): the union of the
program's ``digest.fetch`` spans (the copies of the per-doc hash and
overflow vectors to the host, where the host waits for the card) over the
window's length."""


def read(ctx):
    return ctx.span_share(program=("digest.fetch",))
