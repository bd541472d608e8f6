"""The pool gather's share of the window (%): the union of the program's
``schedule.gather`` spans (``_gather_pool``: the pooled parsed changes
concatenated, demoted docs' dropped, sorted by doc; inside
``streaming.schedule``) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("schedule.gather",))
