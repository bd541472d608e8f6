"""The schedule's share of the window (%): the union of the program's
``streaming.schedule`` spans (``drain``'s frame selection, the native
``schedule_split_batch`` and the pool gather) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("streaming.schedule",))
