"""The deferral's share of the window (%): the union of the program's
``schedule.defer`` spans (the deferred changes selected back into the
pool, in rounds that deferred some; inside ``streaming.schedule``) over
the window's length."""


def read(ctx):
    return ctx.span_share(program=("schedule.defer",))
