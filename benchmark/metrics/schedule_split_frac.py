"""The frame split's share of the window (%): the union of the program's
``schedule.split`` spans (``_step_frame_docs`` through the native
``schedule_split_batch`` and the count scatter; inside
``streaming.schedule``) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("schedule.split",))
