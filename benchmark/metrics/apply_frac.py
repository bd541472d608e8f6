"""The commit's host share of the window (%): the union of the program's
``streaming.apply`` spans (the enqueue of a batch's forms, not the card's
work) and ``staging.stage`` spans (packing and uploading a batch on the
staging thread) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("streaming.apply", "staging.stage"))
