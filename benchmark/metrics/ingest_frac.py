"""Frame ingest's share of the window (%): the union of the program's
``streaming.ingest`` spans (``ingest_frames``: the native parse and the
frame pool) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("streaming.ingest",))
