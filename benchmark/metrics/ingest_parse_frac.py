"""The frame parse's share of the window (%): the union of the program's
``ingest.parse`` spans (the native ``parse_frames_bulk`` call inside
``streaming.ingest``) over the window's length."""


def read(ctx):
    return ctx.span_share(program=("ingest.parse",))
