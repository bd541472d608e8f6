"""The digest's host walks' share of the window (%): the union of the
program's ``digest.masks`` spans (the per-doc on-device masks) and
``digest.tables`` spans (the per-block content-hash tables) over the
window's length."""


def read(ctx):
    return ctx.span_share(program=("digest.masks", "digest.tables"))
