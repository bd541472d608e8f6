"""The digest's share of the window (%): the union of the program's
``streaming.digest`` and ``streaming.resolve`` spans and the harness's
``bench.digest`` span (``digest_async()`` to the return of its ``wait()``)
over the window's length."""


def read(ctx):
    return ctx.span_share(program=("streaming.digest", "streaming.resolve"),
                          harness=("bench.digest",))
