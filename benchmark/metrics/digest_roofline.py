"""The digest's share of its roofline (%): the least time the card could
take to read, once, the state of the rows each digest of the traced slice
hashed again (their elements and mark operations, counted by the
reference; ``gen/bounds.py``) and write their hashes, over the device time
of the operations the digest launched (the host launched them inside
``digest_async()`` or its ``wait()``)."""

from benchmark.gen.bounds import bound_s


def read(ctx):
    t = ctx.kernel_seconds(digest=True)
    if t is None or not ctx.slice_work or not ctx.slice_work["digest_bytes"]:
        return None
    return 100.0 * bound_s(ctx.slice_work["digest_bytes"], 0) / t
