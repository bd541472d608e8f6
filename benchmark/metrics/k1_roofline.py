"""The insert kernel K1's share of its roofline (%): the least time the
card could take for the traced slice's inserts (each insert's streams read
once and its element written once; per insert step every slot already
present passed once and a few operations more, counted by the reference;
``gen/bounds.py``), over the summed device time of the profiler's
``insert_kernel`` launches."""

from benchmark.gen.bounds import INSERT_BYTES, bound_s


def read(ctx):
    t = ctx.kernel_seconds(name_has="insert_kernel")
    w = ctx.slice_work
    if t is None or not w or not w["inserts"]:
        return None
    return 100.0 * bound_s(w["inserts"] * INSERT_BYTES, w["insert_ops"]) / t
