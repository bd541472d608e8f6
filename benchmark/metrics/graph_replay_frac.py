"""Share of the window's commit-form runs that replayed a captured CUDA
graph (%): the session's ``GraphCache.stats()`` over the window, replays
over eager runs, captures and replays."""


def read(ctx):
    g = ctx.graphs
    if not g:
        return None
    total = g["eager"] + g["captures"] + g["replays"]
    return 100.0 * g["replays"] / total if total else None
