"""Real read rows over padded rows of the staged classes."""


def read(ctx):
    padded = ctx.counters.get("rows_padded")
    if not padded:
        return None
    return ctx.counters["rows_real"] / padded
