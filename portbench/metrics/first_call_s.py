"""Seconds the first step on a fresh pattern takes beyond a warm step:
the planners' host work (hashes, plans, the transpose plan), part of
``setup_s``."""


def read(ctx):
    return ctx.get("first_call_s")
