"""``window_attn_ms.rate``: device kernel milliseconds launched inside
``bench.window_attn`` ranges (each block's attention module: the qkv and
output projections and the attention core), a bucket (a
``bench.features`` range); None where the slice holds none (a program
without the Swin trunk)."""

import re


def read(ctx):
    tl = getattr(ctx, "timeline", None)
    if tl is None:
        return None
    attn = tl.ranges_named(re.escape("bench.window_attn") + "$")
    buckets = tl.ranges_named(re.escape("bench.features") + "$")
    if not attn or not buckets:
        return None
    inside = [r for r in attn if any(tl.inside(r, b) for b in buckets)]
    return sum(tl.kernel_ms(r) for r in inside) / len(buckets)
