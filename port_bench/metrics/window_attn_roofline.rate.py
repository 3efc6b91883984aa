"""``window_attn_roofline.rate``: percent, the attention cores' least time
over the device time of the kernels that compute them.

The kernels are those launched inside ``bench.window_attn_core:<images>``
ranges (one around each call of the program's attention core, found by
the call and not by a kernel name).  Each call's least time
(:func:`port_bench.counts_swin.attention_bound_ms`) comes from the
configuration's padded shapes (``ctx.window_attn_calls``, the blocks in
order) and the images in the range's name: within a bucket (a
``bench.features`` range) the k-th call is block k's.  Buckets whose calls
are not one a block are left out.  None where the slice holds none."""

import re

from port_bench import counts_swin

CORE = re.compile(r"bench\.window_attn_core:(\d+)$")


def read(ctx):
    tl = getattr(ctx, "timeline", None)
    calls = getattr(ctx, "window_attn_calls", None)
    if tl is None or not calls or ctx.peaks is None:
        return None
    cores = tl.ranges_named(CORE.pattern)
    bound = device = 0.0
    for bucket in tl.ranges_named(re.escape("bench.features") + "$"):
        mine = [r for r in cores if tl.inside(r, bucket)]
        if len(mine) != len(calls):
            continue
        for call, r in zip(calls, mine):
            images = int(CORE.match(r[2]).group(1))
            bound += counts_swin.attention_bound_ms(call, images, ctx.peaks)
            device += tl.kernel_ms(r)
    return 100.0 * bound / device if device > 0 else None
